"""Analytical validation cases with closed-form solutions.

The reference ships these as Node.js model generators
(tools/model-builder/tests/: TestSloshingBowl, TestLakeAtRest,
TestDamBreakEmergingBed, ...) whose outputs are compared manually; here
they are importable case builders with exact solutions, asserted in CI
(tests/test_validation.py, on the JAX package's copy; tests/test_torch_tools.py
holds this copy equal to it), which the reference lacked entirely
(SURVEY.md section 4).
"""

from .cases import (  # noqa: F401
    ritter_dry_dam_break,
    sloshing_bowl,
    stoker_wet_dam_break,
)
