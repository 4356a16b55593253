"""Scheme definitions.  Names match the reference's configuration
vocabulary (reference: src/Schemes/CScheme.cpp:141-175).

All three of the reference's schemes are ported: first-order Godunov,
MUSCL-Hancock and partial-inertial.
"""

from __future__ import annotations

from typing import NamedTuple


class Scheme(NamedTuple):
    """A scheme's name (which ``Simulation._run_batch`` dispatches on) and
    the metadata the runtime needs."""

    name: str
    simplified_speed: bool    # CFL uses sqrt(gh) only (inertial)
    radius: int               # stencil radius = static-ring width


SCHEMES = {
    "godunov": Scheme("godunov", simplified_speed=False, radius=1),
    "muscl-hancock": Scheme("muscl-hancock", simplified_speed=False,
                            radius=2),
    "inertial": Scheme("inertial", simplified_speed=True, radius=1),
}


def get_scheme(name: str) -> Scheme:
    key = name.strip().lower().replace("_", "-")
    if key not in SCHEMES:
        raise ValueError(f"Unknown scheme '{name}'; expected one of "
                         f"{sorted(SCHEMES)}")
    return SCHEMES[key]
