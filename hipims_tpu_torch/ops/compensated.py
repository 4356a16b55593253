"""Compensated single-precision accumulation for the free-surface level.

The prognostic ``z`` carries a compensation plane ``comp`` holding the
rounding residue of its running sum (Neumaier/Kahan), so ``z + comp``
tracks the true surface to ~ulp(increment) in float32 runs:

    y     = delta + comp          # increment + residue: both tiny, exact
    z'    = z + y                 # one rounding, error e = y - (z' - z)
    comp' = y - (z' - z)          # Fast2Sum residue (|z| >= |y| here)

PyTorch does not reassociate these eager operations; the CUDA copy in
``csrc/swe_common.cuh`` is built with ``--fmad=false`` for the same reason.
"""

from __future__ import annotations


def comp_add(z, comp, delta):
    """Neumaier-compensated ``z += delta`` -> (z_new, comp_new)."""
    y = delta + comp
    z_new = z + y
    return z_new, y - (z_new - z)
