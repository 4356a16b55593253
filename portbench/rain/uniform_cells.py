"""Radar frames whose every coarse cell rains at a rate drawn uniformly
from the boundary's ``rate_mm_h`` range, afresh for every frame (as
chip_smoke.py's radar model draws them, a07496d)."""


def build(shape, n_frames, params, rng):
    """(n_frames, grid rows, grid cols) rates in mm/h, row 0 south."""
    lo, hi = params["rate_mm_h"]
    return rng.uniform(lo, hi, (n_frames, *shape))
