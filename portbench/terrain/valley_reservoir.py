"""A valley falling 1% toward its outlet with a parabolic cross-section,
and a reservoir filled to a level above the valley floor at the dam (the
Malpasset-class terrain of tools/bench_e2e.py ``build_malpasset_class``,
a07496d), with a crossed roughness whose phases are drawn from the
seed."""

import numpy as np


def build(rows, cols, dx, params, rng):
    """(bed, initial depth) in domain orientation (row 0 south)."""
    py, px = rng.uniform(0.0, 2.0 * np.pi, size=2)
    yy, xx = np.mgrid[0:rows, 0:cols]
    cross = ((yy - rows / 2.0) / (rows / 2.0)) ** 2 * params["wall_rise_m"]
    bed = (params["floor_m"] - xx * dx * params["slope"] + cross
           + params["roughness_m"]
           * np.sin(yy / params["roughness_rows"] + py)
           * np.sin(xx / params["roughness_cols"] + px))
    dam_col = max(8, int(round(cols * params["dam_fraction"])))
    level = bed[rows // 2, dam_col] + params["reservoir_depth_m"]
    depth = np.zeros((rows, cols))
    depth[:, :dam_col] = np.maximum(0.0, level - bed[:, :dam_col])
    return bed, depth
