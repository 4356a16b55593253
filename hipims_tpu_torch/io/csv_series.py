"""CSV timeseries reading (boundary inputs).

Replaces CCSVDataset + the per-boundary import routines (reference:
src/Datasets/CCSVDataset.cpp; src/Boundaries/CBoundaryCell.cpp:153-225
importTimeseries; CBoundaryUniform.cpp).  First row is treated as a header
when non-numeric.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np


def read_timeseries_csv(path, n_cols=None):
    """Read a CSV of numeric columns, skipping a header row.

    Returns an (N, k) float64 array.  ``n_cols`` pads/validates the column
    count (cell-boundary files have 4: t, depth/level, qx, qy; atmospheric
    files have 2: t, rate).
    """
    rows = []
    with open(Path(path), newline="") as f:
        for rec in csv.reader(f):
            rec = [c.strip() for c in rec if c.strip() != ""]
            if not rec:
                continue
            try:
                vals = [float(c) for c in rec]
            except ValueError:
                continue  # header or comment line
            rows.append(vals)
    if not rows:
        raise ValueError(f"{path}: no numeric rows")
    width = n_cols or max(len(r) for r in rows)
    out = np.zeros((len(rows), width))
    for i, r in enumerate(rows):
        out[i, :min(len(r), width)] = r[:width]
    return out


def series_interval(series) -> float:
    """Uniform sampling interval (reference: first difference,
    CBoundaryCell.cpp:216)."""
    if len(series) < 2:
        return 1.0
    return float(series[1, 0] - series[0, 0])


def series_length(series) -> float:
    """Total covered time = last timestamp (reference: CBoundaryCell.cpp:218)."""
    return float(series[-1, 0])
