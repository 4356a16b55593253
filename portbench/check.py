"""The comparison that decides ``correct``: what the timed path produced
in its last segment against the float64 reference run of the same model
directory.

The program's side is read from what it produced: the simulated time its
clock reached, its state at the segment's end (depth = z - zb), and the
depth and maxdepth rasters its output layer wrote at the traffic's output
times, read back from the files.  The reference's side is derived from
its float64 state as the output layer defines the fields (a depth below
1e-8 m is no data; maxdepth no data on walls).  Every number is computed;
the cell's limits file (``cells/<workload>.json``) names the ones
compared and their limits, and the rest are printed for the record.
"""

from __future__ import annotations

import numpy as np

from . import geotiff

EPS = 1e-8          # the output layer's no-data floor for depths
EXTENT_M = 0.01     # a cell counts as flooded from 1 cm of water
BLOCK = 8           # cells a side of the blocks whose means are compared


def _depth(z, zb):
    h = np.maximum(z - zb, 0.0)
    h[h < EPS] = 0.0
    return h


def _maxdepth(zmax, zb):
    m = np.maximum(zmax - zb, 0.0)
    m[(m < EPS) | (zmax <= -9990.0) | (zb >= 9999.0)] = 0.0
    return m


def raster(path):
    """A raster the output layer wrote, read back, no data as 0, in
    domain orientation."""
    data, _, nodata = geotiff.read(path)
    data = data[::-1]
    if nodata is not None:
        data = np.where(data == nodata, 0.0, data)
    return data


def field(kind, state):
    """The output layer's ``kind`` ("depth" or "maxdepth") of a float64
    state (z, zmax, qx, qy, zb), as the raster would hold it."""
    z, zmax, _, _, zb = state
    return _depth(z, zb) if kind == "depth" else _maxdepth(zmax, zb)


def _blocks(a):
    """Means over BLOCK x BLOCK blocks (the ragged edge left out)."""
    r, c = (a.shape[0] // BLOCK) * BLOCK, (a.shape[1] // BLOCK) * BLOCK
    return a[:r, :c].reshape(r // BLOCK, BLOCK, c // BLOCK,
                             BLOCK).mean(axis=(1, 3))


def _gaps(prefix, got, want, cell_area):
    """Per-cell gaps of a depth field over the cells wet on either side,
    its volume gap, its flood extent's misfit (cells deeper than
    EXTENT_M on one side alone, over those on either) and the mean gap
    of its BLOCK x BLOCK means, which a front one cell apart moves
    little."""
    wet = (got > 0.0) | (want > 0.0)
    diff = np.abs(got - want)[wet]
    vol_ref = want.sum() * cell_area
    flooded = (got > EXTENT_M), (want > EXTENT_M)
    union = int((flooded[0] | flooded[1]).sum())
    bg, bw = _blocks(got), _blocks(want)
    bwet = (bg > 0.0) | (bw > 0.0)
    return {
        f"{prefix}_gap_mean_m": float(diff.mean()) if diff.size else 0.0,
        f"{prefix}_gap_max_m": float(diff.max()) if diff.size else 0.0,
        f"{prefix}_volume_gap": (abs(got.sum() * cell_area - vol_ref)
                                 / vol_ref if vol_ref > 0 else 0.0),
        f"{prefix}_extent_misfit": (int((flooded[0] ^ flooded[1]).sum())
                                    / union if union else 0.0),
        f"{prefix}_block_gap_mean_m": (float(np.abs(bg - bw)[bwet].mean())
                                       if bwet.any() else 0.0),
    }


def readings(program, reference, fields, traffic, cell_size, settle=None):
    """Every number of the comparison.  ``program`` and each of
    ``reference`` (keyed by sync time) are dicts of the clock ``t``, the
    hydrological interval ``t_hydro`` and the ``state`` (z, zmax, qx, qy,
    zb host arrays, domain orientation) at the segment's end; the
    reference's also its ``steps``.  ``fields(kind, t)`` is the program's
    raster of ``kind`` written at the output time ``t``.  With
    ``settle(state, t, t_hydro)``, the free surface with the forcing
    still owed added (reference/model.py ``settle``), the ``settled_depth``
    numbers compare both sides' end states settled: rain and loss that
    each side owes for the seconds since its boundaries last forced,
    which its own steps decide, no longer count as a gap."""
    seg = float(traffic["segment_s"])
    area = cell_size * cell_size
    ref_end = reference[seg]
    out = {"time_gap_s": abs(program["t"] - ref_end["t"])}
    z, zmax, _, _, zb = program["state"]
    got = _depth(z, zb)
    want = _depth(ref_end["state"][0], ref_end["state"][4])
    out.update(_gaps("state_depth", got, want, area))
    for t in traffic["output_times_s"]:
        ref = reference[float(t)]["state"]
        for kind in traffic["outputs"]:
            out.update(_gaps(f"raster_{kind}", fields(kind, float(t)),
                             field(kind, ref), area))
    if settle is not None:
        ends = [(side["state"], settle(side["state"], side["t"],
                                       side["t_hydro"]))
                for side in (program, ref_end)]
        out.update(_gaps("settled_depth",
                         *(_depth(zs, st[4]) for st, zs in ends), area))
    out["program_volume_m3"] = float(got.sum()) * area
    out["reference_volume_m3"] = float(want.sum()) * area
    out["program_t_hydro"] = program["t_hydro"]
    out["reference_t_hydro"] = ref_end["t_hydro"]
    out["reference_steps"] = ref_end["steps"]
    return out


def judge(numbers, limits):
    """(correct, compared): each compared number with its limit, in the
    limits file's order; correct when every one is within its limit (a
    NaN, or a number missing, fails)."""
    compared, ok = {}, True
    for name, limit in limits["compared"].items():
        value = float(numbers.get(name, float("nan")))
        compared[name] = {"value": value, "limit": limit}
        ok = ok and bool(value <= limit)
    return ok, compared
