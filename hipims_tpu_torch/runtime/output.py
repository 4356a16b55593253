"""Raster output writing with derived fields and %t filename substitution.

Mirrors CRasterDataset::domainToRaster (reference:
src/Datasets/CRasterDataset.cpp:101-290): depth/maxdepth clamp + 1e-8
nodata floor, velocity = Q/h (nodata when dry), Froude = |v|/sqrt(gh),
discharge scaled by cell resolution, FSL/maxFSL masked on dry or walled
cells, -9999 nodata, bottom-up row order.

Point gauges (GaugeOutputWriter, an extension over the reference) append
one CSV row per output event.  Only the gathered path is ported: every
output event copies the state to the host once.  Streamed (bounded-memory)
writers, and the gauge writer's device-side sampling that goes with them,
wait for the multi-device work (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import numpy as np

from .. import constants as C
from ..io.raster import Raster, write_raster
from ..utils import time_label

NODATA = -9999.0
_EPS = 1e-8

VALUE_NAMES = ("depth", "maxdepth", "fsl", "maxfsl", "velocityx",
               "velocityy", "dischargex", "dischargey", "froude", "dem",
               "manningcoefficient")

def derive_field(value: str, state, static, resolution: float,
                 datum: float = 0.0) -> np.ndarray:
    """Compute one output field (domain orientation) with nodata masking.

    ``datum`` is the vertical shift removed from device-side elevations
    (Domain.build datum_shift); absolute-elevation outputs (fsl, maxfsl,
    dem) add it back in float64 here."""
    value = value.strip().lower()
    z = np.asarray(state.z, dtype=np.float64)
    zmax = np.asarray(state.zmax, dtype=np.float64)
    qx = np.asarray(state.qx, dtype=np.float64)
    qy = np.asarray(state.qy, dtype=np.float64)
    zb = np.asarray(static.zb, dtype=np.float64)
    h = z - zb

    if value == "depth":
        out = np.maximum(0.0, h)
        out[out < _EPS] = NODATA
    elif value == "maxdepth":
        out = np.maximum(0.0, zmax - zb)
        out[(out < _EPS) | (out <= -9990.0) | (out >= 9999.0)] = NODATA
    elif value == "fsl":
        out = z + datum
        out[(z < zb + _EPS) | (zb > 9999.0)] = NODATA
    elif value == "maxfsl":
        out = zmax + datum
        out[(zmax < zb + _EPS) | (zb > 9999.0)] = NODATA
    elif value == "velocityx":
        out = np.where(h > _EPS, qx / np.where(h > _EPS, h, 1.0), NODATA)
    elif value == "velocityy":
        out = np.where(h > _EPS, qy / np.where(h > _EPS, h, 1.0), NODATA)
    elif value == "dischargex":
        out = qx * resolution
    elif value == "dischargey":
        out = qy * resolution
    elif value == "froude":
        hs = np.where(h > _EPS, h, 1.0)
        vel = np.hypot(qx / hs, qy / hs)
        out = np.where(h > _EPS, vel / np.sqrt(C.GRAVITY * hs), NODATA)
    elif value == "dem":
        out = zb + datum
        out[zb > 9999.0] = C.CLOSED_EDGE_ELEVATION
    elif value == "manningcoefficient":
        out = np.asarray(static.manning, dtype=np.float64).copy()
    else:
        raise ValueError(f"unknown output value '{value}'")
    return out


def domain_volume(view, domain) -> float:
    """Domain water volume [m^3] — the reference's per-domain volume
    sum (src/Domain/Cartesian/CDomainCartesian.cpp:743-760).

    ``view`` is a simulation or an output snapshot; the sum runs in
    float64 on the host copy."""
    z = np.asarray(view.state_logical.z, np.float64)
    zb = np.asarray(view.static_logical.zb, np.float64)
    h = np.maximum(z - zb, 0.0)
    h[np.asarray(view.state_logical.zmax) <= C.NODATA] = 0.0
    return float(h.sum() * domain.dx * domain.dy)


class GaugeOutputWriter:
    """Appends point-gauge samples of one field to a CSV at every output
    time: one row per time, one column per gauge (the same file as the
    JAX package's writer, row for row)."""

    def __init__(self, value, gauges, target_path, domain):
        """gauges: [(x_world, y_world, name)]; gauges off the grid are
        dropped."""
        import os
        self.value = value
        self.domain = domain
        self.target_path = target_path
        os.makedirs(os.path.dirname(str(target_path)) or ".", exist_ok=True)
        self.cells = []
        names = []
        for x, y, name in gauges:
            ci = int((x - domain.xll) / domain.dx)
            ri = int((y - domain.yll) / domain.dy)
            if 0 <= ri < domain.rows and 0 <= ci < domain.cols:
                self.cells.append((ri, ci))
                names.append(name)
        with open(target_path, "w") as f:
            f.write("Time (s)," + ",".join(names) + "\n")

    def __call__(self, sim, t: float):
        # Every field is derived cell by cell, so derive it on the gauge
        # cells alone.
        idx = tuple(np.asarray(self.cells, dtype=np.int64).reshape(-1, 2).T)
        state, static = (type(v)(*(np.asarray(a)[idx] for a in v))
                         for v in (sim.state_logical, sim.static_logical))
        vals = derive_field(self.value, state, static, sim.domain.dx,
                            datum=sim.domain.datum)
        # Derived fields set the sentinel exactly; a tight absolute
        # tolerance maps it to 0 without a wide isclose window around
        # real near--9999 values.
        vals = [0.0 if abs(v - NODATA) <= 1e-6 else v for v in vals]
        with open(self.target_path, "a") as f:
            f.write(f"{t:.6f}," + ",".join(f"{v:.6f}" for v in vals) + "\n")


class CompositeOutputWriter:
    """Fans one output event out to several writers (rasters + gauges)."""

    def __init__(self, writers):
        self.writers = list(writers)

    def __call__(self, sim, t: float):
        for w in self.writers:
            w(sim, t)


def read_gauge_map(path):
    """(x, y, name) rows from a gauge map CSV (the shape of the cell
    boundary map files, reference: CBoundaryCell::importMap); a row
    without a name is called G<n>."""
    import csv
    gauges = []
    with open(path, newline="") as f:
        for rec in csv.reader(f):
            rec = [c.strip() for c in rec if c.strip() != ""]
            if len(rec) < 2:
                continue
            try:
                x, y = float(rec[0]), float(rec[1])
            except ValueError:
                continue
            name = rec[2] if len(rec) >= 3 else f"G{len(gauges) + 1}"
            gauges.append((x, y, name))
    return gauges


class RasterOutputWriter:
    """Writes the configured <dataTarget> rasters at each output time."""

    def __init__(self, targets, target_dir, domain):
        """targets: list of dicts with keys value, format, target (filename
        mask with %t)."""
        import os
        self.targets = targets
        self.target_dir = target_dir
        self.domain = domain
        os.makedirs(target_dir, exist_ok=True)

    def __call__(self, sim, t: float):
        from pathlib import Path
        for tgt in self.targets:
            field = derive_field(tgt["value"], sim.state_logical,
                                 sim.static_logical, sim.domain.dx,
                                 datum=getattr(sim.domain, "datum", 0.0))
            name = tgt["target"].replace("%t", time_label(t))
            raster = Raster.from_domain_array(
                field, xll=self.domain.xll, yll=self.domain.yll,
                cell_size=self.domain.dx, nodata=NODATA)
            write_raster(Path(self.target_dir) / name, raster,
                         fmt=tgt.get("format", "tif"))
