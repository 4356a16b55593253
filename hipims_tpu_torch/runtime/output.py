"""Raster output writing with derived fields and %t filename substitution.

Mirrors CRasterDataset::domainToRaster (reference:
src/Datasets/CRasterDataset.cpp:101-290): depth/maxdepth clamp + 1e-8
nodata floor, velocity = Q/h (nodata when dry), Froude = |v|/sqrt(gh),
discharge scaled by cell resolution, FSL/maxFSL masked on dry or walled
cells, -9999 nodata, bottom-up row order.

Only the gathered path is ported: every output event copies the state to
the host once.  Streamed (bounded-memory) writers and gauge time series are
listed in ROADMAP.md (queue 1).
"""

from __future__ import annotations

import numpy as np

from .. import constants as C
from ..io.raster import Raster, write_raster
from ..utils import time_label

NODATA = -9999.0
_EPS = 1e-8

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
