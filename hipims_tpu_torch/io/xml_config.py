"""HiPIMS XML configuration loader, single domain.

Parses the reference's configuration schema (reference:
src/Datasets/CXMLDataset.cpp:115-239; scheme parameters
src/Schemes/CSchemeGodunov.cpp:113-338; boundary attributes
CBoundaryUniform.cpp:59-62) the same way as hipims_tpu/io/xml_config.py,
so one model file runs in both packages.  ``<domainEdge>`` is honoured.

Not ported yet (each raises ValueError naming ROADMAP.md, queue 1):
multi-domain stitching, gridded timeseries boundaries and gauge
time-series targets.
"""

from __future__ import annotations

import csv
import dataclasses
import logging
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import List

import numpy as np

from ..domain import Domain
from ..models import get_scheme
from ..ops import boundaries as B
from ..runtime.output import RasterOutputWriter
from ..runtime.simulation import Simulation, SimulationConfig
from .csv_series import read_timeseries_csv, series_interval, series_length
from .raster import read_raster

log = logging.getLogger("hipims_tpu_torch.config")

_KNOWN_SIM_PARAMS = {"duration", "outputfrequency", "floatingpointprecision",
                     "realstart", "iomode"}
_KNOWN_SCHEME_PARAMS = {"courantnumber", "drythreshold", "timestepmode",
                        "timestepinitial", "timestepfixed",
                        "frictioneffects", "queuesize", "queuemode"}
# OpenCL tuning knobs of the reference with no meaning here.
_OBSOLETE_SCHEME_PARAMS = {"riemannsolver", "groupsize", "cachedgroupsize",
                           "noncachedgroupsize", "localcachelevel",
                           "localcacheconstraints",
                           "timestepreductionwavefronts",
                           "contiguousextrapolationdata",
                           "timestepreductiondivisions"}
_KNOWN_SOURCE_VALUES = {"structure", "dem", "depth", "fsl", "velocityx",
                        "velocityy", "dischargex", "dischargey",
                        "manningcoefficient", "disabled"}
_NOT_PORTED = "is not ported to hipims_tpu_torch yet (ROADMAP.md, queue 1)"
# Cell-boundary depthValue / dischargeValue attributes; an unknown value
# reads as "fsl" / "total", as in the JAX loader.
_DEPTH_MODES = {"fsl": B.DEPTH_IS_FSL, "depth": B.DEPTH_IS_DEPTH,
                "ignore": B.DEPTH_IGNORE, "disabled": B.DEPTH_IGNORE,
                "critical": B.DEPTH_IS_CRITICAL}
_DISCHARGE_MODES = {"total": B.DISCHARGE_IS_DISCHARGE,
                    "cell": B.DISCHARGE_IS_DISCHARGE,
                    "velocity": B.DISCHARGE_IS_VELOCITY,
                    "ignore": B.DISCHARGE_IGNORE,
                    "disabled": B.DISCHARGE_IGNORE,
                    "volume": B.DISCHARGE_IS_VOLUME,
                    "surging": B.DISCHARGE_IS_VOLUME}


@dataclasses.dataclass
class LoadedModel:
    name: str
    description: str
    domain: Domain
    config: SimulationConfig
    boundaries: list
    output_targets: list
    target_dir: str

    def simulation(self, *, device) -> Simulation:
        writer = None
        if self.output_targets:
            writer = RasterOutputWriter(self.output_targets, self.target_dir,
                                        self.domain)
        return Simulation(self.domain, self.config,
                          boundaries=self.boundaries, output_writer=writer,
                          device=device)


def _params_of(el) -> dict:
    out = {}
    for p in el.findall("parameter"):
        out[p.get("name", "").strip().lower()] = p.get("value", "").strip()
    return out


def _precision(sim_params, path) -> str:
    precision = sim_params.get("floatingpointprecision", "double").lower()
    if precision in ("double-strict", "float64-strict"):
        return "float64"
    if precision in ("double", "float64"):
        # Same mapping as the JAX package, so outputs compare with its CLI:
        # "double" runs as compensated f32 unless forced.
        log.warning("%s: floatingPointPrecision=double runs as "
                    "compensated-f32; use --precision double or "
                    "value='double-strict' to force true float64",
                    path.name)
        return "float32c"
    if precision in ("compensated", "float32c", "single-compensated"):
        return "float32c"
    return "float32"


def _apply_scheme(cfg, scheme_el, path):
    cfg.scheme = scheme_el.get("name", "godunov").strip().lower()
    if cfg.scheme == "musclhancock":
        cfg.scheme = "muscl-hancock"
    sp = _params_of(scheme_el)
    cfg.courant = float(sp.get("courantnumber", cfg.courant))
    if "drythreshold" in sp:
        cfg.dry_threshold = float(sp["drythreshold"])
    mode = sp.get("timestepmode", "cfl").lower()
    cfg.timestep_mode = "fixed" if mode == "fixed" else "cfl"
    if "timestepinitial" in sp:
        cfg.initial_timestep = float(sp["timestepinitial"])
    if "timestepfixed" in sp:
        cfg.fixed_timestep = float(sp["timestepfixed"])
        cfg.timestep_mode = "fixed"
    fric = sp.get("frictioneffects", "yes").lower()
    cfg.friction = fric not in ("no", "off", "false", "0")
    if "queuesize" in sp:
        cfg.batch_size = max(1, int(float(sp["queuesize"])))
        cfg.batch_auto = False
    if sp.get("queuemode", "").lower() == "fixed":
        cfg.batch_auto = False
    for pname in sp:
        if pname in _OBSOLETE_SCHEME_PARAMS:
            log.info("%s: scheme parameter '%s' is an OpenCL tuning knob; "
                     "ignored", path.name, pname)
        elif pname not in _KNOWN_SCHEME_PARAMS:
            log.warning("%s: ignoring unknown <scheme> parameter '%s'",
                        path.name, pname)


def load_config(path) -> LoadedModel:
    path = Path(path)
    base = path.parent
    root = ET.parse(path).getroot()

    meta = root.find("metadata")
    name = meta.findtext("name", "") if meta is not None else ""
    desc = meta.findtext("description", "") if meta is not None else ""

    sim_el = root.find("simulation")
    if sim_el is None:
        raise ValueError(f"{path}: missing <simulation>")
    sim_params = _params_of(sim_el)

    cfg = SimulationConfig()
    cfg.duration = float(sim_params.get("duration", 3600.0))
    cfg.output_frequency = float(sim_params.get("outputfrequency",
                                                cfg.duration))
    cfg.dtype = _precision(sim_params, path)
    io_mode = sim_params.get("iomode", "").lower()
    if io_mode in ("gather", "stream", "auto"):
        cfg.io_mode = io_mode
    elif io_mode:
        log.warning("%s: unknown ioMode '%s' (expected gather/stream/"
                    "auto); using auto", path.name, io_mode)
    for p in sim_params:
        if p not in _KNOWN_SIM_PARAMS:
            log.warning("%s: ignoring unknown <simulation> parameter '%s'",
                        path.name, p)

    domain_set = sim_el.find("domainSet")
    dom_els = domain_set.findall("domain") if domain_set is not None else []
    if not dom_els:
        raise ValueError(f"{path}: missing <domain>")
    if len(dom_els) > 1:
        raise ValueError(f"{path}: {len(dom_els)} <domain>s: multi-domain "
                         f"stitching {_NOT_PORTED}")
    blk = _parse_domain_block(dom_els[0], base, path)
    if blk.structure is None:
        raise ValueError(f"{path}: the <domain> needs a structure/dem "
                         "raster source")
    if blk.scheme_el is not None:
        _apply_scheme(cfg, blk.scheme_el, path)

    grid = _Grid(blk.structure)
    zb = grid.empty(grid.nodata)
    grid.paste(zb, blk.structure, path)
    active = ~np.isclose(zb, grid.nodata)

    def gather(v, fill):
        """Constant / raster / None for one data-source value."""
        const = blk.constants.get(v)
        if v not in blk.rasters:
            return const
        out = grid.empty(const if const is not None else fill)
        grid.paste(out, blk.rasters[v], path, mask_nodata=True)
        return out

    manning = gather("manningcoefficient", 0.0)
    domain = Domain(zb=zb, manning=manning if manning is not None else 0.0,
                    dx=grid.cell, dy=grid.cell, xll=grid.xll, yll=grid.yll,
                    active=active)
    disabled = gather("disabled", 0.0)
    if disabled is not None:
        domain.active &= ~(np.broadcast_to(np.asarray(disabled),
                                           zb.shape) != 0.0)
    depth0_arr = gather("depth", 0.0)
    if depth0_arr is not None:
        domain.set_initial_depth(depth0_arr)
    fsl_arr = gather("fsl", np.nan)
    if fsl_arr is not None:
        domain.set_initial_fsl(fsl_arr if np.isscalar(fsl_arr)
                               else np.where(np.isnan(fsl_arr), zb, fsl_arr))

    # Initial velocity -> discharge (reference: CDomain handleInputData).
    depth0 = None
    if domain._depth is not None:
        depth0 = np.asarray(domain._depth)
    elif domain._fsl is not None:
        depth0 = np.maximum(np.asarray(domain._fsl) - zb, 0.0)
    for comp, setter in (("x", "qx"), ("y", "qy")):
        vel = gather(f"velocity{comp}", 0.0)
        if vel is not None and depth0 is not None:
            q = np.broadcast_to(np.asarray(vel), zb.shape) * depth0
            domain.set_initial_discharge(**{setter: q})
        dis = gather(f"discharge{comp}", 0.0)
        if dis is not None:
            domain.set_initial_discharge(
                **{setter: np.broadcast_to(np.asarray(dis), zb.shape)})

    bounds: List = []
    if blk.bc_el is not None:
        bc_dir = base / blk.bc_el.get("sourceDir", "")
        shared_map = blk.bc_el.get("mapFile")
        for edge_el in blk.bc_el.findall("domainEdge"):
            edge = edge_el.get("edge", "").strip().lower()
            if edge in domain.edge_treatment:
                domain.edge_treatment[edge] = edge_el.get(
                    "treatment", "closed").strip().lower()
        for ts in blk.bc_el.findall("timeseries"):
            bounds.append(_parse_timeseries(ts, bc_dir, shared_map, domain))

    # Cell-boundary cells inside the scheme's static ring are never forced
    # (ops/boundaries.py interior_force_mask): say so at load time.
    ring = get_scheme(cfg.scheme).radius
    for b in bounds:
        if isinstance(b, B.CellBoundary):
            r, c = np.asarray(b.rows), np.asarray(b.cols)
            bad = ((r < ring) | (r >= domain.rows - ring)
                   | (c < ring) | (c >= domain.cols - ring))
            if bad.any():
                log.warning("%s: %d cell-boundary cell(s) fall inside "
                            "the %d-cell static edge ring and will "
                            "receive no forcing; move them inward",
                            path.name, int(bad.sum()), ring)

    return LoadedModel(name=name, description=desc, domain=domain,
                       config=cfg, boundaries=bounds,
                       output_targets=blk.targets,
                       target_dir=str(blk.target_dir))


def _parse_domain_block(el, base: Path, path):
    """The <domain> element's data/scheme/boundary sections."""
    from types import SimpleNamespace

    data_el = el.find("data")
    source_dir = base / (data_el.get("sourceDir", "") if data_el is not None
                         else "")
    target_dir = base / (data_el.get("targetDir", "output")
                         if data_el is not None else "output")
    structure = None
    constants, rasters, targets = {}, {}, []
    if data_el is not None:
        for src in data_el.findall("dataSource"):
            values = [v.strip().lower()
                      for v in src.get("value", "").split(",")]
            kind = src.get("type", "raster").strip().lower()
            sval = src.get("source", "")
            for v in values:
                if v not in _KNOWN_SOURCE_VALUES:
                    log.warning("%s: ignoring dataSource value '%s' "
                                "(unsupported)", Path(path).name, v)
                    continue
                if kind == "constant":
                    constants[v] = float(sval)
                else:
                    rast = read_raster(source_dir / sval)
                    rasters[v] = rast
                    if v in ("structure", "dem"):
                        structure = rast
        for tgt in data_el.findall("dataTarget"):
            kind = tgt.get("type", "raster").strip().lower()
            if kind != "raster":
                raise ValueError(f"{Path(path).name}: <dataTarget "
                                 f"type='{kind}'> {_NOT_PORTED}")
            targets.append(dict(
                kind=kind,
                value=tgt.get("value", "depth").strip().lower(),
                format=tgt.get("format", "GTiff").strip().lower(),
                target=tgt.get("target", "out_%t.tif")))

    return SimpleNamespace(target_dir=target_dir, structure=structure,
                           constants=constants, rasters=rasters,
                           targets=targets, scheme_el=el.find("scheme"),
                           bc_el=el.find("boundaryConditions"))


def _parse_timeseries(ts, bc_dir: Path, shared_map, domain: Domain):
    kind = (ts.get("type") or "").strip().lower()
    value = (ts.get("value") or "").strip().lower()
    source = ts.get("source") or ""
    name = ts.get("name") or source
    if kind in ("atmospheric", "uniform"):
        series = read_timeseries_csv(bc_dir / source, n_cols=2)
        return B.UniformBoundary(
            values=series[:, 1],
            interval=series_interval(series),
            length=series_length(series),
            is_loss=(value in ("loss-rate", "loss")))
    if kind in ("cell", "flow", "flowconditions"):
        series = read_timeseries_csv(bc_dir / source, n_cols=4)
        map_file = ts.get("mapFile") or shared_map
        if map_file is None:
            raise ValueError(f"cell boundary '{name}' needs a map file")
        rows, cols = _world_to_cells(_read_cell_map(bc_dir / map_file, name),
                                     domain)
        depth_val = (ts.get("depthValue") or "fsl").strip().lower()
        dis_val = (ts.get("dischargeValue") or "total").strip().lower()
        series = series.copy()
        if dis_val == "total" and rows:
            # Host-side division, reference CBoundaryCell.cpp:345-355.
            series[:, 2] /= len(rows)
            series[:, 3] /= len(rows)
        return B.CellBoundary(
            rows=np.asarray(rows, np.int32), cols=np.asarray(cols, np.int32),
            series=series, interval=series_interval(series),
            length=series_length(series),
            depth_mode=_DEPTH_MODES.get(depth_val, B.DEPTH_IS_FSL),
            discharge_mode=_DISCHARGE_MODES.get(dis_val,
                                                B.DISCHARGE_IS_DISCHARGE))
    if kind in ("gridded", "spatially-varying"):
        raise ValueError(f"gridded timeseries boundary '{name}' "
                         f"(GriddedBoundary) {_NOT_PORTED}")
    raise ValueError(f"unknown timeseries type '{kind}'")


def _read_cell_map(path: Path, name: str):
    """(x, y[, name]) world-coordinate rows for one named boundary
    (reference: CBoundaryCell::importMap, CBoundaryCell.cpp:232-296)."""
    cells = []
    with open(path, newline="") as f:
        for rec in csv.reader(f):
            rec = [c.strip() for c in rec if c.strip() != ""]
            if len(rec) < 2:
                continue
            try:
                x, y = float(rec[0]), float(rec[1])
            except ValueError:
                continue
            if len(rec) >= 3 and rec[2] != name:
                continue
            cells.append((x, y))
    return cells


def _world_to_cells(cells, domain: Domain):
    """Grid (row, col) of each world point; points off the grid are
    dropped."""
    rows, cols = [], []
    for x, y in cells:
        ci = int((x - domain.xll) / domain.dx)
        ri = int((y - domain.yll) / domain.dy)
        if 0 <= ri < domain.rows and 0 <= ci < domain.cols:
            rows.append(ri)
            cols.append(ci)
    return rows, cols


class _Grid:
    """The structure raster's extent; other rasters of the same shape are
    applied wholesale, smaller ones placed by their world offset (as the
    JAX loader's union grid does for one domain)."""

    def __init__(self, structure):
        self.cell = structure.cell_size
        self.xll, self.yll = structure.xll, structure.yll
        self.rows, self.cols = structure.rows, structure.cols
        nod = structure.nodata
        self.nodata = nod if nod is not None else -9999.0

    def empty(self, fill):
        return np.full((self.rows, self.cols), float(fill))

    def paste(self, dst, raster, path, mask_nodata=False):
        arr = raster.to_domain_array()
        if arr.shape == dst.shape:
            sel = slice(None), slice(None)
        else:
            c0 = int(round((raster.xll - self.xll) / self.cell))
            r0 = int(round((raster.yll - self.yll) / self.cell))
            if (c0 < 0 or r0 < 0 or r0 + raster.rows > self.rows
                    or c0 + raster.cols > self.cols):
                raise ValueError(f"{Path(path).name}: raster extent falls "
                                 "outside the domain")
            sel = (slice(r0, r0 + raster.rows), slice(c0, c0 + raster.cols))
        if mask_nodata and raster.nodata is not None:
            keep = ~np.isclose(arr, raster.nodata)
            dst[sel] = np.where(keep, arr, dst[sel])
        else:
            dst[sel] = arr
