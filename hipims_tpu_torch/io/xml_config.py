"""HiPIMS XML configuration loader.

Parses the reference's configuration schema (reference:
src/Datasets/CXMLDataset.cpp:115-239; scheme parameters
src/Schemes/CSchemeGodunov.cpp:113-338; boundary attributes
CBoundaryUniform.cpp:59-62) the same way as hipims_tpu/io/xml_config.py,
so one model file runs in both packages: several ``<domain>``s (a
decomposed model) are stitched into their union grid, ``<timeseries
type="gridded">`` rain is read frame by frame from a strftime mask, and
``<dataTarget type="timeseries">`` gauges sample a field at points.
``<domainEdge>`` is honoured.  The reference's ``<execution>`` section
is not read: the device comes from the caller.
"""

from __future__ import annotations

import csv
import dataclasses
import datetime
import logging
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import List

import numpy as np

from ..domain import Domain
from ..models import get_scheme
from ..ops import boundaries as B
from ..runtime.output import (CompositeOutputWriter, GaugeOutputWriter,
                              RasterOutputWriter, read_gauge_map)
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

    def simulation(self, *, device=None, mesh=None) -> Simulation:
        """The model's Simulation on ``device``, or on the blocks of
        ``mesh`` (a ``parallel.Mesh``), with its output writers."""
        return Simulation(self.domain, self.config,
                          boundaries=self.boundaries,
                          output_writer=self.output_writer(),
                          device=device, mesh=mesh)

    def output_writer(self):
        """The writer of the model's <dataTarget>s (None without any):
        its rasters, then its gauge series."""
        writers = []
        rasters = [t for t in self.output_targets
                   if t.get("kind", "raster") == "raster"]
        if rasters:
            writers.append(RasterOutputWriter(rasters, self.target_dir,
                                              self.domain))
        for t in self.output_targets:
            if t.get("kind") == "timeseries":
                writers.append(GaugeOutputWriter(
                    t["value"], read_gauge_map(t["source"]),
                    Path(self.target_dir) / t["target"], self.domain))
        if not writers:
            return None
        return (writers[0] if len(writers) == 1
                else CompositeOutputWriter(writers))


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
    # Real-world start time: the strftime masks of gridded boundaries are
    # evaluated at realStart + t (reference: src/CModel.cpp:90-92).
    real_start = None
    for pel in sim_el.findall("parameter"):
        if pel.get("name", "").strip().lower() == "realstart":
            real_start = datetime.datetime.strptime(
                pel.get("value"), pel.get("format", "%Y-%m-%d %H:%M:%S"))
    for p in sim_params:
        if p not in _KNOWN_SIM_PARAMS:
            log.warning("%s: ignoring unknown <simulation> parameter '%s'",
                        path.name, p)

    domain_set = sim_el.find("domainSet")
    dom_els = domain_set.findall("domain") if domain_set is not None else []
    if not dom_els:
        raise ValueError(f"{path}: missing <domain>")
    # The reference's decomposition splits one logical grid into
    # overlapping per-device rasters (tools/model-builder --decompose;
    # src/Domain/CDomainManager.cpp:170-241).  Here every <domain> is
    # stitched back into the union extent, with every domain's data
    # sources, boundaries and targets merged.  <domainSet syncMethod> and
    # syncSpareSize are read as the JAX package reads them; a mesh run
    # acts on them (runtime/simulation.py), one device does not.
    sync_method = (domain_set.get("syncMethod", "forecast")
                   if domain_set is not None else "timestep").strip().lower()
    cfg.sync_method = ("forecast" if sync_method.startswith("forecast")
                       else "timestep")
    sync_spare = (int(float(domain_set.get("syncSpareSize", 0)))
                  if domain_set is not None else 0)

    blocks = [_parse_domain_block(el, base, path) for el in dom_els]
    if any(b.structure is None for b in blocks):
        raise ValueError(f"{path}: every <domain> needs a structure/dem "
                         "raster source")

    # Output targets: the union across domains, without repeats
    # (decomposed configs repeat the same target list per domain).
    targets, seen_t = [], set()
    for blk in blocks:
        for t in blk.targets:
            key = (t.get("kind"), t["value"], t["target"])
            if key not in seen_t:
                seen_t.add(key)
                targets.append(t)

    # Domain 0's scheme governs; a different one elsewhere is warned.
    scheme_el = blocks[0].scheme_el
    if scheme_el is not None:
        _apply_scheme(cfg, scheme_el, path)
    for blk in blocks[1:]:
        if blk.scheme_el is not None and scheme_el is not None:
            other = blk.scheme_el.get("name", "").strip().lower()
            if other and other != scheme_el.get("name", "").strip().lower():
                log.warning("%s: per-domain scheme '%s' differs from "
                            "domain 0's '%s'; domain 0 governs the "
                            "stitched grid", path.name, other,
                            scheme_el.get("name"))

    union = _UnionGrid([b.structure for b in blocks])
    zb = union.empty(union.nodata)
    for blk in blocks:
        union.paste(zb, blk.structure, path)
    active = ~np.isclose(zb, union.nodata)
    constants = _merge_constants(blocks, path)

    def gather(v, fill):
        """Constant / stitched raster / None for one data-source value."""
        rs = [blk.rasters[v] for blk in blocks if v in blk.rasters]
        const = constants.get(v)
        if not rs:
            return const
        out = union.empty(const if const is not None else fill)
        for r in rs:
            union.paste(out, r, path, mask_nodata=True)
        return out

    manning = gather("manningcoefficient", 0.0)
    domain = Domain(zb=zb, manning=manning if manning is not None else 0.0,
                    dx=union.cell, dy=union.cell, xll=union.xll,
                    yll=union.yll, active=active)
    disabled = gather("disabled", 0.0)
    if disabled is not None:
        domain.active &= ~(np.broadcast_to(np.asarray(disabled),
                                           zb.shape) != 0.0)
    depth0_arr = gather("depth", 0.0)
    if depth0_arr is not None:
        domain.set_initial_depth(depth0_arr)
    fsl_arr = gather("fsl", np.nan)
    if fsl_arr is not None:
        # Cells no domain's raster covered fall back to a dry bed.
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

    # The forecast window from the decompose overlap, as the JAX package
    # derives it (the reference's rollback limit: sync-zone rows =
    # floor(overlap/2) - 1, CDomainLink.cpp:286-382, minus syncSpareSize,
    # CDomainManager.cpp:36-40).  Only a mesh uses it.
    ring = get_scheme(cfg.scheme).radius
    if len(blocks) > 1 and cfg.sync_method == "forecast":
        min_overlap = union.min_overlap([b.structure for b in blocks])
        if min_overlap is not None:
            budget = max(1, (min_overlap // 2 - 1) // ring)
            cfg.forecast_window = max(1, budget - sync_spare)
            log.info("%s: decompose overlap %d rows -> forecast window "
                     "%d steps (spare %d)", path.name, min_overlap,
                     cfg.forecast_window, sync_spare)

    # Boundaries, merged across domains: decomposed configs repeat the
    # same boundary blocks on every domain, and each applies once.
    bounds: List = []
    seen_bc = set()
    explicit_edges = {}
    for blk in blocks:
        bc_el = blk.bc_el
        if bc_el is None:
            continue
        bc_dir = base / bc_el.get("sourceDir", "")
        shared_map = bc_el.get("mapFile")
        for edge_el in bc_el.findall("domainEdge"):
            edge = edge_el.get("edge", "").strip().lower()
            treatment = edge_el.get("treatment", "closed").strip().lower()
            if edge not in domain.edge_treatment:
                continue
            if edge in explicit_edges and explicit_edges[edge] != treatment:
                log.warning("%s: conflicting <domainEdge> treatments for "
                            "'%s' across domains; keeping '%s'",
                            path.name, edge, explicit_edges[edge])
                continue
            explicit_edges[edge] = treatment
            domain.edge_treatment[edge] = treatment
        for ts in bc_el.findall("timeseries"):
            sig = (str(bc_dir), shared_map,
                   tuple(sorted(ts.attrib.items())))
            if sig in seen_bc:
                continue
            seen_bc.add(sig)
            bounds.append(_parse_timeseries(ts, bc_dir, shared_map, domain,
                                            cfg.duration, real_start))

    # Cell-boundary cells inside the scheme's static ring are never forced
    # (ops/boundaries.py interior_force_mask): say so at load time.
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
                       output_targets=targets,
                       target_dir=str(blocks[0].target_dir))


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
            entry = dict(
                kind=kind,
                value=tgt.get("value", "depth").strip().lower(),
                format=tgt.get("format", "GTiff").strip().lower(),
                target=tgt.get("target", "out_%t.tif"))
            if kind == "timeseries":
                # Point gauges: source is a gauge map CSV of
                # (x, y[, name]) world coordinates.
                entry["source"] = str(base / tgt.get("source", ""))
            targets.append(entry)

    return SimpleNamespace(target_dir=target_dir, structure=structure,
                           constants=constants, rasters=rasters,
                           targets=targets, scheme_el=el.find("scheme"),
                           bc_el=el.find("boundaryConditions"))


def _parse_timeseries(ts, bc_dir: Path, shared_map, domain: Domain,
                      duration: float = 0.0, real_start=None):
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
        return _parse_gridded(ts, bc_dir, domain, duration, real_start)
    raise ValueError(f"unknown timeseries type '{kind}'")


def _parse_gridded(ts, bc_dir: Path, domain: Domain, duration: float,
                   real_start):
    """Time-stamped raster series: file names from a strftime mask
    evaluated at realStart + t, every ``interval`` seconds (reference:
    src/Boundaries/CBoundaryGridded.cpp:116-153 + Util::fromTimestamp).

    The series stops at the first missing file, with a warning when that
    falls inside the run: every loaded frame keeps its true time offset,
    and the truncated length gates the boundary off past the last frame
    (the reference loads past gaps and clamps to an out-of-bounds frame
    at the end, src/Boundaries/CLBoundaries.clc:229-230)."""
    value = (ts.get("value") or "rain-intensity").strip().lower()
    mask = ts.get("mask") or ts.get("source")
    interval = float(ts.get("interval", "3600"))
    if real_start is None:
        real_start = datetime.datetime(1970, 1, 1)

    frames, first = [], None
    t = 0.0
    while t <= duration:
        name = (real_start + datetime.timedelta(seconds=t)).strftime(mask)
        path = bc_dir / name
        if not path.exists():
            if t < duration:
                log.warning("gridded frame '%s' missing; series truncated "
                            "at t=%.0f s (the boundary applies nothing "
                            "beyond that)", name, t)
            break
        rast = read_raster(path)
        if first is None:
            first = rast
        frames.append(rast.data[::-1, :])   # domain orientation (south-up)
        t += interval
    if first is None:
        raise ValueError(f"no gridded boundary rasters found for '{mask}'")

    return B.GriddedBoundary(
        series=np.stack(frames), interval=interval,
        resolution=first.cell_size,
        offset_x=first.xll - domain.xll, offset_y=first.yll - domain.yll,
        mass_flux=(value == "mass-flux"), length=len(frames) * interval)


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


def _merge_constants(blocks, path) -> dict:
    """The union of every domain's constant sources; a conflict keeps
    domain 0's value with a warning."""
    out = {}
    for blk in blocks:
        for v, val in blk.constants.items():
            if v in out and out[v] != val:
                log.warning("%s: conflicting constant '%s' across domains "
                            "(%g vs %g); keeping the first",
                            Path(path).name, v, out[v], val)
                continue
            out.setdefault(v, val)
    return out


class _UnionGrid:
    """The union extent of the domains' structure rasters; later domains
    overwrite the overlap rows, as the reference's decomposed configs tile
    one logical model (src/Domain/CDomainManager.cpp:170-241,
    CDomainLink.cpp:286-382).  One domain is its own union."""

    def __init__(self, rasters):
        cell = rasters[0].cell_size
        for r in rasters:
            if abs(r.cell_size - cell) > 1e-9:
                raise ValueError(
                    "multi-domain stitch requires equal resolution")
        self.cell = cell
        self.xll = min(r.xll for r in rasters)
        self.yll = min(r.yll for r in rasters)
        x_hi = max(r.xll + r.cols * cell for r in rasters)
        y_hi = max(r.yll + r.rows * cell for r in rasters)
        self.cols = int(round((x_hi - self.xll) / cell))
        self.rows = int(round((y_hi - self.yll) / cell))
        nod = rasters[0].nodata
        self.nodata = nod if nod is not None else -9999.0

    def empty(self, fill):
        return np.full((self.rows, self.cols), float(fill))

    def paste(self, dst, raster, path, mask_nodata=False):
        """Overlay one raster's domain-oriented array onto the union: one
        of the union's shape wholesale (legacy configs georeference IC
        rasters loosely), a smaller one by its world offset."""
        arr = raster.to_domain_array()
        if arr.shape == dst.shape:
            sel = slice(None), slice(None)
        else:
            c0 = int(round((raster.xll - self.xll) / self.cell))
            r0 = int(round((raster.yll - self.yll) / self.cell))
            if (c0 < 0 or r0 < 0 or r0 + raster.rows > self.rows
                    or c0 + raster.cols > self.cols):
                raise ValueError(f"{Path(path).name}: raster extent falls "
                                 "outside the stitched domain union")
            sel = (slice(r0, r0 + raster.rows), slice(c0, c0 + raster.cols))
        if mask_nodata and raster.nodata is not None:
            keep = ~np.isclose(arr, raster.nodata)
            dst[sel] = np.where(keep, arr, dst[sel])
        else:
            dst[sel] = arr

    def min_overlap(self, rasters):
        """The smallest positive row/col overlap between any two domain
        rasters (the decompose overlap), or None when none overlap."""
        best = None
        for i, a in enumerate(rasters):
            for b in rasters[i + 1:]:
                ox = (min(a.xll + a.cols * self.cell,
                          b.xll + b.cols * self.cell)
                      - max(a.xll, b.xll)) / self.cell
                oy = (min(a.yll + a.rows * self.cell,
                          b.yll + b.rows * self.cell)
                      - max(a.yll, b.yll)) / self.cell
                if ox <= 0 or oy <= 0:
                    continue
                # Row bands overlap across the full width: the smaller
                # dimension is the binding halo budget.
                o = int(round(min(ox, oy)))
                best = o if best is None else min(best, o)
        return best
