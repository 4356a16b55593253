"""The plain reference run of a model directory, in float64.

It reads the same XML, GeoTIFFs, CSVs and ASC grids the program reads and
works out again what the program derives from them: the bed with its
closed-edge walls (raised to 9999.9 on a ring as wide as the scheme's
stencil, after the initial water is laid on the pristine bed), the initial
state, the forcing mask (the grid minus that ring), the rain and loss
series with their record interval and length, the gridded rain's frames
(named by their strftime mask at the real-world start plus each record's
time) and each cell's coarse cell, and the time controller's settings.
It never shifts the vertical datum: that is a single-precision device.
Then it steps the segment with ``swe.py``, as the program's host loop
does: the boundaries, the scheme step, the CFL reduction and ``advance``
at every step, a suspension at each sync time.  ``run`` steps the whole
grid on one device; ``run_blocks`` steps it in row blocks, one on each
of several devices, with the same arithmetic on every cell, so the two
give the same bits.

Nothing here imports the program under test.
"""

from __future__ import annotations

import datetime
import math
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from .. import asc, geotiff
from . import swe

RADIUS = {"godunov": 1, "muscl-hancock": 2}
VERY_SMALL = 1e-10


class Forcing(NamedTuple):
    values: torch.Tensor
    interval: float
    length: float
    is_loss: bool


class Gridded(NamedTuple):
    """Gridded rain: ``frames`` (T, grid rows, grid cols) in mm/h, row 0
    south, one every ``interval`` s from 0; ``rows`` and ``cols`` the
    coarse row of each of the domain's rows and the coarse column of each
    of its columns."""
    frames: torch.Tensor
    interval: float
    rows: torch.Tensor
    cols: torch.Tensor


class Model(NamedTuple):
    scheme: str
    dx: float
    duration: float
    courant: float
    dt0: float
    vs: float
    friction: bool
    zb: np.ndarray          # with the walls
    z0: np.ndarray
    manning: float
    forcings: list


def _params(el):
    return {p.get("name", "").strip().lower(): p.get("value", "").strip()
            for p in el.findall("parameter")}


def _series(path):
    rows = []
    for line in Path(path).read_text().splitlines():
        try:
            rows.append([float(v) for v in line.split(",")])
        except ValueError:
            continue
    return np.asarray(rows)


def _coarse(n, d, offset, res, grid):
    """The coarse index of each of ``n`` cells of size ``d`` along one
    axis: floor((x - offset) / res) at each cell's lower (left or south)
    edge x, its distance from the domain's corner, clipped to the
    ``grid`` coarse cells (ops/boundaries.py GriddedBoundary's
    documented mapping)."""
    x = np.arange(n) * float(d)
    return torch.as_tensor(np.clip(np.floor((x - offset) / res), 0,
                                   grid - 1).astype(np.int64))


def _gridded(ts, bc_dir, duration, real_start, shape, dx, corner):
    """The frames of a gridded element: one every ``interval`` s from 0
    while the time is within the run and its file exists."""
    if ts.get("value", "").strip().lower() != "rain-intensity":
        raise ValueError("the reference knows gridded rain only, not "
                         f"{ts.get('value')!r}")
    interval = float(ts.get("interval"))
    mask = ts.get("mask") or ts.get("source")
    frames, first, k = [], None, 0
    while k * interval <= duration:
        name = (real_start + datetime.timedelta(seconds=k * interval)
                ).strftime(mask)
        if not (bc_dir / name).exists():
            break
        data, res, xll, yll = asc.read(bc_dir / name)
        first = first or (res, xll, yll)
        frames.append(data[::-1])
        k += 1
    if not frames:
        raise ValueError(f"no gridded frame found for {mask!r}")
    res, xll, yll = first
    grid = np.stack(frames)
    return Gridded(frames=torch.as_tensor(grid, dtype=torch.float64),
                   interval=interval,
                   rows=_coarse(shape[0], dx, yll - corner[1], res,
                                grid.shape[1]),
                   cols=_coarse(shape[1], dx, xll - corner[0], res,
                                grid.shape[2]))


def load(xml_path) -> Model:
    """The model of ``xml_path``: one cartesian domain, raster DEM and
    optional raster depth, constant Manning n, uniform rain and loss, and
    gridded rain."""
    xml_path = Path(xml_path)
    base = xml_path.parent
    root = ET.parse(xml_path).getroot()
    sim = root.find("simulation")
    sp = _params(sim)
    real_start = datetime.datetime(1970, 1, 1)
    for p in sim.findall("parameter"):
        if p.get("name", "").strip().lower() == "realstart":
            real_start = datetime.datetime.strptime(
                p.get("value").strip(),
                p.get("format", "%Y-%m-%d %H:%M:%S"))
    dom = sim.find("domainSet").find("domain")
    data = dom.find("data")
    src_dir = base / data.get("sourceDir", "")
    rasters, manning, corner = {}, 0.0, (0.0, 0.0)
    for ds in data.findall("dataSource"):
        values = [v.strip().lower() for v in ds.get("value").split(",")]
        if ds.get("type") == "constant":
            manning = float(ds.get("source"))
        else:
            arr, cell, _ = geotiff.read(src_dir / ds.get("source"))
            for v in values:
                rasters[v] = (arr[::-1].copy(), cell)
            if "dem" in values:
                corner = geotiff.lower_left(src_dir / ds.get("source"))
    zb0, dx = rasters["dem"]
    scheme_el = dom.find("scheme")
    scheme = scheme_el.get("name").strip().lower()
    scheme = "muscl-hancock" if scheme == "musclhancock" else scheme
    cp = _params(scheme_el)
    ring = RADIUS[scheme]

    z0 = zb0 + rasters["depth"][0] if "depth" in rasters else zb0.copy()
    zb = zb0.copy()
    bc = dom.find("boundaryConditions")
    for edge_el in bc.findall("domainEdge"):
        if edge_el.get("treatment", "closed").strip().lower() != "closed":
            continue
        edge = edge_el.get("edge").strip().lower()
        sl = {"north": np.s_[-ring:, :], "south": np.s_[:ring, :],
              "east": np.s_[:, -ring:], "west": np.s_[:, :ring]}[edge]
        zb[sl] = swe.CLOSED_EDGE_ELEVATION
    forcings = []
    bc_dir = base / bc.get("sourceDir", "")
    for ts in bc.findall("timeseries"):
        if ts.get("type", "").strip().lower() == "gridded":
            forcings.append(_gridded(ts, bc_dir, float(sp["duration"]),
                                     real_start, zb.shape, dx, corner))
            continue
        s = _series(bc_dir / ts.get("source"))
        forcings.append(Forcing(
            values=torch.as_tensor(s[:, 1], dtype=torch.float64),
            interval=float(s[1, 0] - s[0, 0]) if len(s) > 1 else 1.0,
            length=float(s[-1, 0]),
            is_loss=ts.get("value").strip().lower() in ("loss-rate", "loss")))
    return Model(
        scheme=scheme, dx=float(dx), duration=float(sp["duration"]),
        courant=float(cp.get("courantnumber", 0.5)),
        dt0=float(cp.get("timestepinitial", 0.01)),
        vs=float(cp.get("drythreshold", VERY_SMALL)),
        friction=cp.get("frictioneffects", "yes").lower()
        not in ("no", "off", "false", "0"),
        zb=zb, z0=z0, manning=manning, forcings=forcings)


def _force_mask(shape, ring, device):
    """True where forcing is allowed: the grid minus its ``ring``."""
    rows, cols = shape
    yy = torch.arange(rows, device=device)[:, None]
    xx = torch.arange(cols, device=device)[None, :]
    return ((yy >= ring) & (yy < rows - ring)
            & (xx >= ring) & (xx < cols - ring))


def settle(model: Model, state, t, t_hydro):
    """The free surface ``z`` of ``state`` (z, zmax, qx, qy, zb host
    float64 arrays) with the forcing that a run stopped at time ``t``
    still owes added: what each boundary adds over the ``t_hydro``
    seconds not yet forced, on the cells it forces, at the record in
    force in the middle of those seconds (the run's next step would take
    the record of its own time, which at a sync on a record's edge is the
    next one).  Two runs that force the same, but on steps of their own,
    owe different tails at a sync; settled, they compare alike."""
    z, zmax, _, _, zb = (torch.as_tensor(a) for a in state)
    mask = _force_mask(z.shape, RADIUS[model.scheme], "cpu")
    seconds = torch.tensor(float(t_hydro))
    t = torch.tensor(float(t) - 0.5 * float(t_hydro))
    for f in model.forcings:
        if isinstance(f, Gridded):
            delta = swe.gridded_delta(f.frames, f.rows, f.cols, f.interval,
                                      t, seconds)
            on = (zmax > swe.NODATA) & (z != swe.NODATA) & mask
        else:
            delta = swe.uniform_delta(z, zb, f.values, f.interval,
                                      f.is_loss, t, seconds)
            on = (zmax > swe.NODATA) & mask & (t < f.length)
        z = z + torch.where(on, delta, 0.0)
    return z.numpy()


def _forcings_on(model: Model, device, rows=slice(None)):
    """The forcings of ``model`` on ``device``, a gridded one's row index
    cut to the domain's ``rows``."""
    return [f._replace(values=f.values.to(device))
            if isinstance(f, Forcing) else
            f._replace(frames=f.frames.to(device),
                       rows=f.rows[rows].to(device), cols=f.cols.to(device))
            for f in model.forcings]


def _force(z, zmax, zb, mask, forcings, carry):
    """``z`` with each forcing applied for the step that ``carry`` is
    about to take."""
    for f in forcings:
        if isinstance(f, Gridded):
            z = swe.gridded_forcing(z, zmax, zb, mask, f.frames, f.rows,
                                    f.cols, f.interval, carry.t, carry.dt,
                                    carry.t_hydro)
        else:
            z = swe.uniform_forcing(z, zmax, zb, mask, f.values, f.interval,
                                    f.length, f.is_loss, carry.t, carry.dt,
                                    carry.t_hydro)
    return z


def _start(model: Model, targets, device):
    """The time controller's first carry on ``device``; refuses a sync
    time past the gridded rain's last frame."""
    last = min((len(f.frames) * f.interval for f in model.forcings
                if isinstance(f, Gridded)), default=math.inf)
    if max(targets, default=0.0) >= last:
        raise ValueError(f"the gridded rain's frames end at {last} s, "
                         f"before the last sync time {max(targets)} s")
    f64 = dict(dtype=torch.float64, device=device)
    zero = torch.zeros((), **f64)
    count = torch.zeros((), dtype=torch.long, device=device)
    return swe.Carry(zero, torch.full((), model.dt0, **f64), zero, count,
                     count)


def _tolerance(target):
    return max(1e-5, 8.0 * float(torch.finfo(torch.float64).eps)
               * abs(target))


def run(model: Model, targets, device, check_every=64):
    """Step ``model`` from its initial state through each sync time in
    ``targets``, yielding at each a dict of its clock ``t``, its
    ``t_hydro``, its successful ``steps`` and its ``state`` (z, zmax, qx,
    qy, zb) as host float64 arrays."""
    carry = _start(model, targets, device)
    f64 = dict(dtype=torch.float64, device=device)
    zb = torch.as_tensor(model.zb, **f64)
    z = torch.as_tensor(model.z0, **f64)
    state = (z, z.clone(), torch.zeros_like(z), torch.zeros_like(z))
    n = torch.full_like(z, model.manning)
    mask = _force_mask(z.shape, RADIUS[model.scheme], device)
    forcings = _forcings_on(model, device)
    step = (swe.godunov_step if model.scheme == "godunov"
            else swe.muscl_step)
    quite_small = model.vs * 10.0
    for target in targets:
        sync = torch.full((), float(target), **f64)
        while float(carry.t) < target - _tolerance(target):
            for _ in range(check_every):
                z, zmax, qx, qy = state
                z = _force(z, zmax, zb, mask, forcings, carry)
                state = step(z, zmax, qx, qy, zb, n, carry.dt, model.dx,
                             model.dx, model.vs, model.friction)
                speed = swe.max_wave_speed(*state, zb, quite_small)
                carry = swe.advance(carry, speed, sync, model.duration,
                                    model.dx, model.courant)
            if not np.isfinite(float(carry.t)):
                raise RuntimeError(f"reference diverged at t={target}")
        yield {"t": float(carry.t), "t_hydro": float(carry.t_hydro),
               "steps": int(carry.steps),
               "state": [a.cpu().numpy() for a in (*state, zb)]}


class Block:
    """One row block of ``run_blocks``: the domain's rows ``lo`` to
    ``hi`` on ``device``, held with the halo rows its step reads (none
    past the domain's edge).  ``own`` are the block's rows within those
    it holds; ``state`` is (z, zmax, qx, qy); ``mask`` is the whole
    domain's forcing mask, on the host."""

    def __init__(self, model: Model, mask, lo, hi, device):
        rows = model.zb.shape[0]
        ring = RADIUS[model.scheme]
        self.device = device
        top, bottom = max(lo - ring, 0), min(hi + ring, rows)
        self.own = slice(lo - top, hi - top)
        held = slice(top, bottom)
        f64 = dict(dtype=torch.float64, device=device)
        self.zb = torch.as_tensor(model.zb[held], **f64)
        z = torch.as_tensor(model.z0[held], **f64)
        self.state = (z, z.clone(), torch.zeros_like(z), torch.zeros_like(z))
        self.n = torch.full_like(z, model.manning)
        self.mask = mask[held].to(device)
        self.forcings = _forcings_on(model, device, held)


def row_blocks(rows, n):
    """(lo, hi) of ``n`` row blocks of ``rows`` rows, as even as the rows
    allow, the larger first."""
    sizes = [rows // n + (k < rows % n) for k in range(n)]
    edges = np.cumsum([0] + sizes)
    return [(int(a), int(b)) for a, b in zip(edges[:-1], edges[1:])]


def trade_halos(blocks):
    """Copy into each block's halo rows the rows its neighbours own."""
    for low, high in zip(blocks, blocks[1:]):
        for a, b in zip(low.state, high.state):
            k = len(a) - low.own.stop        # low's rows past its own
            a[low.own.stop:].copy_(b[high.own.start:high.own.start + k])
            k = high.own.start               # high's rows before its own
            b[:k].copy_(a[low.own.stop - k:low.own.stop])


def run_blocks(model: Model, targets, devices, check_every=64):
    """``run`` in row blocks, one on each of ``devices``, which may
    repeat: yields what ``run`` yields, the same bits on the card.  Each
    block steps its own rows with the halo rows its step reads (one for
    Godunov, two for MUSCL-Hancock), which the blocks trade after every
    step; the domain's edge ring stays where ``run`` has it.  The wave
    speed's maximum is taken over the blocks' maxima of their own rows,
    ``advance`` runs once on the first device, and each block forces with
    a copy of its carry.  Each cell's arithmetic is ``run``'s, so the
    blocks agree with it bit for bit wherever the library computes an
    element the same wherever it lies in an array: on the card; on the
    CPU, where no vectorised loop leaves a scalar tail that the whole
    grid does not (its pow rounds the two differently)."""
    rows = model.zb.shape[0]
    ring = RADIUS[model.scheme]
    bounds = row_blocks(rows, len(devices))
    if min(hi - lo for lo, hi in bounds) < ring:
        raise ValueError(f"{rows} rows make {len(devices)} blocks of fewer "
                         f"than the {ring} halo rows that each lends")
    first = devices[0]
    carry = _start(model, targets, first)
    mask = _force_mask(model.zb.shape, ring, "cpu")
    blocks = [Block(model, mask, lo, hi, d)
              for (lo, hi), d in zip(bounds, devices)]
    step = (swe.godunov_step if model.scheme == "godunov"
            else swe.muscl_step)
    quite_small = model.vs * 10.0
    for target in targets:
        sync = torch.full((), float(target), dtype=torch.float64,
                          device=first)
        while float(carry.t) < target - _tolerance(target):
            for _ in range(check_every):
                # Every block's copy of the carry goes out before any
                # block's step, which would otherwise run ahead of the
                # copies on the first card and hold the others back.
                carries = [carry._replace(t=carry.t.to(b.device),
                                          dt=carry.dt.to(b.device),
                                          t_hydro=carry.t_hydro.to(b.device))
                           for b in blocks]
                speeds = []
                for b, c in zip(blocks, carries):
                    z, zmax, qx, qy = b.state
                    z = _force(z, zmax, b.zb, b.mask, b.forcings, c)
                    b.state = step(z, zmax, qx, qy, b.zb, b.n, c.dt,
                                   model.dx, model.dx, model.vs,
                                   model.friction)
                    speeds.append(swe.max_wave_speed(
                        *(p[b.own] for p in b.state), b.zb[b.own],
                        quite_small))
                trade_halos(blocks)
                speed = torch.stack([v.to(first) for v in speeds]).amax()
                carry = swe.advance(carry, speed, sync, model.duration,
                                    model.dx, model.courant)
            if not np.isfinite(float(carry.t)):
                raise RuntimeError(f"reference diverged at t={target}")
        yield {"t": float(carry.t), "t_hydro": float(carry.t_hydro),
               "steps": int(carry.steps),
               "state": [np.concatenate([a[b.own].cpu().numpy()
                                         for a, b in zip(plane, blocks)])
                         for plane in (*zip(*(b.state for b in blocks)),
                                       [b.zb for b in blocks])]}
