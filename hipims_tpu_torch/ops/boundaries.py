"""Boundary-condition operators: uniform (atmospheric) rain and loss,
per-cell timeseries (a breach, an inflow hydrograph, a fixed level) and
gridded (radar) rain or mass flux.

Mirror bdy_Uniform, bdy_Cell and bdy_Gridded (reference: src/Boundaries/
CLBoundaries.clc:23-246) and their host-side preparation
(CBoundaryUniform.cpp, CBoundaryCell.cpp:298-460, CBoundaryGridded.cpp).
Boundaries apply at the top of every step on the current state, as in the
reference's scheduleIteration ordering
(src/Schemes/CSchemeGodunov.cpp:1617-1666).  Uniform and gridded sources
are gated by the hydrological accumulator (TIMESTEP_HYDROLOGICAL) and use
nearest-record lookup in time; cell boundaries apply every step with
linear interpolation in time.

Each boundary holds host arrays until ``to(device, dtype, domain)`` puts
them on the state's device (``Simulation`` does so once).  ``apply``
takes ``mask``: a boolean tensor that is True exactly where forcing is
allowed, the grid minus the scheme's static ring
(``interior_force_mask``), built once per simulation.  No ``apply``
reads anything back to the host: time indices stay on the device.

On a device mesh each block of the halo-deep window
(``parallel/halo_deep.py``) holds its own copy of every boundary, placed
by ``to(device, dtype, domain, origin=(oy, ox), shape=(er, ec))``: the
block's halo-extended array is ``shape`` cells whose [0, 0] is the global
cell ``origin``, so position-dependent forcing (gridded georeferencing,
cell indices) evaluates in global coordinates, as the reference builds a
per-domain transform (src/Boundaries/CBoundaryGridded.cpp:116-153) and
scatters cell boundaries with domain-local indices
(src/Boundaries/CBoundaryCell.cpp:447-451).  Halo copies of a forced cell
get the same forcing as their owner; the block's ``mask`` is the
complement of the logical ring in global coordinates, so every path
forces the same cells.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import constants as C
from ..state import DomainStatic, FlowState
from .compensated import comp_add
from .godunov import SchemeParams

MM_PER_HOUR_TO_M_PER_S = 1.0 / 3_600_000.0


def interior_force_mask(shape, ring, device, origin=(0, 0), logical=None):
    """True where boundary forcing is allowed: inside the logical grid
    (``logical`` rows, cols; the array itself by default), more than
    ``ring`` cells from its edge (the scheme's static ring is never
    updated, so forcing it would create path-dependent state).  The
    array's [0, 0] is the global cell ``origin``."""
    rows, cols = shape
    lr, lc = (rows, cols) if logical is None else logical
    gy = torch.arange(rows, device=device)[:, None] + origin[0]
    gx = torch.arange(cols, device=device)[None, :] + origin[1]
    return ((gy >= ring) & (gy < lr - ring)
            & (gx >= ring) & (gx < lc - ring))


@dataclasses.dataclass(frozen=True)
class UniformBoundary:
    """Domain-wide rainfall or loss rate (mm/hr), nearest-record in time.

    ``values`` is a host array until ``to`` puts it on the state's device
    in the state's dtype (``Simulation`` does so once)."""

    values: object                  # (T,) rates in mm/hr
    interval: float
    length: float
    is_loss: bool

    def to(self, device, dtype, domain=None, origin=(0, 0),
           shape=None) -> "UniformBoundary":
        return dataclasses.replace(self, values=torch.as_tensor(
            np.asarray(self.values), device=device).to(dtype))

    def apply(self, state: FlowState, static: DomainStatic, t, dt, t_hydro,
              params: SchemeParams, mask, comp=None):
        values = self.values
        # (t / interval) truncates toward zero, as the reference's cast.
        idx = torch.clamp((t / self.interval).to(torch.int64), 0,
                          values.shape[0] - 1)
        rate = torch.take(values, idx) * MM_PER_HOUR_TO_M_PER_S * t_hydro

        live = ((t_hydro >= C.TIMESTEP_HYDROLOGICAL) & (dt > 0.0)
                & (t < self.length))
        zc = state.z
        apply_mask = live & (state.zmax > C.NODATA) & mask
        if self.is_loss:
            # Loss clamps at the bed; a signed increment so the
            # compensated path can accumulate it exactly.
            delta = torch.maximum(static.zb - zc, -rate)
        else:
            delta = rate.expand_as(zc)
        delta = torch.where(apply_mask, delta, 0.0)
        if comp is None:
            return state._replace(z=zc + delta)
        # Unforced cells keep (z, comp) exactly: comp_add with delta = 0
        # would still fold the residue into the visible z.
        z_new, comp_new = comp_add(zc, comp, delta)
        if self.is_loss:
            # comp_add can round the visible z one ulp below the bed;
            # clamp it there and fold the clamp residue into comp.
            z_clamped = torch.maximum(static.zb, z_new)
            comp_new = comp_new - (z_clamped - z_new)
            z_new = z_clamped
        z_new = torch.where(apply_mask, z_new, zc)
        comp_new = torch.where(apply_mask, comp_new, comp)
        return state._replace(z=z_new), comp_new


@dataclasses.dataclass(frozen=True)
class GriddedBoundary:
    """Spatially varying (radar) rainfall in mm/hr, or a mass flux in
    m3/s per grid cell, on a coarser grid, nearest-record in time.

    ``series`` is (T, grid_rows, grid_cols) in domain orientation (row 0
    south); grid cell (i, j) covers world offsets from ``offset_x`` +
    j ``resolution`` and ``offset_y`` + i ``resolution`` relative to the
    domain's lower-left corner.  ``length`` gates the series off past its
    last frame (the reference instead clamps to an out-of-bounds frame
    index and rains the last frame forever,
    src/Boundaries/CLBoundaries.clc:229-230).

    ``to`` puts the frames on the device flattened and builds
    ``cell_index``: for every cell of the array, the flat index of its grid
    cell within a frame, floor(((ox + j) dx - offset_x) / resolution)
    clipped to the grid (and the same in y), computed once on the host in
    float64.  The array is the domain on one device; a mesh block passes
    its extended ``shape`` and ``origin`` = (row0, col0), the global index
    of its [0, 0] cell."""

    series: object                  # (T, grid_rows, grid_cols)
    interval: float
    resolution: float
    offset_x: float
    offset_y: float
    mass_flux: bool
    length: float = float("inf")
    cell_index: object = None       # (rows * cols,) int64, built by to()

    def to(self, device, dtype, domain=None, origin=(0, 0),
           shape=None) -> "GriddedBoundary":
        if domain is None:
            raise ValueError("GriddedBoundary.to needs the domain: its "
                             "cells are mapped onto the boundary grid once")
        series = np.asarray(self.series)
        _, grows, gcols = series.shape
        oy, ox = origin
        rows, cols = (domain.rows, domain.cols) if shape is None else shape
        xi = (((ox + np.arange(cols)) * float(domain.dx)
               - self.offset_x) / self.resolution)
        yi = (((oy + np.arange(rows)) * float(domain.dy)
               - self.offset_y) / self.resolution)
        ci = np.clip(np.floor(xi).astype(np.int64), 0, gcols - 1)
        ri = np.clip(np.floor(yi).astype(np.int64), 0, grows - 1)
        index = (ri[:, None] * gcols + ci[None, :]).reshape(-1)
        return dataclasses.replace(
            self,
            series=torch.as_tensor(series, device=device).to(dtype),
            cell_index=torch.as_tensor(index, device=device))

    def apply(self, state: FlowState, static: DomainStatic, t, dt, t_hydro,
              params: SchemeParams, mask, comp=None):
        # (t / interval) truncates toward zero, as the reference's cast;
        # the frame is picked by a device index, so no host read.
        ti = torch.clamp((t / self.interval).to(torch.int64), 0,
                         self.series.shape[0] - 1)
        # Scale the one frame, then gather it per cell: the same operations
        # per value as scaling after the gather, on grid cells only.
        frame = self.series.index_select(0, ti.view(1))
        if self.mass_flux:
            frame = frame / (params.dx * params.dy) * t_hydro
        else:
            frame = frame * MM_PER_HOUR_TO_M_PER_S * t_hydro
        rate = torch.take(frame, self.cell_index).view(state.z.shape)

        live = ((t_hydro >= C.TIMESTEP_HYDROLOGICAL) & (dt > 0.0)
                & (t < self.length))
        zc = state.z
        forced = live & (state.zmax > C.NODATA) & (zc != C.NODATA) & mask
        delta = torch.where(forced, rate, 0.0)
        if comp is None:
            return state._replace(z=zc + delta)
        # Select-guarded as in UniformBoundary: unforced cells keep
        # (z, comp) exactly.
        z_new, comp_new = comp_add(zc, comp, delta)
        z_new = torch.where(forced, z_new, zc)
        comp_new = torch.where(forced, comp_new, comp)
        return state._replace(z=z_new), comp_new


# Depth-definition modes (reference: src/Boundaries/CLBoundaries.clh:35-38).
DEPTH_IGNORE = 0
DEPTH_IS_FSL = 1
DEPTH_IS_DEPTH = 2
DEPTH_IS_CRITICAL = 3

# Discharge-definition modes (reference: CLBoundaries.clh:40-43).
DISCHARGE_IGNORE = 0
DISCHARGE_IS_DISCHARGE = 1
DISCHARGE_IS_VELOCITY = 2
DISCHARGE_IS_VOLUME = 3


@dataclasses.dataclass(frozen=True)
class CellBoundary:
    """Per-cell timeseries boundary (depth / FSL / discharge / velocity /
    volume surge), linearly interpolated in time.

    ``series`` columns are (time, depth-or-level, discharge-x,
    discharge-y); total-discharge series are pre-divided by the cell count
    by the loader, as the reference does host-side
    (src/Boundaries/CBoundaryCell.cpp:345-355).  ``rows``, ``cols`` and
    ``series`` are host arrays until ``to`` puts them on the state's
    device (``Simulation`` does so once).  A mesh block's ``to`` (its
    extended ``shape`` and ``origin``) keeps the target cells inside the
    block, shifted to its indices: the others are dropped, as the JAX
    package's drop-mode scatter drops them."""

    rows: object                    # (K,) int cell row indices
    cols: object                    # (K,) int cell col indices
    series: object                  # (T, 4)
    interval: float
    length: float
    depth_mode: int
    discharge_mode: int

    def to(self, device, dtype, domain=None, origin=(0, 0),
           shape=None) -> "CellBoundary":
        rows = np.asarray(self.rows, np.int64) - origin[0]
        cols = np.asarray(self.cols, np.int64) - origin[1]
        if shape is not None:
            inside = ((rows >= 0) & (rows < shape[0])
                      & (cols >= 0) & (cols < shape[1]))
            rows, cols = rows[inside], cols[inside]

        def idx(a):
            return torch.as_tensor(a, device=device)
        return dataclasses.replace(
            self, rows=idx(rows), cols=idx(cols),
            series=torch.as_tensor(np.asarray(self.series),
                                   device=device).to(dtype))

    def apply(self, state: FlowState, static: DomainStatic, t, dt, t_hydro,
              params: SchemeParams, mask, comp=None):
        series = self.series
        last = series.shape[0] - 1
        base = torch.clamp((t / self.interval).to(torch.int64), 0, last)
        rows = series.index_select(0, torch.stack([base, torch.clamp(
            base + 1, 0, last)]))
        frac = torch.remainder(t, self.interval) / self.interval
        ts = rows[0] + (rows[1] - rows[0]) * frac
        ts_depth, ts_qx, ts_qy = ts[1], ts[2], ts[3]

        live = (dt > 0.0) & (t < self.length)
        rr, cc = self.rows, self.cols
        zb_c = static.zb[rr, cc]
        z_c = state.z[rr, cc]
        qx_c = state.qx[rr, cc]
        qy_c = state.qy[rr, cc]

        if self.depth_mode == DEPTH_IS_DEPTH:
            z_new = zb_c + ts_depth
        elif self.depth_mode == DEPTH_IS_FSL:
            # Timeseries levels are absolute; device elevations may ride a
            # shifted datum (SchemeParams.datum).
            z_new = torch.maximum(zb_c, ts_depth - params.datum)
        else:
            # Free surface: build up depth from the discharge being pushed
            # in, with a critical-depth floor (reference CLBoundaries.clc:
            # 69-101).
            if self.discharge_mode == DISCHARGE_IS_VOLUME:
                d_depth = torch.abs(ts_qx) * dt / (params.dx * params.dy)
                d_crit = torch.zeros_like(d_depth)
                inject = torch.ones_like(live)
            else:
                d_depth = (torch.abs(ts_qx) * dt / params.dy
                           + torch.abs(ts_qy) * dt / params.dx)
                # No cbrt in PyTorch: the arguments are >= 0, where
                # x ** (1/3) is the cube root to a few ulps.
                d_crit = torch.maximum(
                    torch.pow(ts_qx * ts_qx / C.GRAVITY, 1.0 / 3.0),
                    torch.pow(ts_qy * ts_qy / C.GRAVITY, 1.0 / 3.0))
                inject = ((torch.abs(ts_qx) > C.VERY_SMALL)
                          | (torch.abs(ts_qy) > C.VERY_SMALL))
            z_new = torch.where(
                inject, torch.maximum(zb_c + d_crit, z_c + d_depth), z_c)

        if self.discharge_mode == DISCHARGE_IS_DISCHARGE:
            qx_new = ts_qx.expand_as(z_new)
            qy_new = ts_qy.expand_as(z_new)
        elif self.discharge_mode == DISCHARGE_IS_VELOCITY:
            qx_new = ts_qx * (z_new - zb_c)
            qy_new = ts_qy * (z_new - zb_c)
        else:
            qx_new, qy_new = qx_c, qy_c

        # Cells the mask forbids (the static ring) keep their values: the
        # same forced cell set as the JAX package's dropped scatters.
        forced = live & mask[rr, cc]
        new = state._replace(
            z=state.z.index_put((rr, cc), torch.where(forced, z_new, z_c)),
            qx=state.qx.index_put((rr, cc),
                                  torch.where(forced, qx_new, qx_c)),
            qy=state.qy.index_put((rr, cc),
                                  torch.where(forced, qy_new, qy_c)))
        if comp is None:
            return new
        # The boundary overwrites z outright, so the running-sum residue
        # at forced cells is reset while the forcing is live.
        comp_c = comp[rr, cc]
        return new, comp.index_put((rr, cc),
                                   torch.where(forced, 0.0, comp_c))


def apply_boundaries(boundaries, state: FlowState, static: DomainStatic,
                     t, dt, t_hydro, params: SchemeParams, mask, comp=None):
    """Apply every configured boundary in order (reference fan-out:
    src/Boundaries/CBoundaryMap.cpp:76-91).  With ``comp`` returns
    (state, comp)."""
    if comp is None:
        for b in boundaries:
            state = b.apply(state, static, t, dt, t_hydro, params, mask)
        return state
    for b in boundaries:
        state, comp = b.apply(state, static, t, dt, t_hydro, params, mask,
                              comp=comp)
    return state, comp
