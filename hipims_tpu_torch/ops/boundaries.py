"""Boundary-condition operators: uniform (atmospheric) rain and loss.

Mirrors bdy_Uniform (reference: src/Boundaries/CLBoundaries.clc) and its
host-side preparation (CBoundaryUniform.cpp).  Boundaries apply at the top
of every step on the current state, as in the reference's
scheduleIteration ordering (src/Schemes/CSchemeGodunov.cpp:1617-1666).
Uniform sources are gated by the hydrological accumulator
(TIMESTEP_HYDROLOGICAL) and use nearest-record lookup in time.

``apply`` takes ``mask``: a boolean tensor that is True exactly where
forcing is allowed, the grid minus the scheme's static ring
(``interior_force_mask``), built once per simulation.

Per-cell and gridded boundaries are not ported yet (ROADMAP.md, queue 1).
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


def interior_force_mask(shape, ring, device):
    """True where boundary forcing is allowed: more than ``ring`` cells
    from the grid's edge (the scheme's static ring is never updated, so
    forcing it would create path-dependent state)."""
    rows, cols = shape
    mask = torch.zeros((rows, cols), dtype=torch.bool, device=device)
    mask[ring:rows - ring, ring:cols - ring] = True
    return mask


@dataclasses.dataclass(frozen=True)
class UniformBoundary:
    """Domain-wide rainfall or loss rate (mm/hr), nearest-record in time.

    ``values`` is a host array until ``to`` puts it on the state's device
    in the state's dtype (``Simulation`` does so once)."""

    values: object                  # (T,) rates in mm/hr
    interval: float
    length: float
    is_loss: bool

    def to(self, device, dtype) -> "UniformBoundary":
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
