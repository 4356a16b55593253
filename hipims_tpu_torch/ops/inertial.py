"""Partial-inertial (Bates / de Almeida-type) simplified scheme on whole
tensors.

Mirrors ine_cacheDisabled / calculateInertialFlux (reference:
src/Schemes/CLSchemeInertial.clc:27-163, :335-378): per-face inertial
discharge with implicit Manning drag and a Froude-number limiter
(FROUDE_LIMIT = 0.8); the state's qx/qy slots store each cell's W/S face
discharges (a staggered layout).  Reference quirks kept for parity: the
FSL update divides by dy only, every face slope uses dx, and each cell
computes all four of its faces with its OWN Manning n, so the two cells of
one interface store different discharges where n differs.

This is the plain PyTorch version of kernel K4 (``csrc/stencil.cu``);
``ops/kernels/stencil.py`` dispatches between them.
"""

from __future__ import annotations

import torch

from .. import constants as C
from ..state import DomainStatic, FlowState
from .compensated import comp_add
from .godunov import SchemeParams, _with_interior


def _face_discharge(manning, dt, prev_q, level_up, bed_up, level_down,
                    bed_down, dx, vs):
    """Inertial per-unit-width discharge across one face."""
    g = C.GRAVITY
    depth = (torch.maximum(level_down, level_up)
             - torch.maximum(bed_up, bed_down))
    dry = depth < vs
    depth_s = torch.where(dry, 1.0, depth)
    slope = (level_down - level_up) / dx

    # depth^(10/3) as one exp/log pair, as the CUDA kernel computes it.
    q = (prev_q - g * depth_s * dt * slope) / (
        1.0 + g * depth_s * dt * manning * manning * torch.abs(prev_q)
        / torch.exp(torch.log(depth_s) * (10.0 / 3.0)))

    # Froude limiter.
    celerity = torch.sqrt(g * depth_s)
    froude = torch.abs(q) / depth_s / celerity
    q_lim = depth_s * celerity * C.FROUDE_LIMIT
    fast = froude > C.FROUDE_LIMIT
    q = torch.where((q > 0.0) & fast, q_lim, q)
    q = torch.where((q < 0.0) & fast, -q_lim, q)
    return torch.where(dry, 0.0, q)


def inertial_interior(z, zmax, qx, qy, zb, n, dt, params: SchemeParams,
                      comp=None):
    """Update the interior of ring-extended planes (radius 1); returns the
    four updated (R-2, Cc-2) interior planes (five with ``comp``)."""
    vs = params.very_small
    dx = params.dx
    sl = (slice(1, -1), slice(1, -1))
    e, w = (slice(1, -1), slice(2, None)), (slice(1, -1), slice(None, -2))
    nn, s = (slice(2, None), slice(1, -1)), (slice(None, -2), slice(1, -1))
    zc, zbc, nc = z[sl], zb[sl], n[sl]

    # "up" is the east (north) side of each face, "down" the west (south);
    # the previous discharge is the up cell's stored W (S) face value.
    q_e = _face_discharge(nc, dt, qx[e], z[e], zb[e], zc, zbc, dx, vs)
    q_w = _face_discharge(nc, dt, qx[sl], zc, zbc, z[w], zb[w], dx, vs)
    q_n = _face_discharge(nc, dt, qy[nn], z[nn], zb[nn], zc, zbc, dx, vs)
    q_s = _face_discharge(nc, dt, qy[sl], zc, zbc, z[s], zb[s], dx, vs)

    d_fsl = (q_e - q_w + q_n - q_s) / params.dy
    if comp is None:
        z_new = zc + dt * d_fsl
    else:
        comp_c = comp[sl]
        z_new, comp_new = comp_add(zc, comp_c, dt * d_fsl)

    zmax_c = zmax[sl]
    zmax_new = torch.where(z_new > zmax_c, z_new, zmax_c)
    # Compensated runs judge dryness on the TRUE surface z + comp.
    dry_new = ((z_new - zbc < vs) if comp is None
               else ((z_new - zbc) + comp_new < vs))
    z_new = torch.where(dry_new, zbc, z_new)

    disabled = (zmax_c <= C.NODATA) | (zc == C.NODATA)
    dry = (z - zb) < vs
    dry5 = dry[sl] & dry[e] & dry[w] & dry[nn] & dry[s]
    keep = disabled | dry5 | (dt <= 0.0)

    outs = (torch.where(keep, zc, z_new),
            torch.where(keep, zmax_c, zmax_new),
            torch.where(keep, qx[sl], q_w),
            torch.where(keep, qy[sl], q_s))
    if comp is None:
        return outs
    comp_new = torch.where(dry_new, 0.0, comp_new)
    return outs + (torch.where(keep, comp_c, comp_new),)


def inertial_step(state: FlowState, static: DomainStatic, dt,
                  params: SchemeParams, comp=None):
    """One partial-inertial step on the whole grid; the one-cell edge ring
    keeps its values.  With ``comp`` returns (FlowState, comp_new)."""
    out = inertial_interior(*state, static.zb, static.manning, dt, params,
                            comp=comp)
    new = FlowState(*(_with_interior(a, o) for a, o in zip(state, out[:4])))
    if comp is None:
        return new
    return new, _with_interior(comp, out[4])
