"""First-order Godunov-type finite-volume step on whole tensors.

Semantics mirror gts_cacheDisabled (reference:
src/Schemes/CLSchemeGodunov.clc:164-384): per interior cell, reconstruct
all four interfaces depth-positively, solve HLLC, apply bed-slope source
terms, update (z, qx, qy), apply implicit friction, track max FSL and clamp
tiny depths to the bed.  Disabled cells, dry neighbourhoods and a
suspended timestep are where-masks.

This is the plain PyTorch version of the fused step kernel
``csrc/stencil.cu``; ``ops/kernels/stencil.py`` dispatches between them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as C
from ..state import DomainStatic, FlowState
from .compensated import comp_add
from .friction import implicit_friction
from .riemann import local_datum, solve_interfaces


class SchemeParams(NamedTuple):
    """Static numerical-scheme configuration."""

    dx: float
    dy: float
    very_small: float = C.VERY_SMALL
    quite_small: float = C.QUITE_SMALL
    friction: bool = True
    # Vertical datum removed from device-side elevations (Domain.build
    # datum_shift); absolute-FSL boundary inputs subtract it.
    datum: float = 0.0


def _round_small(delta, vs):
    """Zero deltas with magnitude below the dry threshold (reference:
    src/Schemes/CLSchemeGodunov.clc:338-348)."""
    return torch.where(torch.abs(delta) < vs, 0.0, delta)


def godunov_interior(z, zmax, qx, qy, zb, n, dt, params: SchemeParams,
                     comp=None):
    """Update the interior of ring-extended planes.

    Inputs are (R, Cc) tensors whose outer ring stays static; returns the
    four updated (R-2, Cc-2) interior planes (five with ``comp``, the
    compensated-f32 residue of z).  ``dt`` is a 0-d tensor; dt <= 0 or any
    per-cell skip condition leaves a cell unchanged."""
    vs = params.very_small

    # x-axis interfaces between (y, i) [left] and (y, i+1) [right].
    fx = solve_interfaces(
        z[:, :-1], zb[:, :-1], qx[:, :-1], qy[:, :-1],
        z[:, 1:], zb[:, 1:], qx[:, 1:], qy[:, 1:], vs)
    # y-axis interfaces between (j, x) [south] and (j+1, x) [north].
    fy = solve_interfaces(
        z[:-1, :], zb[:-1, :], qy[:-1, :], qx[:-1, :],
        z[1:, :], zb[1:, :], qy[1:, :], qx[1:, :], vs)

    sl = (slice(1, -1), slice(1, -1))
    zc = z[sl]
    zbc = zb[sl]

    def face(fl, idx):
        return type(fl)(*(a[idx] for a in fl))

    f_e = face(fx, (slice(1, -1), slice(1, None)))
    f_w = face(fx, (slice(1, -1), slice(None, -1)))
    f_n = face(fy, (slice(1, None), slice(1, -1)))
    f_s = face(fy, (slice(None, -1), slice(1, -1)))

    zb_e, c_e = local_datum(zc, f_e.zbm)
    zb_w, c_w = local_datum(zc, f_w.zbm)
    zb_n, c_n = local_datum(zc, f_n.zbm)
    zb_s, c_s = local_datum(zc, f_s.zbm)

    inv_dx = 1.0 / params.dx
    inv_dy = 1.0 / params.dy

    # Bed-slope sources from the neighbour-side reconstructed surface and
    # the shifted local bed (reference: CLSchemeGodunov.clc:321-325).
    z_e = f_e.hr + zb_e
    z_w = f_w.hl + zb_w
    z_n = f_n.hr + zb_n
    z_s = f_s.hl + zb_s
    src_x = -C.GRAVITY * 0.5 * (z_e + z_w) * (zb_e - zb_w) * inv_dx
    src_y = -C.GRAVITY * 0.5 * (z_n + z_s) * (zb_n - zb_s) * inv_dy

    d_z = ((f_e.mass - f_w.mass) * inv_dx
           + (f_n.mass - f_s.mass) * inv_dy)
    d_qx = (((f_e.along + c_e) - (f_w.along + c_w)) * inv_dx
            + (f_n.cross - f_s.cross) * inv_dy - src_x)
    d_qy = ((f_e.cross - f_w.cross) * inv_dx
            + ((f_n.along + c_n) - (f_s.along + c_s)) * inv_dy - src_y)

    d_z = _round_small(d_z, vs)
    d_qx = _round_small(d_qx, vs)
    d_qy = _round_small(d_qy, vs)

    # Wet/dry stopping: any face flags it -> zero this cell's discharge.
    stop = f_e.stop_l | f_w.stop_r | f_n.stop_l | f_s.stop_r

    qx_c = torch.where(stop, 0.0, qx[sl])
    qy_c = torch.where(stop, 0.0, qy[sl])
    if comp is None:
        z_new = zc - dt * d_z
    else:
        comp_c = comp[sl]
        z_new, comp_new = comp_add(zc, comp_c, -(dt * d_z))
    qx_new = qx_c - dt * d_qx
    qy_new = qy_c - dt * d_qy

    if params.friction:
        qx_new, qy_new = implicit_friction(
            z_new, qx_new, qy_new, zbc, n[sl],
            torch.clamp(dt, min=vs), vs)

    # zmax is updated BEFORE the dry clamp (first-order order of the
    # reference; the MUSCL corrector reverses it).
    zmax_c = zmax[sl]
    zmax_new = torch.where((z_new > zmax_c) & (zmax_c > -9990.0),
                           z_new, zmax_c)
    # Compensated runs judge dryness on the TRUE surface z + comp.
    dry_new = ((z_new - zbc < vs) if comp is None
               else ((z_new - zbc) + comp_new < vs))
    z_new = torch.where(dry_new, zbc, z_new)

    # --- Skip masks (dry5 reads the raw neighbours, ring included) ------
    disabled = (zmax_c <= C.NODATA) | (zc == C.NODATA)
    dry = (z - zb) < vs
    dry5 = (dry[sl] & dry[1:-1, 2:] & dry[1:-1, :-2]
            & dry[2:, 1:-1] & dry[:-2, 1:-1])
    keep = disabled | dry5 | (dt <= 0.0)

    z_out = torch.where(keep, zc, z_new)
    zmax_out = torch.where(keep, zmax_c, zmax_new)
    qx_out = torch.where(keep, qx[sl], qx_new)
    qy_out = torch.where(keep, qy[sl], qy_new)
    if comp is None:
        return z_out, zmax_out, qx_out, qy_out
    comp_new = torch.where(dry_new, 0.0, comp_new)
    comp_out = torch.where(keep, comp_c, comp_new)
    return z_out, zmax_out, qx_out, qy_out, comp_out


def _with_interior(full, interior):
    out = full.clone()
    out[1:-1, 1:-1] = interior
    return out


def godunov_step(state: FlowState, static: DomainStatic, dt,
                 params: SchemeParams, comp=None):
    """One first-order step on the whole grid; the one-cell edge ring
    keeps its values.  With ``comp`` returns (FlowState, comp_new)."""
    out = godunov_interior(state.z, state.zmax, state.qx, state.qy,
                           static.zb, static.manning, dt, params, comp=comp)
    new = FlowState(*(_with_interior(a, o) for a, o in zip(state, out[:4])))
    if comp is None:
        return new
    return new, _with_interior(comp, out[4])
