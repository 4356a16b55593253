"""Depth-positivity-preserving interface reconstruction + HLLC flux, over
all interfaces of one axis at once.

Each interface is solved ONCE.  The reference's per-cell vertical datum
shift (reference: src/Schemes/CLSchemeGodunov.clc:27-159
reconstructInterface; src/Solvers/CLSolverHLLC.clc:27-248 riemannSolver)
changes only the momentum-pressure flux, by the additive constant
C = -0.5 g zb_local^2 with zb_local = min(zb_max, z_cell); the flux here
keeps the shift-invariant 0.5 g h^2 part and each cell adds its own C
(``local_datum``).  Every quantity stays at local-terrain magnitude, which
matters at closed-wall cells (bed 9999.9).

"along" is the axis normal to the interface, "cross" the tangential one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as C
from ..constants import GRAVITY


class InterfaceFlux(NamedTuple):
    """Shared (shift-free) interface solution: mass, along (0.5 g h^2
    pressure part only) and cross fluxes, the max bed ``zbm``, the
    reconstructed depths and each side's stopping condition."""

    mass: torch.Tensor
    along: torch.Tensor
    cross: torch.Tensor
    zbm: torch.Tensor
    hl: torch.Tensor
    hr: torch.Tensor
    stop_l: torch.Tensor
    stop_r: torch.Tensor


def _safe_inv(h, vs):
    """1/h, or 0 where h < vs (the dry-side velocity zeroing)."""
    return torch.where(h < vs, 0.0, 1.0 / torch.where(h < vs, 1.0, h))


def solve_interfaces(zl, zbl, qal, qcl, zr, zbr, qar, qcr,
                     very_small: float) -> InterfaceFlux:
    """Reconstruct + HLLC for a batch of interfaces (first-order data)."""
    vs = very_small
    inv_hl = _safe_inv(zl - zbl, vs)
    inv_hr = _safe_inv(zr - zbr, vs)
    ual = qal * inv_hl
    ucl = qcl * inv_hl
    uar = qar * inv_hr
    ucr = qcr * inv_hr

    # Non-negative reconstruction against the common (max) bed.
    zbm = torch.maximum(zbl, zbr)
    hl = torch.clamp(zl - zbm, min=0.0)
    hr = torch.clamp(zr - zbm, min=0.0)
    return _hllc(hl, hr, zbm, hl * ual, hl * ucl, hr * uar, hr * ucr,
                 ual, ucl, uar, ucr, qal, qar, vs, qcl_raw=qcl,
                 qcr_raw=qcr)


def _hllc(hl, hr, zbm, qal_r, qcl_r, qar_r, qcr_r,
          ual, ucl, uar, ucr, qal_raw, qar_raw, vs,
          qcl_raw=None, qcr_raw=None) -> InterfaceFlux:
    """HLLC core on reconstructed states (depth form)."""
    g = GRAVITY

    # Stopping conditions.  Single precision guards every comparison with
    # an absolute AND a tangential-relative floor (constants.STOP_FLOW_*);
    # f64 keeps the reference's strict comparisons against 0.
    dry_l = hl <= vs
    dry_r = hr <= vs
    if hl.dtype == torch.float32:
        eps, rel = C.STOP_FLOW_EPS, C.STOP_FLOW_REL
        thr_ul = torch.clamp(rel * torch.abs(ucl), min=eps)
        thr_ur = torch.clamp(rel * torch.abs(ucr), min=eps)
        thr_ql = (torch.clamp(rel * torch.abs(qcl_raw), min=eps)
                  if qcl_raw is not None else eps)
        thr_qr = (torch.clamp(rel * torch.abs(qcr_raw), min=eps)
                  if qcr_raw is not None else eps)
    else:
        thr_ul = thr_ur = thr_ql = thr_qr = 0.0
    cond_shared = (dry_r & (ual < -thr_ul)) | (dry_l & (uar > thr_ur))
    stop_l = (dry_l & (qal_raw > thr_ql)) | cond_shared
    stop_r = (dry_r & (qar_raw < -thr_qr)) | cond_shared

    vl = torch.where(hl < vs, 0.0, ual)
    wl = torch.where(hl < vs, 0.0, ucl)
    vr = torch.where(hr < vs, 0.0, uar)
    wr = torch.where(hr < vs, 0.0, ucr)

    al = torch.sqrt(g * hl)
    ar = torch.sqrt(g * hr)
    # a_star = sqrt(g h_star) collapses to |a_avg + (vl - vr)/4|.
    a_avg = 0.5 * (al + ar)
    u_star = 0.5 * (vl + vr) + al - ar
    a_star = torch.abs(a_avg + 0.25 * (vl - vr))

    s_l = torch.where(hl < vs, vr - 2.0 * ar,
                      torch.minimum(vl - al, u_star - a_star))
    s_r = torch.where(hr < vs, vl + 2.0 * al,
                      torch.maximum(vr + ar, u_star + a_star))
    mom_r = hr * (vr - s_r)
    mom_l = hl * (vl - s_l)
    # s_m = sm_num / sm_den is used only as the predicate s_m >= 0 (with
    # s_m = 0 when sm_den == 0), so a sign test replaces the division.
    sm_num = s_l * mom_r - s_r * mom_l
    sm_den = mom_r - mom_l
    sm_nonneg = (((sm_den > 0.0) & (sm_num >= 0.0))
                 | ((sm_den < 0.0) & (sm_num <= 0.0))
                 | (sm_den == 0.0))

    p_l = 0.5 * g * hl * hl
    p_r = 0.5 * g * hr * hr

    fl_mass = qal_r
    fl_along = vl * qal_r + p_l
    fl_cross = vl * qcl_r
    fr_mass = qar_r
    fr_along = vr * qar_r + p_r
    fr_cross = vr * qcr_r

    sdiff = s_r - s_l
    inv_sdiff = torch.where(sdiff == 0.0, 0.0,
                            1.0 / torch.where(sdiff == 0.0, 1.0, sdiff))
    slsr = s_l * s_r
    f1_m = (s_r * fl_mass - s_l * fr_mass + slsr * (hr - hl)) * inv_sdiff
    f2_m = (s_r * fl_along - s_l * fr_along
            + slsr * (fr_mass - fl_mass)) * inv_sdiff

    b_left = s_l >= 0.0
    b_right = (s_l < 0.0) & (s_r < 0.0)
    b_mid1 = (s_l < 0.0) & (s_r >= 0.0) & sm_nonneg

    mass = torch.where(b_left, fl_mass, torch.where(b_right, fr_mass, f1_m))
    along = torch.where(b_left, fl_along,
                        torch.where(b_right, fr_along, f2_m))
    cross = torch.where(b_left, fl_cross,
                        torch.where(b_right, fr_cross,
                                    torch.where(b_mid1, f1_m * wl,
                                                f1_m * wr)))

    # Both sides dry: hydrostatic pressure only (datum part per cell).
    both_dry = (hl < vs) & (hr < vs)
    hsum = hl + hr
    dry_along = 0.5 * g * 0.25 * hsum * hsum
    mass = torch.where(both_dry, 0.0, mass)
    along = torch.where(both_dry, dry_along, along)
    cross = torch.where(both_dry, 0.0, cross)

    return InterfaceFlux(mass=mass, along=along, cross=cross, zbm=zbm,
                         hl=hl, hr=hr, stop_l=stop_l, stop_r=stop_r)


def local_datum(z_cell, zbm):
    """Per-cell local datum zb_local = min(zb_max, z_cell) and its
    momentum-flux term C = -0.5 g zb_local^2.  Returns (zb_local, C)."""
    zb_local = torch.minimum(zbm, z_cell)
    return zb_local, -0.5 * GRAVITY * zb_local * zb_local
