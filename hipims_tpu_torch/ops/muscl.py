"""Second-order MUSCL-Hancock scheme on whole tensors.

Mirrors the predictor mch_1st (reference:
src/Schemes/CLSchemeMUSCLHancock.clc:301-526) and corrector mch_2nd_cacheNone
(:534-801 with the estimate-based reconstructInterface at :1119-1230).  As in
ops/godunov.py every interface is solved once, with the per-cell datum shift
applied as a closed-form correction.  The corrector leaves a TWO-cell static
ring (bounds check at src/Schemes/CLSchemeMUSCLHancock.clc:568-573).

These are the plain PyTorch versions of the split predictor/corrector
kernels ``csrc/muscl_split.cu``; ``ops/kernels/muscl_split.py`` dispatches
between them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import constants as C
from ..state import DomainStatic, FlowState
from .compensated import comp_add
from .friction import implicit_friction
from .godunov import SchemeParams, _round_small
from .limiters import slope_vector
from .riemann import local_datum, solve_interfaces_muscl

# First-order fallback thresholds (reference: the predictor's dry/edge
# guards, src/Schemes/CLSchemeMUSCLHancock.clc:320-335): a nearly dry cell
# or any disabled/boundary neighbour drops to first order.  zmax <= -9998
# covers both the -9999 disabled sentinel and the 9999.9 edge-wall cells'
# untouched initial zmax.
FIRST_ORDER_DRY_DEPTH = 1e-5
SENTINEL_ZMAX = -9998.0

# One-ring interior and its four neighbours, as slices of a whole plane.
_C = (slice(1, -1), slice(1, -1))
_N = (slice(2, None), slice(1, -1))
_S = (slice(None, -2), slice(1, -1))
_E = (slice(1, -1), slice(2, None))
_W = (slice(1, -1), slice(None, -2))


def first_order_mask(hc, zmax_n, zmax_e, zmax_s, zmax_w):
    """Cells that fall back to first order in the predictor (their slopes
    are stored, or recomputed, as zero)."""
    return ((hc < FIRST_ORDER_DRY_DEPTH)
            | (zmax_n <= SENTINEL_ZMAX) | (zmax_e <= SENTINEL_ZMAX)
            | (zmax_s <= SENTINEL_ZMAX) | (zmax_w <= SENTINEL_ZMAX))


class FaceExtrap(NamedTuple):
    """Face-extrapolated estimate (z, h, qx, qy), one entry per cell."""

    z: torch.Tensor
    h: torch.Tensor
    qx: torch.Tensor
    qy: torch.Tensor


def _flux_x(face: FaceExtrap, vs):
    """SWE flux vector in x from an extrapolated face state (reference:
    estimateFluxVectorX, src/Schemes/CLSchemeMUSCLHancock.clc:420-443)."""
    u = torch.where(face.h < vs, 0.0, face.qx
                    / torch.where(face.h < vs, 1.0, face.h))
    p = 0.5 * C.GRAVITY * (face.z * face.z
                           - 2.0 * (face.z - face.h) * face.z)
    return face.qx, u * face.qx + p, u * face.qy


def _flux_y(face: FaceExtrap, vs):
    v = torch.where(face.h < vs, 0.0, face.qy
                    / torch.where(face.h < vs, 1.0, face.h))
    p = 0.5 * C.GRAVITY * (face.z * face.z
                           - 2.0 * (face.z - face.h) * face.z)
    return face.qy, v * face.qx, v * face.qy + p


def interior_slopes(z, zmax, qx, qy, zb, vs):
    """First-order mask and limited slopes (sx, sy) of the one-ring
    interior of whole planes; slopes are NOT yet zeroed on the mask."""
    hc = z[_C] - zb[_C]
    first_order = first_order_mask(hc, zmax[_N], zmax[_E], zmax[_S],
                                   zmax[_W])
    cen = (z[_C], zb[_C], qx[_C], qy[_C])
    sx = slope_vector(*(a[_W] for a in (z, zb, qx, qy)), *cen,
                      *(a[_E] for a in (z, zb, qx, qy)), vs)
    sy = slope_vector(*(a[_S] for a in (z, zb, qx, qy)), *cen,
                      *(a[_N] for a in (z, zb, qx, qy)), vs)
    return first_order, sx, sy


def muscl_predictor_base_slopes(z, zmax, qx, qy, zb, dt,
                                params: SchemeParams):
    """Half-step base state + limited slopes for the one-ring interior.

    Returns (base, sx, sy), each a FaceExtrap-shaped 4-tuple of (M-2, Cc-2)
    slabs, such that the four face extrapolations reconstruct as
    N = base + 0.5*sy, E = base + 0.5*sx, S = base - 0.5*sy,
    W = base - 0.5*sx (``faces_from_base_slopes``); first-order cells carry
    zero slopes and the original state as base."""
    vs = params.very_small
    first_order, sx, sy = interior_slopes(z, zmax, qx, qy, zb, vs)
    zc, zbc = z[_C], zb[_C]
    hc = zc - zbc
    qxc, qyc = qx[_C], qy[_C]

    def extrap(zv, hv, qxv, qyv, slope, coef):
        return FaceExtrap(z=zv + coef * slope[0], h=hv + coef * slope[1],
                          qx=qxv + coef * slope[2], qy=qyv + coef * slope[3])

    ex_n0 = extrap(zc, hc, qxc, qyc, sy, +0.5)
    ex_e0 = extrap(zc, hc, qxc, qyc, sx, +0.5)
    ex_s0 = extrap(zc, hc, qxc, qyc, sy, -0.5)
    ex_w0 = extrap(zc, hc, qxc, qyc, sx, -0.5)

    fn = _flux_y(ex_n0, vs)
    fe = _flux_x(ex_e0, vs)
    fs = _flux_y(ex_s0, vs)
    fw = _flux_x(ex_w0, vs)

    inv_dx, inv_dy = 1.0 / params.dx, 1.0 / params.dy
    src_x = -C.GRAVITY * 0.5 * (ex_e0.z + ex_w0.z) \
        * ((ex_e0.z - ex_e0.h) - (ex_w0.z - ex_w0.h)) * inv_dx
    src_y = -C.GRAVITY * 0.5 * (ex_n0.z + ex_s0.z) \
        * ((ex_n0.z - ex_n0.h) - (ex_s0.z - ex_s0.h)) * inv_dy

    d_z = (fe[0] - fw[0]) * inv_dx + (fn[0] - fs[0]) * inv_dy
    d_qx = (fe[1] - fw[1]) * inv_dx + (fn[1] - fs[1]) * inv_dy - src_x
    d_qy = (fe[2] - fw[2]) * inv_dx + (fn[2] - fs[2]) * inv_dy - src_y
    d_z = _round_small(d_z, vs)
    d_qx = _round_small(d_qx, vs)
    d_qy = _round_small(d_qy, vs)

    z_half = zc - 0.5 * dt * d_z
    qx_half = qxc - 0.5 * dt * d_qx
    qy_half = qyc - 0.5 * dt * d_qy
    h_half = z_half - zbc

    base = FaceExtrap(
        z=torch.where(first_order, zc, z_half),
        h=torch.where(first_order, hc, h_half),
        qx=torch.where(first_order, qxc, qx_half),
        qy=torch.where(first_order, qyc, qy_half))
    sx_out = tuple(torch.where(first_order, 0.0, s) for s in sx)
    sy_out = tuple(torch.where(first_order, 0.0, s) for s in sy)
    return base, sx_out, sy_out


def faces_from_base_slopes(base, sx, sy):
    """The (N, E, S, W) FaceExtrap tuple from base + slopes."""
    def extrap(slope, coef):
        return FaceExtrap(z=base.z + coef * slope[0],
                          h=base.h + coef * slope[1],
                          qx=base.qx + coef * slope[2],
                          qy=base.qy + coef * slope[3])
    return (extrap(sy, +0.5), extrap(sx, +0.5),
            extrap(sy, -0.5), extrap(sx, -0.5))


def muscl_predictor_interior(z, zmax, qx, qy, zb, dt,
                             params: SchemeParams):
    """Half-timestep predictor for the one-ring interior of (M, Cc) planes.

    Returns four FaceExtrap slabs of shape (M-2, Cc-2) ordered N, E, S, W,
    where slab[j, i] belongs to cell (j+1, i+1).  The JAX package writes
    the second-order faces out and picks the first-order state per cell;
    base + 0.5 * slope gives the same values, since a first-order cell has
    zero slopes and its state as base."""
    return faces_from_base_slopes(
        *muscl_predictor_base_slopes(z, zmax, qx, qy, zb, dt, params))


def muscl_corrector_full(z, zmax, qx, qy, zb, n, faces, dt,
                         params: SchemeParams, comp=None):
    """Radius-1 corrector over FULL-SIZE face-extrapolation planes.

    ``faces`` are (M, Cc) FaceExtrap planes aligned with the state (ring
    entries may hold first-order placeholders; no valid cell consumes
    them).  Returns the four updated (M-2, Cc-2) interior planes (five with
    ``comp``); the caller masks the scheme's two-cell static ring."""
    vs = params.very_small
    ex_n, ex_e, ex_s, ex_w = faces

    fx = solve_interfaces_muscl(
        ex_e.z[:, :-1], ex_e.h[:, :-1], ex_e.qx[:, :-1], ex_e.qy[:, :-1],
        ex_w.z[:, 1:], ex_w.h[:, 1:], ex_w.qx[:, 1:], ex_w.qy[:, 1:],
        qx[:, :-1], qx[:, 1:], vs,
        qcl_cell=qy[:, :-1], qcr_cell=qy[:, 1:])
    fy = solve_interfaces_muscl(
        ex_n.z[:-1, :], ex_n.h[:-1, :], ex_n.qy[:-1, :], ex_n.qx[:-1, :],
        ex_s.z[1:, :], ex_s.h[1:, :], ex_s.qy[1:, :], ex_s.qx[1:, :],
        qy[:-1, :], qy[1:, :], vs,
        qcl_cell=qx[:-1, :], qcr_cell=qx[1:, :])

    zc = z[_C]
    zbc = zb[_C]

    def face(fl, idx):
        return type(fl)(*(a[idx] for a in fl))

    f_e = face(fx, (slice(1, -1), slice(1, None)))
    f_w = face(fx, (slice(1, -1), slice(None, -1)))
    f_n = face(fy, (slice(1, None), slice(1, -1)))
    f_s = face(fy, (slice(None, -1), slice(1, -1)))

    # Per-cell local datum from the cell's own face-extrapolated surface
    # (reference: src/Schemes/CLSchemeMUSCLHancock.clc:1156).
    zb_e, c_e = local_datum(ex_e.z[_C], f_e.zbm)
    zb_w, c_w = local_datum(ex_w.z[_C], f_w.zbm)
    zb_n, c_n = local_datum(ex_n.z[_C], f_n.zbm)
    zb_s, c_s = local_datum(ex_s.z[_C], f_s.zbm)

    inv_dx, inv_dy = 1.0 / params.dx, 1.0 / params.dy
    z_e = f_e.hr + zb_e
    z_w = f_w.hl + zb_w
    z_n = f_n.hr + zb_n
    z_s = f_s.hl + zb_s
    src_x = -C.GRAVITY * 0.5 * (z_e + z_w) * (zb_e - zb_w) * inv_dx
    src_y = -C.GRAVITY * 0.5 * (z_n + z_s) * (zb_n - zb_s) * inv_dy

    d_z = (f_e.mass - f_w.mass) * inv_dx + (f_n.mass - f_s.mass) * inv_dy
    d_qx = (((f_e.along + c_e) - (f_w.along + c_w)) * inv_dx
            + (f_n.cross - f_s.cross) * inv_dy - src_x)
    d_qy = ((f_e.cross - f_w.cross) * inv_dx
            + ((f_n.along + c_n) - (f_s.along + c_s)) * inv_dy - src_y)
    d_z = _round_small(d_z, vs)
    d_qx = _round_small(d_qx, vs)
    d_qy = _round_small(d_qy, vs)

    stop = f_e.stop_l | f_w.stop_r | f_n.stop_l | f_s.stop_r
    qx_c = torch.where(stop, 0.0, qx[_C])
    qy_c = torch.where(stop, 0.0, qy[_C])
    if comp is None:
        z_new = zc - dt * d_z
    else:
        comp_c = comp[_C]
        z_new, comp_new = comp_add(zc, comp_c, -(dt * d_z))
    qx_new = qx_c - dt * d_qx
    qy_new = qy_c - dt * d_qy

    if params.friction:
        qx_new, qy_new = implicit_friction(
            z_new, qx_new, qy_new, zbc, n[_C], torch.clamp(dt, min=vs), vs)

    # The corrector clamps tiny depths BEFORE the max-FSL update (reference:
    # src/Schemes/CLSchemeMUSCLHancock.clc:791-797), unlike the first-order
    # step.  Compensated runs judge dryness on the true surface z + comp.
    dry_new = ((z_new - zbc < vs) if comp is None
               else ((z_new - zbc) + comp_new < vs))
    z_new = torch.where(dry_new, zbc, z_new)
    zmax_c = zmax[_C]
    zmax_new = torch.where((z_new > zmax_c) & (zmax_c > -9990.0),
                           z_new, zmax_c)

    disabled = (zmax_c <= C.NODATA) | (zc == C.NODATA)
    # Reference dry-neighbourhood skip: the centre by depth, the neighbours
    # by max-FSL below the threshold (a reference quirk kept for parity;
    # src/Schemes/CLSchemeMUSCLHancock.clc:596-597, :633).
    dry5 = ((zc - zbc < vs)
            & (zmax[_N] < vs) & (zmax[_S] < vs)
            & (zmax[_E] < vs) & (zmax[_W] < vs))
    keep = disabled | dry5 | (dt <= 0.0)

    outs = (torch.where(keep, zc, z_new),
            torch.where(keep, zmax_c, zmax_new),
            torch.where(keep, qx[_C], qx_new),
            torch.where(keep, qy[_C], qy_new))
    if comp is None:
        return outs
    comp_new = torch.where(dry_new, 0.0, comp_new)
    return outs + (torch.where(keep, comp_c, comp_new),)


def muscl_corrector_interior(z, zmax, qx, qy, zb, n, slabs, dt,
                             params: SchemeParams, comp=None):
    """Full-timestep corrector for the two-ring interior of (M, Cc) planes.

    ``slabs`` are the predictor's (M-2, Cc-2) slabs, slab[j, i] belonging
    to cell (j+1, i+1).  Returns the four updated (M-4, Cc-4) interior
    planes (five with ``comp``).  The slabs are padded to full size with
    zeros, which only ring cells read, and ``muscl_corrector_full`` does
    the arithmetic."""
    faces = tuple(FaceExtrap(*(F.pad(a, (1, 1, 1, 1)) for a in slab))
                  for slab in slabs)
    out = muscl_corrector_full(z, zmax, qx, qy, zb, n, faces, dt, params,
                               comp=comp)
    return tuple(a[_C] for a in out)


def muscl_interior(z, zmax, qx, qy, zb, n, dt, params: SchemeParams,
                   comp=None):
    """Predictor + corrector on ring-extended planes (radius 2): input
    (M, Cc) planes, output the four updated (M-4, Cc-4) interior planes
    (five with ``comp``)."""
    slabs = muscl_predictor_interior(z, zmax, qx, qy, zb, dt, params)
    return muscl_corrector_interior(z, zmax, qx, qy, zb, n, slabs, dt,
                                    params, comp=comp)


def with_ring(full, interior, ring):
    """A copy of ``full`` whose cells inside its ``ring``-wide edge ring
    are replaced by ``interior``."""
    out = full.clone()
    out[ring:-ring, ring:-ring] = interior
    return out


def muscl_step(state: FlowState, static: DomainStatic, dt,
               params: SchemeParams, comp=None):
    """One full MUSCL-Hancock step on the whole grid; the two-cell edge
    ring keeps its values.  With ``comp`` returns (FlowState, comp_new)."""
    out = muscl_interior(*state, static.zb, static.manning, dt, params,
                         comp=comp)
    new = FlowState(*(with_ring(a, o, 2) for a, o in zip(state, out[:4])))
    if comp is None:
        return new
    return new, with_ring(comp, out[4], 2)
