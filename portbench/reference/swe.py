"""Plain PyTorch float64 reference of the HiPIMS shallow-water step.

A whole-grid transcription of the per-cell oracles beside this file
(``oracle.py``, ``oracle_muscl.py``: the reference's kernel semantics,
src/Schemes/CLSchemeGodunov.clc, CLSchemeMUSCLHancock.clc,
src/Solvers/CLSolverHLLC.clc), written with whole-array operations so that
it runs at a deployment's grid size on the card.  Every cell evaluates its
own four interfaces, with its own datum shift, as the oracles do; the
operations are the oracles' in their order, so on a small grid the two
agree to round-off (tests/test_portbench_reference.py).  The time
controller (src/Schemes/CLDynamicTimestep.clc tst_Advance_Normal), the
CFL reduction (tst_Reduce) and the uniform rain and loss
(src/Boundaries/CLBoundaries.clc bdy_Uniform) are transcribed here from
the same semantics, and the gridded rain (bdy_Gridded) from the same
source and the program's documented mapping of a cell onto the coarse
grid; the time controller's hydrological interval drops no forcing
(``advance``).

Nothing here imports the program under test.  Planes are (rows, cols),
row 0 south.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

G = 9.81
NODATA = -9999.0
CLOSED_EDGE_ELEVATION = 9999.9
BETA = 1.0                        # MINMOD limiter coefficient
TIMESTEP_MINIMUM = 1e-10
TIMESTEP_MAXIMUM = 15.0
TIMESTEP_EARLY_LIMIT = 0.1
TIMESTEP_EARLY_LIMIT_DURATION = 60.0
TIMESTEP_START_MINIMUM = 1e-10
TIMESTEP_START_MINIMUM_DURATION = 1.0
TIMESTEP_HYDROLOGICAL = 1.0

N, E, S, W = 0, 1, 2, 3


class Side(NamedTuple):
    z: torch.Tensor
    h: torch.Tensor
    qx: torch.Tensor
    qy: torch.Tensor
    zb: torch.Tensor


def _div_or_zero(num, den, dry):
    return torch.where(dry, 0.0, num / torch.where(dry, 1.0, den))


def _reconstruct(zl, qxl, qyl, zbl, zr, qxr, qyr, zbr, d, vs):
    """The depth-positivity reconstruction of one interface from one
    cell's side (oracle.py ``_reconstruct``); returns (left, right,
    stop)."""
    hl = zl - zbl
    hr = zr - zbr
    ul = _div_or_zero(qxl, hl, hl < vs)
    vl = _div_or_zero(qyl, hl, hl < vs)
    ur = _div_or_zero(qxr, hr, hr < vs)
    vr = _div_or_zero(qyr, hr, hr < vs)
    zbm = torch.maximum(zbl, zbr)
    datum = zl if d in (N, E) else zr
    shift = torch.clamp(zbm - datum, min=0.0)
    hl2 = torch.clamp(zl - zbm, min=0.0)
    hr2 = torch.clamp(zr - zbm, min=0.0)
    if d == N:
        stop = ((hl2 <= vs) & (qyl > 0.0)) | ((hr2 <= vs) & (vl < 0.0)) \
            | ((hl2 <= vs) & (vr > 0.0))
    elif d == S:
        stop = ((hr2 <= vs) & (qyr < 0.0)) | ((hr2 <= vs) & (vl < 0.0)) \
            | ((hl2 <= vs) & (vr > 0.0))
    elif d == E:
        stop = ((hl2 <= vs) & (qxl > 0.0)) | ((hr2 <= vs) & (ul < 0.0)) \
            | ((hl2 <= vs) & (ur > 0.0))
    else:
        stop = ((hr2 <= vs) & (qxr < 0.0)) | ((hr2 <= vs) & (ul < 0.0)) \
            | ((hl2 <= vs) & (ur > 0.0))
    zb_s = zbm - shift
    left = Side((hl2 + zbm) - shift, hl2, hl2 * ul, hl2 * vl, zb_s)
    right = Side((hr2 + zbm) - shift, hr2, hr2 * ur, hr2 * vr, zb_s)
    return left, right, stop


def _reconstruct_est(el, er, raw_l, raw_r, d, vs):
    """The corrector's estimate-based reconstruction (oracle_muscl.py
    ``_reconstruct_est``): ``el``/``er`` are (z, h, qx, qy) face
    estimates, ``raw_*`` the cells' (qx, qy)."""
    zl, hl, qxl, qyl = el
    zr, hr, qxr, qyr = er
    ul = _div_or_zero(qxl, hl, hl <= vs)
    vl = _div_or_zero(qyl, hl, hl <= vs)
    ur = _div_or_zero(qxr, hr, hr <= vs)
    vr = _div_or_zero(qyr, hr, hr <= vs)
    zbm = torch.maximum(zl - hl, zr - hr)
    datum = zl if d in (N, E) else zr
    shift = torch.clamp(zbm - datum, min=0.0)
    hl2 = torch.clamp(zl - zbm, min=0.0)
    hr2 = torch.clamp(zr - zbm, min=0.0)
    if d == N:
        stop = ((hl2 <= vs) & (raw_l[1] > 0.0)) | ((hr2 <= vs) & (vl < 0.0)) \
            | ((hl2 <= vs) & (vr > 0.0))
    elif d == S:
        stop = ((hr2 <= vs) & (raw_r[1] < 0.0)) | ((hr2 <= vs) & (vl < 0.0)) \
            | ((hl2 <= vs) & (vr > 0.0))
    elif d == E:
        stop = ((hl2 <= vs) & (raw_l[0] > 0.0)) | ((hr2 <= vs) & (ul < 0.0)) \
            | ((hl2 <= vs) & (ur > 0.0))
    else:
        stop = ((hr2 <= vs) & (raw_r[0] < 0.0)) | ((hr2 <= vs) & (ul < 0.0)) \
            | ((hl2 <= vs) & (ur > 0.0))
    zb_s = zbm - shift
    left = Side((hl2 + zbm) - shift, hl2, hl2 * ul, hl2 * vl, zb_s)
    right = Side((hr2 + zbm) - shift, hr2, hr2 * ur, hr2 * vr, zb_s)
    return left, right, stop


def _hllc(d, left: Side, right: Side, vs):
    """HLLC flux (mass, x momentum, y momentum) of one interface
    (oracle.py ``_hllc``)."""
    along_x = d in (E, W)
    hl, hr = left.h, right.h
    zsum = left.z + right.z
    p_dry = (0.5 * G) * (0.25 * zsum * zsum - left.zb * zsum)
    both_dry = (hl < vs) & (hr < vs)

    ul = _div_or_zero(left.qx, hl, hl < vs)
    vl = _div_or_zero(left.qy, hl, hl < vs)
    ur = _div_or_zero(right.qx, hr, hr < vs)
    vr = _div_or_zero(right.qy, hr, hr < vs)
    vel_l, vel_r = (ul, ur) if along_x else (vl, vr)
    dis_l, dis_r = ((left.qx, right.qx) if along_x
                    else (left.qy, right.qy))
    a_l = torch.sqrt(G * hl)
    a_r = torch.sqrt(G * hr)
    a_avg = 0.5 * (a_l + a_r)
    t = a_avg + 0.25 * (vel_l - vel_r)
    h_star = t * t / G
    u_star = 0.5 * (vel_l + vel_r) + a_l - a_r
    a_star = torch.sqrt(G * h_star)
    s_l = torch.where(hl < vs, vel_r - 2.0 * a_r,
                      torch.minimum(vel_l - a_l, u_star - a_star))
    s_r = torch.where(hr < vs, vel_l + 2.0 * a_l,
                      torch.maximum(vel_r + a_r, u_star + a_star))
    den = hr * (vel_r - s_r) - hl * (vel_l - s_l)
    num = s_l * hr * (vel_r - s_r) - s_r * hl * (vel_l - s_l)
    s_m = torch.where(den == 0.0, 0.0,
                      num / torch.where(den == 0.0, 1.0, den))

    p_l = (0.5 * G) * (left.z * left.z - 2.0 * left.zb * left.z)
    p_r = (0.5 * G) * (right.z * right.z - 2.0 * left.zb * right.z)
    if along_x:
        fl = (dis_l, vel_l * left.qx + p_l, vel_l * left.qy)
        fr = (dis_r, vel_r * right.qx + p_r, vel_r * right.qy)
        fm_l, fm_r = fl[1], fr[1]
    else:
        fl = (dis_l, vel_l * left.qx, vel_l * left.qy + p_l)
        fr = (dis_r, vel_r * right.qx, vel_r * right.qy + p_r)
        fm_l, fm_r = fl[2], fr[2]
    span = s_r - s_l
    f1 = (s_r * fl[0] - s_l * fr[0] + s_l * s_r * (right.z - left.z)) / span
    f2 = (s_r * fm_l - s_l * fm_r + s_l * s_r * (dis_r - dis_l)) / span
    upwind = s_m >= 0.0
    if along_x:
        star = (f1, f2, f1 * torch.where(upwind, vl, vr))
    else:
        star = (f1, f1 * torch.where(upwind, ul, ur), f2)
    use_l = s_l >= 0.0
    use_r = (s_l < 0.0) & (s_r < 0.0)
    zero = torch.zeros_like(p_dry)
    dry = (zero, p_dry, zero) if along_x else (zero, zero, p_dry)
    return tuple(
        torch.where(both_dry, dk,
                    torch.where(use_l, lk, torch.where(use_r, rk, sk)))
        for dk, lk, rk, sk in zip(dry, fl, fr, star))


def _friction(z, qx, qy, zb, n, dt, vs):
    """Implicit Manning friction (oracle.py ``_friction``)."""
    h = z - zb
    q = torch.sqrt(qx * qx + qy * qy)
    skip = (h < vs) | (q < vs)
    hs = torch.where(skip, 1.0, h)
    qs = torch.where(skip, 1.0, q)
    cf = G * n * n / torch.pow(hs, 1.0 / 3.0)
    k = cf / (hs * hs)
    sfx = (-k) * qx * qs
    sfy = (-k) * qy * qs
    dx_den = 1.0 + dt * k * (2.0 * qx * qx + qy * qy) / qs
    dy_den = 1.0 + dt * k * (qx * qx + 2.0 * qy * qy) / qs
    fx = sfx / dx_den
    fy = sfy / dy_den
    lim_x = -qx / dt
    lim_y = -qy / dt
    fx = torch.where(qx >= 0.0, torch.maximum(fx, lim_x),
                     torch.minimum(fx, lim_x))
    fy = torch.where(qy >= 0.0, torch.maximum(fy, lim_y),
                     torch.minimum(fy, lim_y))
    return (torch.where(skip, qx, qx + dt * fx),
            torch.where(skip, qy, qy + dt * fy))


def _round(v, vs):
    return torch.where(torch.abs(v) < vs, 0.0, v)


def _update(cell, zbc, nc, fluxes, faces, dt, dx, dy, vs, friction, stop,
            clamp_first):
    """A cell's update from its four interface fluxes (N, E, S, W) and the
    neighbour-side face levels and beds the bed-slope source reads."""
    cz, czmax, cqx, cqy = cell
    fn, fe, fs, fw = fluxes
    (zn, zbn), (ze, zbe), (zs, zbs), (zw, zbw) = faces
    src_x = (-G * 0.5) * (ze + zw) * (zbe - zbw) / dx
    src_y = (-G * 0.5) * (zn + zs) * (zbn - zbs) / dy
    d_z = _round((fe[0] - fw[0]) / dx + (fn[0] - fs[0]) / dy, vs)
    d_qx = _round((fe[1] - fw[1]) / dx + (fn[1] - fs[1]) / dy - src_x, vs)
    d_qy = _round((fe[2] - fw[2]) / dx + (fn[2] - fs[2]) / dy - src_y, vs)
    qx0 = torch.where(stop, 0.0, cqx)
    qy0 = torch.where(stop, 0.0, cqy)
    z1 = cz - dt * d_z
    qx1 = qx0 - dt * d_qx
    qy1 = qy0 - dt * d_qy
    if friction:
        qx1, qy1 = _friction(z1, qx1, qy1, zbc, nc, dt, vs)
    if clamp_first:                 # MUSCL corrector: clamp, then zmax
        z1 = torch.where(z1 - zbc < vs, zbc, z1)
        zmax1 = torch.where((z1 > czmax) & (czmax > -9990.0), z1, czmax)
    else:                           # first order: zmax, then clamp
        zmax1 = torch.where((z1 > czmax) & (czmax > -9990.0), z1, czmax)
        z1 = torch.where(z1 - zbc < vs, zbc, z1)
    return z1, zmax1, qx1, qy1


def _shifted(a, ring):
    """(cell, N, E, S, W) views of ``a`` for the cells ``ring`` or more
    from the edge."""
    r = ring
    return (a[r:-r, r:-r], a[r + 1:a.shape[0] - r + 1, r:-r],
            a[r:-r, r + 1:a.shape[1] - r + 1], a[r - 1:-r - 1, r:-r],
            a[r:-r, r - 1:-r - 1])


def _with_interior(full, interior, ring):
    out = full.clone()
    out[ring:-ring, ring:-ring] = interior
    return out


def godunov_step(z, zmax, qx, qy, zb, n, dt, dx, dy, vs, friction=True):
    """One first-order Godunov step on the whole grid (oracle.py
    ``godunov_step_oracle``); the one-cell edge ring keeps its values."""
    cz, nz, ez, sz, wz = _shifted(z, 1)
    czmax = zmax[1:-1, 1:-1]
    cqx, nqx, eqx, sqx, wqx = _shifted(qx, 1)
    cqy, nqy, eqy, sqy, wqy = _shifted(qy, 1)
    czb, nzb, ezb, szb, wzb = _shifted(zb, 1)
    nc = n[1:-1, 1:-1]

    ln, rn, st_n = _reconstruct(cz, cqx, cqy, czb, nz, nqx, nqy, nzb, N, vs)
    fn = _hllc(N, ln, rn, vs)
    ls, rs, st_s = _reconstruct(sz, sqx, sqy, szb, cz, cqx, cqy, czb, S, vs)
    fs = _hllc(S, ls, rs, vs)
    le, re, st_e = _reconstruct(cz, cqx, cqy, czb, ez, eqx, eqy, ezb, E, vs)
    fe = _hllc(E, le, re, vs)
    lw, rw, st_w = _reconstruct(wz, wqx, wqy, wzb, cz, cqx, cqy, czb, W, vs)
    fw = _hllc(W, lw, rw, vs)
    stop = st_n | st_s | st_e | st_w
    new = _update((cz, czmax, cqx, cqy), czb, nc, (fn, fe, fs, fw),
                  ((rn.z, rn.zb), (re.z, re.zb), (ls.z, ls.zb),
                   (lw.z, lw.zb)),
                  dt, dx, dy, vs, friction, stop, clamp_first=False)

    dry = (z - zb) < vs
    dry5 = (dry[1:-1, 1:-1].int() + dry[2:, 1:-1].int() + dry[:-2, 1:-1].int()
            + dry[1:-1, 2:].int() + dry[1:-1, :-2].int()) >= 5
    keep = (czmax <= NODATA) | (cz == NODATA) | dry5 | (dt <= 0.0)
    old = (cz, czmax, cqx, cqy)
    return tuple(_with_interior(full, torch.where(keep, o, v), 1)
                 for full, o, v in zip((z, zmax, qx, qy), old, new))


def _limited(lft, ctr, rgt):
    rl = ctr - lft
    rr = rgt - ctr
    r = torch.where(torch.abs(rl) <= 0.0, 0.0,
                    rr / torch.where(torch.abs(rl) <= 0.0, 1.0, rl))
    phi = torch.maximum(
        torch.clamp(torch.minimum(BETA * r, torch.ones_like(r)), min=0.0),
        torch.clamp(r, max=BETA))
    return phi * rl


def _slopes(lft, zbl, ctr, zbc, rgt, zbr, vs):
    """(dz, dh, dqx, dqy) along one axis (oracle_muscl.py ``_slopes``);
    each side is (z, qx, qy)."""
    flat = ((lft[0] - zbl) < vs) | ((rgt[0] - zbr) < vs)
    out = (_limited(lft[0], ctr[0], rgt[0]),
           _limited(lft[0] - zbl, ctr[0] - zbc, rgt[0] - zbr),
           _limited(lft[1], ctr[1], rgt[1]),
           _limited(lft[2], ctr[2], rgt[2]))
    return tuple(torch.where(flat, 0.0, s) for s in out)


def _extrap(face, slope, coef):
    return tuple(v + coef * s for v, s in zip(face, slope))


def _flux(face, along_x, vs):
    z, h, qx, qy = face
    p = (0.5 * G) * (z * z - 2.0 * (z - h) * z)
    if along_x:
        u = _div_or_zero(qx, h, h < vs)
        return (qx, u * qx + p, u * qy)
    v = _div_or_zero(qy, h, h < vs)
    return (qy, v * qx, v * qy + p)


def muscl_predict(z, zmax, qx, qy, zb, dt, dx, dy, vs):
    """Face estimates (z, h, qx, qy) of every cell one or more from the
    edge, ordered N, E, S, W, each a tuple of full-grid planes with zeros
    on the edge ring (oracle_muscl.py ``predictor_oracle``)."""
    cz, nz, ez, sz, wz = _shifted(z, 1)
    _, nzm, ezm, szm, wzm = _shifted(zmax, 1)
    cqx, nqx, eqx, sqx, wqx = _shifted(qx, 1)
    cqy, nqy, eqy, sqy, wqy = _shifted(qy, 1)
    czb, nzb, ezb, szb, wzb = _shifted(zb, 1)
    hc = cz - czb
    first = (hc < 1e-5) | (nzm <= -9998.0) | (ezm <= -9998.0) \
        | (szm <= -9998.0) | (wzm <= -9998.0)

    sx = _slopes((wz, wqx, wqy), wzb, (cz, cqx, cqy), czb,
                 (ez, eqx, eqy), ezb, vs)
    sy = _slopes((sz, sqx, sqy), szb, (cz, cqx, cqy), czb,
                 (nz, nqx, nqy), nzb, vs)
    base = (cz, hc, cqx, cqy)
    e0 = {N: _extrap(base, sy, 0.5), E: _extrap(base, sx, 0.5),
          S: _extrap(base, sy, -0.5), W: _extrap(base, sx, -0.5)}
    fn = _flux(e0[N], False, vs)
    fe = _flux(e0[E], True, vs)
    fs = _flux(e0[S], False, vs)
    fw = _flux(e0[W], True, vs)
    src_x = (-G * 0.5) * (e0[E][0] + e0[W][0]) * (
        (e0[E][0] - e0[E][1]) - (e0[W][0] - e0[W][1])) / dx
    src_y = (-G * 0.5) * (e0[N][0] + e0[S][0]) * (
        (e0[N][0] - e0[N][1]) - (e0[S][0] - e0[S][1])) / dy
    d_z = _round((fe[0] - fw[0]) / dx + (fn[0] - fs[0]) / dy, vs)
    d_qx = _round((fe[1] - fw[1]) / dx + (fn[1] - fs[1]) / dy - src_x, vs)
    d_qy = _round((fe[2] - fw[2]) / dx + (fn[2] - fs[2]) / dy - src_y, vs)
    half = 0.5 * dt
    z_h = cz - half * d_z
    half_state = (z_h, z_h - czb, cqx - half * d_qx, cqy - half * d_qy)
    faces = []
    for d, slope, coef in ((N, sy, 0.5), (E, sx, 0.5), (S, sy, -0.5),
                           (W, sx, -0.5)):
        est = _extrap(half_state, slope, coef)
        faces.append(tuple(
            _with_interior(torch.zeros_like(z), torch.where(first, b, v), 1)
            for b, v in zip(base, est)))
    return faces


def muscl_step(z, zmax, qx, qy, zb, n, dt, dx, dy, vs, friction=True):
    """One MUSCL-Hancock step on the whole grid (oracle_muscl.py
    ``muscl_step_oracle``); the two-cell edge ring keeps its values."""
    faces = muscl_predict(z, zmax, qx, qy, zb, dt, dx, dy, vs)
    r = 2
    cz = z[r:-r, r:-r]
    czmax = zmax[r:-r, r:-r]
    czb = zb[r:-r, r:-r]
    _, nqx, eqx, sqx, wqx = _shifted(qx, r)
    _, nqy, eqy, sqy, wqy = _shifted(qy, r)
    cqx, cqy = qx[r:-r, r:-r], qy[r:-r, r:-r]
    _, nzm, ezm, szm, wzm = _shifted(zmax, r)
    own = {d: tuple(p[r:-r, r:-r] for p in faces[d]) for d in (N, E, S, W)}
    far = {N: tuple(p[r + 1:-r + 1, r:-r] for p in faces[S]),
           S: tuple(p[r - 1:-r - 1, r:-r] for p in faces[N]),
           E: tuple(p[r:-r, r + 1:-r + 1] for p in faces[W]),
           W: tuple(p[r:-r, r - 1:-r - 1] for p in faces[E])}
    raw_c = (cqx, cqy)
    raw = {N: (nqx, nqy), E: (eqx, eqy), S: (sqx, sqy), W: (wqx, wqy)}
    flux, face, stop = {}, {}, None
    for d in (N, E, S, W):
        if d in (N, E):
            lft, rgt, st = _reconstruct_est(own[d], far[d], raw_c, raw[d],
                                            d, vs)
            face[d] = (rgt.z, rgt.zb)
        else:
            lft, rgt, st = _reconstruct_est(far[d], own[d], raw[d], raw_c,
                                            d, vs)
            face[d] = (lft.z, lft.zb)
        flux[d] = _hllc(d, lft, rgt, vs)
        stop = st if stop is None else stop | st
    new = _update((cz, czmax, cqx, cqy), czb, n[r:-r, r:-r],
                  (flux[N], flux[E], flux[S], flux[W]),
                  (face[N], face[E], face[S], face[W]),
                  dt, dx, dy, vs, friction, stop, clamp_first=True)
    dry5 = (((cz - czb) < vs).int() + (nzm < vs).int() + (ezm < vs).int()
            + (szm < vs).int() + (wzm < vs).int()) >= 5
    keep = (czmax <= NODATA) | (cz == NODATA) | dry5 | (dt <= 0.0)
    old = (cz, czmax, cqx, cqy)
    return tuple(_with_interior(full, torch.where(keep, o, v), r)
                 for full, o, v in zip((z, zmax, qx, qy), old, new))


def max_wave_speed(z, zmax, qx, qy, zb, quite_small):
    """The CFL reduction (tst_Reduce): the largest max(|qx|, |qy|) / h +
    sqrt(g h) over wet enabled cells, as a 0-d tensor."""
    h = z - zb
    wet = (h > quite_small) & (zmax > NODATA)
    hs = torch.where(wet, h, 1.0)
    speed = torch.maximum(torch.abs(qx), torch.abs(qy)) / hs \
        + torch.sqrt(G * torch.clamp(h, min=0.0))
    return torch.amax(torch.where(wet, speed, 0.0))


class Carry(NamedTuple):
    t: torch.Tensor
    dt: torch.Tensor
    t_hydro: torch.Tensor
    steps: torch.Tensor
    idle: torch.Tensor


def advance(c: Carry, speed, sync, end, dx, courant) -> Carry:
    """Move the clock by the step just taken and set the next dt
    (tst_Advance_Normal): CFL limit, start-up floor, global minimum, the
    suspension at the sync time, the early cap, the end time, the global
    maximum, in that order.  The hydrological interval ``t_hydro`` is the
    time since the boundaries last forced, so the forcing applied over a
    run adds up to the simulated time (the reference code resets it on
    an idle step, and at ``>`` where the boundaries force at ``>=``: both
    drop forcing, which this reference does not copy)."""
    dt_eff = torch.clamp(c.dt, min=0.0)
    t = c.t + dt_eff
    stepped = dt_eff > 0.0
    # The seconds not yet forced: reset to the step just taken where the
    # boundaries forced (at >= TIMESTEP_HYDROLOGICAL, their own gate, on
    # a step that moved), kept whole on an idle step, so no forcing is
    # dropped at a suspension.
    t_hydro = torch.where(
        stepped, torch.where(c.t_hydro >= TIMESTEP_HYDROLOGICAL, dt_eff,
                             c.t_hydro + dt_eff), c.t_hydro)
    min_time = dx / speed
    min_time = torch.where((t < TIMESTEP_START_MINIMUM_DURATION)
                           & (min_time < TIMESTEP_START_MINIMUM),
                           TIMESTEP_START_MINIMUM, min_time)
    dt = courant * min_time
    dt = torch.where((dt > 0.0) & (dt < TIMESTEP_MINIMUM), TIMESTEP_MINIMUM,
                     dt)
    remaining = sync - t
    dt = torch.where(t + dt >= sync,
                     torch.where(remaining > 1e-10, remaining, -dt), dt)
    dt = torch.where((t < TIMESTEP_EARLY_LIMIT_DURATION)
                     & (dt > TIMESTEP_EARLY_LIMIT), TIMESTEP_EARLY_LIMIT, dt)
    dt = torch.where(t + dt > end, end - t, dt)
    dt = torch.where(dt > TIMESTEP_MAXIMUM, TIMESTEP_MAXIMUM, dt)
    return Carry(t, dt, t_hydro, c.steps + stepped.long(),
                 c.idle + (~stepped).long())


def uniform_delta(z, zb, values, interval, is_loss, t, seconds):
    """What domain-wide rain or loss adds to ``z`` over ``seconds``: the
    rate (mm/h) of the record t / interval (truncated); a loss stops at
    the bed."""
    idx = torch.clamp((t / interval).long(), 0, values.shape[0] - 1)
    rate = values[idx] / 3_600_000.0 * seconds
    if is_loss:
        return torch.maximum(zb - z, -rate)
    return rate.expand_as(z)


def uniform_forcing(z, zmax, zb, mask, values, interval, length, is_loss,
                    t, dt, t_hydro):
    """Domain-wide rain or loss (bdy_Uniform): ``uniform_delta`` over the
    hydrological interval, once that interval reaches
    TIMESTEP_HYDROLOGICAL, on a step that moves, before the series'
    ``length``, on enabled cells inside ``mask``."""
    delta = uniform_delta(z, zb, values, interval, is_loss, t, t_hydro)
    live = (t_hydro >= TIMESTEP_HYDROLOGICAL) & (dt > 0.0) & (t < length)
    return z + torch.where(live & (zmax > NODATA) & mask, delta, 0.0)


def gridded_delta(frames, rows, cols, interval, t, seconds):
    """What gridded (radar) rain adds over ``seconds``: the frame (mm/h)
    of the record t / interval (truncated), each cell under the coarse
    cell that ``rows`` and ``cols`` map its row and column to.
    ``frames`` is (T, grid rows, grid cols), row 0 south; the caller
    makes sure that no time asked for lies past the last frame."""
    ti = (t / interval).long().view(1)
    frame = frames.index_select(0, ti)[0]
    return frame.index_select(0, rows).index_select(1, cols) \
        / 3_600_000.0 * seconds


def gridded_forcing(z, zmax, zb, mask, frames, rows, cols, interval, t, dt,
                    t_hydro):
    """Gridded (radar) rain (bdy_Gridded): ``gridded_delta`` over the
    hydrological interval, once that interval reaches
    TIMESTEP_HYDROLOGICAL, on a step that moves, on enabled cells inside
    ``mask``."""
    rate = gridded_delta(frames, rows, cols, interval, t, t_hydro)
    live = (t_hydro >= TIMESTEP_HYDROLOGICAL) & (dt > 0.0)
    forced = live & (zmax > NODATA) & (z != NODATA) & mask
    return z + torch.where(forced, rate, 0.0)
