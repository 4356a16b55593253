"""Scalar (numpy, float64) oracle for the MUSCL-Hancock step: a frozen
copy of hipims_tpu_torch/ops/oracle_muscl.py at a07496d (the per-cell
transcription of src/Schemes/CLSchemeMUSCLHancock.clc), with the
constants it reads written in.  Test-only, as ``oracle.py``.
"""

from __future__ import annotations

import numpy as np

from .oracle import (DIR_E, DIR_N, DIR_S, DIR_W, VERY_SMALL, _friction,
                     _hllc)

G = 9.81
BETA = 1.0


def _limited(left, center, right):
    rl = center - left
    rr = right - center
    r = 0.0 if abs(rl) <= 0.0 else rr / rl
    phi = max(max(0.0, min(BETA * r, 1.0)), min(r, BETA))
    return phi * rl


def _slopes(sl, zbl, sc, zbc, sr, zbr, vs):
    """(dz, dh, dqx, dqy) between three cells along one axis."""
    if (sl[0] - zbl) < vs or (sr[0] - zbr) < vs:
        return (0.0, 0.0, 0.0, 0.0)
    return (_limited(sl[0], sc[0], sr[0]),
            _limited(sl[0] - zbl, sc[0] - zbc, sr[0] - zbr),
            _limited(sl[2], sc[2], sr[2]),
            _limited(sl[3], sc[3], sr[3]))


def _extrap(z, h, qx, qy, slope, coef):
    return (z + coef * slope[0], h + coef * slope[1],
            qx + coef * slope[2], qy + coef * slope[3])


def _flux_x(face, vs):
    z, h, qx, qy = face
    u = 0.0 if h < vs else qx / h
    p = 0.5 * G * (z * z - 2.0 * (z - h) * z)
    return np.array([qx, u * qx + p, u * qy])


def _flux_y(face, vs):
    z, h, qx, qy = face
    v = 0.0 if h < vs else qy / h
    p = 0.5 * G * (z * z - 2.0 * (z - h) * z)
    return np.array([qy, v * qx, v * qy + p])


def _round(v, vs):
    return 0.0 if abs(v) < vs else v


def predictor_oracle(z, zmax, qx, qy, zb, dt, dx, dy, vs=VERY_SMALL):
    """Face extrapolations for every interior cell; returns four
    (rows, cols, 4) arrays ordered N, E, S, W."""
    rows, cols = z.shape
    faces = [np.zeros((rows, cols, 4)) for _ in range(4)]
    for y in range(1, rows - 1):
        for x in range(1, cols - 1):
            cell = (z[y, x], zmax[y, x], qx[y, x], qy[y, x])
            nbr = {DIR_N: (y + 1, x), DIR_S: (y - 1, x),
                   DIR_E: (y, x + 1), DIR_W: (y, x - 1)}
            states = {d: (z[j, i], zmax[j, i], qx[j, i], qy[j, i])
                      for d, (j, i) in nbr.items()}
            beds = {d: zb[j, i] for d, (j, i) in nbr.items()}
            zbc = zb[y, x]
            hc = cell[0] - zbc

            first_order = (hc < 1e-5 or
                           any(states[d][1] <= -9998.0 for d in range(4)))
            fo_face = (cell[0], hc, cell[2], cell[3])
            if first_order:
                for d in range(4):
                    faces[d][y, x] = fo_face
                continue

            sx = _slopes(states[DIR_W], beds[DIR_W], cell, zbc,
                         states[DIR_E], beds[DIR_E], vs)
            sy = _slopes(states[DIR_S], beds[DIR_S], cell, zbc,
                         states[DIR_N], beds[DIR_N], vs)

            e0 = {DIR_N: _extrap(cell[0], hc, cell[2], cell[3], sy, +0.5),
                  DIR_E: _extrap(cell[0], hc, cell[2], cell[3], sx, +0.5),
                  DIR_S: _extrap(cell[0], hc, cell[2], cell[3], sy, -0.5),
                  DIR_W: _extrap(cell[0], hc, cell[2], cell[3], sx, -0.5)}
            fn = _flux_y(e0[DIR_N], vs)
            fe = _flux_x(e0[DIR_E], vs)
            fs = _flux_y(e0[DIR_S], vs)
            fw = _flux_x(e0[DIR_W], vs)

            src_x = -G * 0.5 * (e0[DIR_E][0] + e0[DIR_W][0]) * (
                (e0[DIR_E][0] - e0[DIR_E][1])
                - (e0[DIR_W][0] - e0[DIR_W][1])) / dx
            src_y = -G * 0.5 * (e0[DIR_N][0] + e0[DIR_S][0]) * (
                (e0[DIR_N][0] - e0[DIR_N][1])
                - (e0[DIR_S][0] - e0[DIR_S][1])) / dy
            d_z = _round((fe[0] - fw[0]) / dx + (fn[0] - fs[0]) / dy, vs)
            d_qx = _round((fe[1] - fw[1]) / dx + (fn[1] - fs[1]) / dy
                          - src_x, vs)
            d_qy = _round((fe[2] - fw[2]) / dx + (fn[2] - fs[2]) / dy
                          - src_y, vs)

            z_h = cell[0] - 0.5 * dt * d_z
            qx_h = cell[2] - 0.5 * dt * d_qx
            qy_h = cell[3] - 0.5 * dt * d_qy
            h_h = z_h - zbc
            faces[DIR_N][y, x] = _extrap(z_h, h_h, qx_h, qy_h, sy, +0.5)
            faces[DIR_E][y, x] = _extrap(z_h, h_h, qx_h, qy_h, sx, +0.5)
            faces[DIR_S][y, x] = _extrap(z_h, h_h, qx_h, qy_h, sy, -0.5)
            faces[DIR_W][y, x] = _extrap(z_h, h_h, qx_h, qy_h, sx, -0.5)
    return faces


def _reconstruct_est(est_l, est_r, raw_l, raw_r, direction, vs):
    """Estimate-based reconstruction (corrector stage)."""
    def side(est):
        zv, hv, qxv, qyv = est
        return dict(z=zv, h=hv, qx=qxv, qy=qyv,
                    u=0.0 if hv <= vs else qxv / hv,
                    v=0.0 if hv <= vs else qyv / hv,
                    zb=zv - hv)
    left = side(est_l)
    right = side(est_r)

    zbm = max(left["zb"], right["zb"])
    datum_z = est_l[0] if direction < DIR_S else est_r[0]
    shift = max(zbm - datum_z, 0.0)

    for s, est in ((left, est_l), (right, est_r)):
        s["h"] = max(est[0] - zbm, 0.0)
        s["z"] = s["h"] + zbm
        s["qx"] = s["h"] * s["u"]
        s["qy"] = s["h"] * s["v"]

    stop = 0
    if direction == DIR_N:
        if left["h"] <= vs and raw_l[3] > 0.0:
            stop += 1
        if right["h"] <= vs and left["v"] < 0.0:
            stop += 1
        if left["h"] <= vs and right["v"] > 0.0:
            stop += 1
    elif direction == DIR_S:
        if right["h"] <= vs and raw_r[3] < 0.0:
            stop += 1
        if right["h"] <= vs and left["v"] < 0.0:
            stop += 1
        if left["h"] <= vs and right["v"] > 0.0:
            stop += 1
    elif direction == DIR_E:
        if left["h"] <= vs and raw_l[2] > 0.0:
            stop += 1
        if right["h"] <= vs and left["u"] < 0.0:
            stop += 1
        if left["h"] <= vs and right["u"] > 0.0:
            stop += 1
    else:
        if right["h"] <= vs and raw_r[2] < 0.0:
            stop += 1
        if right["h"] <= vs and left["u"] < 0.0:
            stop += 1
        if left["h"] <= vs and right["u"] > 0.0:
            stop += 1

    for s in (left, right):
        s["zb"] = zbm - shift
        s["z"] -= shift
    return left, right, stop


def muscl_step_oracle(z, zmax, qx, qy, zb, manning, dt, dx, dy,
                      vs=VERY_SMALL, friction=True):
    """One full MUSCL-Hancock step on the whole grid, cell by cell."""
    rows, cols = z.shape
    out = [a.astype(np.float64).copy() for a in (z, zmax, qx, qy)]
    if dt <= 0.0:
        return tuple(out)

    faces = predictor_oracle(z, zmax, qx, qy, zb, dt, dx, dy, vs)

    for y in range(2, rows - 2):
        for x in range(2, cols - 2):
            cell = (z[y, x], zmax[y, x], qx[y, x], qy[y, x])
            if cell[1] <= -9999.0 or cell[0] == -9999.0:
                continue
            nbr = {DIR_N: (y + 1, x), DIR_S: (y - 1, x),
                   DIR_E: (y, x + 1), DIR_W: (y, x - 1)}
            states = {d: (z[j, i], zmax[j, i], qx[j, i], qy[j, i])
                      for d, (j, i) in nbr.items()}

            dry = int(z[y, x] - zb[y, x] < vs)
            dry += sum(int(states[d][1] < vs) for d in range(4))
            if dry >= 5:
                continue

            opposite = {DIR_N: DIR_S, DIR_S: DIR_N,
                        DIR_E: DIR_W, DIR_W: DIR_E}
            flux = {}
            face_z = {}
            face_zb = {}
            stop = 0
            for d in range(4):
                j, i = nbr[d]
                est_own = tuple(faces[d][y, x])
                est_far = tuple(faces[opposite[d]][j, i])
                if d in (DIR_N, DIR_E):
                    l, r, st = _reconstruct_est(est_own, est_far, cell,
                                                states[d], d, vs)
                    face_z[d], face_zb[d] = r["z"], r["zb"]
                else:
                    l, r, st = _reconstruct_est(est_far, est_own, states[d],
                                                cell, d, vs)
                    face_z[d], face_zb[d] = l["z"], l["zb"]
                stop += st
                flux[d] = _hllc(d, l, r, vs)

            src_x = -G * 0.5 * (face_z[DIR_E] + face_z[DIR_W]) \
                * (face_zb[DIR_E] - face_zb[DIR_W]) / dx
            src_y = -G * 0.5 * (face_z[DIR_N] + face_z[DIR_S]) \
                * (face_zb[DIR_N] - face_zb[DIR_S]) / dy

            d_z = _round((flux[DIR_E][0] - flux[DIR_W][0]) / dx
                         + (flux[DIR_N][0] - flux[DIR_S][0]) / dy, vs)
            d_qx = _round((flux[DIR_E][1] - flux[DIR_W][1]) / dx
                          + (flux[DIR_N][1] - flux[DIR_S][1]) / dy
                          - src_x, vs)
            d_qy = _round((flux[DIR_E][2] - flux[DIR_W][2]) / dx
                          + (flux[DIR_N][2] - flux[DIR_S][2]) / dy
                          - src_y, vs)

            cz, czmax, cqx, cqy = cell
            if stop > 0:
                cqx = 0.0
                cqy = 0.0
            cz = cz - dt * d_z
            cqx = cqx - dt * d_qx
            cqy = cqy - dt * d_qy

            if friction:
                cqx, cqy = _friction(cz, cqx, cqy, zb[y, x],
                                     manning[y, x], dt, vs)

            if cz - zb[y, x] < vs:
                cz = zb[y, x]
            if cz > czmax and czmax > -9990.0:
                czmax = cz

            out[0][y, x] = cz
            out[1][y, x] = czmax
            out[2][y, x] = cqx
            out[3][y, x] = cqy

    return tuple(out)
