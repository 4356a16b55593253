"""Scalar (numpy, float64) oracle for the Godunov step: a frozen copy of
hipims_tpu_torch/ops/oracle.py at a07496d (itself the JAX package's
per-cell transcription of src/Schemes/CLSchemeGodunov.clc and
src/Solvers/CLSolverHLLC.clc), with the constants it reads written in.
The benchmark's tests hold ``swe.py`` to it; it is never timed.
"""

from __future__ import annotations

import numpy as np


G = 9.81
VERY_SMALL = 1e-10

# Direction codes as in the reference (N=0, E=1, S=2, W=3).
DIR_N, DIR_E, DIR_S, DIR_W = 0, 1, 2, 3


def _reconstruct(state_l, zb_l, state_r, zb_r, direction, vs):
    """Depth-positivity reconstruction of one interface, from one cell's
    perspective.  state_* = (z, zmax, qx, qy).  Returns (left, right, stop)
    where each side is a dict with keys z, h, qx, qy, u, v, zb."""
    zl, _, qxl, qyl = state_l
    zr, _, qxr, qyr = state_r
    hl = zl - zb_l
    hr = zr - zb_r
    left = dict(z=zl, h=hl, qx=qxl, qy=qyl,
                u=0.0 if hl < vs else qxl / hl,
                v=0.0 if hl < vs else qyl / hl, zb=zb_l)
    right = dict(z=zr, h=hr, qx=qxr, qy=qyr,
                 u=0.0 if hr < vs else qxr / hr,
                 v=0.0 if hr < vs else qyr / hr, zb=zb_r)

    zbm = max(zb_l, zb_r)
    datum_z = zl if direction < DIR_S else zr
    shift = max(zbm - datum_z, 0.0)

    for side in (left, right):
        side["h"] = max(side["z"] - zbm, 0.0)
        side["z"] = side["h"] + zbm
        side["qx"] = side["h"] * side["u"]
        side["qy"] = side["h"] * side["v"]

    stop = 0
    if direction == DIR_N:
        if left["h"] <= vs and state_l[3] > 0.0:
            stop += 1
        if right["h"] <= vs and left["v"] < 0.0:
            stop += 1
            left["v"] = 0.0
        if left["h"] <= vs and right["v"] > 0.0:
            stop += 1
            right["v"] = 0.0
    elif direction == DIR_S:
        if right["h"] <= vs and state_r[3] < 0.0:
            stop += 1
        if right["h"] <= vs and left["v"] < 0.0:
            stop += 1
            left["v"] = 0.0
        if left["h"] <= vs and right["v"] > 0.0:
            stop += 1
            right["v"] = 0.0
    elif direction == DIR_E:
        if left["h"] <= vs and state_l[2] > 0.0:
            stop += 1
        if right["h"] <= vs and left["u"] < 0.0:
            stop += 1
            left["u"] = 0.0
        if left["h"] <= vs and right["u"] > 0.0:
            stop += 1
            right["u"] = 0.0
    else:  # DIR_W
        if right["h"] <= vs and state_r[2] < 0.0:
            stop += 1
        if right["h"] <= vs and left["u"] < 0.0:
            stop += 1
            left["u"] = 0.0
        if left["h"] <= vs and right["u"] > 0.0:
            stop += 1
            right["u"] = 0.0

    for side in (left, right):
        side["zb"] = zbm - shift
        side["z"] -= shift

    return left, right, stop


def _hllc(direction, left, right, vs):
    """HLLC flux (mass, fQx, fQy) for one reconstructed interface."""
    dir_x = 1.0 if direction in (DIR_E, DIR_W) else 0.0
    dir_y = 1.0 - dir_x

    if left["h"] < vs and right["h"] < vs:
        zsum = left["z"] + right["z"]
        p = 0.5 * G * (0.25 * zsum * zsum - left["zb"] * zsum)
        return np.array([0.0, dir_x * p, dir_y * p])

    for side in (left, right):
        side["u"] = 0.0 if side["h"] < vs else side["qx"] / side["h"]
        side["v"] = 0.0 if side["h"] < vs else side["qy"] / side["h"]

    vel_l = dir_x * left["u"] + dir_y * left["v"]
    vel_r = dir_x * right["u"] + dir_y * right["v"]
    dis_l = dir_x * left["qx"] + dir_y * left["qy"]
    dis_r = dir_x * right["qx"] + dir_y * right["qy"]
    a_l = np.sqrt(G * left["h"])
    a_r = np.sqrt(G * right["h"])

    a_avg = 0.5 * (a_l + a_r)
    h_star = (a_avg + 0.25 * (vel_l - vel_r)) ** 2 / G
    u_star = 0.5 * (vel_l + vel_r) + a_l - a_r
    a_star = np.sqrt(G * h_star)

    if left["h"] < vs:
        s_l = vel_r - 2.0 * a_r
    else:
        s_l = min(vel_l - a_l, u_star - a_star)
    if right["h"] < vs:
        s_r = vel_l + 2.0 * a_l
    else:
        s_r = max(vel_r + a_r, u_star + a_star)
    den = right["h"] * (vel_r - s_r) - left["h"] * (vel_l - s_l)
    s_m = 0.0 if den == 0.0 else (
        s_l * right["h"] * (vel_r - s_r) - s_r * left["h"] * (vel_l - s_l)
    ) / den

    p_l = 0.5 * G * (left["z"] ** 2 - 2.0 * left["zb"] * left["z"])
    p_r = 0.5 * G * (right["z"] ** 2 - 2.0 * left["zb"] * right["z"])
    flux_l = np.array([dis_l,
                       vel_l * left["qx"] + dir_x * p_l,
                       vel_l * left["qy"] + dir_y * p_l])
    flux_r = np.array([dis_r,
                       vel_r * right["qx"] + dir_x * p_r,
                       vel_r * right["qy"] + dir_y * p_r])

    if s_l >= 0.0:
        return flux_l
    if s_l < 0.0 and s_r < 0.0:
        return flux_r

    fm_l = dir_x * flux_l[1] + dir_y * flux_l[2]
    fm_r = dir_x * flux_r[1] + dir_y * flux_r[2]
    f1_m = (s_r * flux_l[0] - s_l * flux_r[0]
            + s_l * s_r * (right["z"] - left["z"])) / (s_r - s_l)
    f2_m = (s_r * fm_l - s_l * fm_r + s_l * s_r * (dis_r - dis_l)) / (s_r - s_l)

    if s_m >= 0.0:
        return np.array([f1_m,
                         dir_x * f2_m + dir_y * f1_m * left["u"],
                         dir_x * f1_m * left["v"] + dir_y * f2_m])
    return np.array([f1_m,
                     dir_x * f2_m + dir_y * f1_m * right["u"],
                     dir_x * f1_m * right["v"] + dir_y * f2_m])


def _friction(z, qx, qy, zb, n, dt, vs):
    h = z - zb
    q = np.sqrt(qx * qx + qy * qy)
    if h < vs or q < vs:
        return qx, qy
    cf = G * n * n / h ** (1.0 / 3.0)
    sfx = (-cf / (h * h)) * qx * q
    sfy = (-cf / (h * h)) * qy * q
    dx_den = 1.0 + dt * (cf / (h * h)) * (2.0 * qx * qx + qy * qy) / q
    dy_den = 1.0 + dt * (cf / (h * h)) * (qx * qx + 2.0 * qy * qy) / q
    fx = sfx / dx_den
    fy = sfy / dy_den
    if qx >= 0.0:
        fx = max(fx, -qx / dt)
    else:
        fx = min(fx, -qx / dt)
    if qy >= 0.0:
        fy = max(fy, -qy / dt)
    else:
        fy = min(fy, -qy / dt)
    return qx + dt * fx, qy + dt * fy


def godunov_step_oracle(z, zmax, qx, qy, zb, manning, dt, dx, dy,
                        vs=VERY_SMALL, friction=True):
    """One first-order step on the whole grid, cell by cell."""
    rows, cols = z.shape
    out = [a.astype(np.float64).copy() for a in (z, zmax, qx, qy)]
    if dt <= 0.0:
        return tuple(out)

    for y in range(1, rows - 1):
        for x in range(1, cols - 1):
            cell = (z[y, x], zmax[y, x], qx[y, x], qy[y, x])
            if cell[1] <= -9999.0 or cell[0] == -9999.0:
                continue
            nbr = {
                DIR_N: (y + 1, x), DIR_S: (y - 1, x),
                DIR_E: (y, x + 1), DIR_W: (y, x - 1),
            }
            states = {d: (z[j, i], zmax[j, i], qx[j, i], qy[j, i])
                      for d, (j, i) in nbr.items()}
            beds = {d: zb[j, i] for d, (j, i) in nbr.items()}

            dry = int(z[y, x] - zb[y, x] < vs)
            dry += sum(int(states[d][0] - beds[d] < vs) for d in range(4))
            if dry >= 5:
                continue

            stop = 0
            flux = {}
            face_z = {}
            face_zb = {}
            # North: cell is left.
            l, r, st = _reconstruct(cell, zb[y, x], states[DIR_N],
                                    beds[DIR_N], DIR_N, vs)
            stop += st
            face_z[DIR_N], face_zb[DIR_N] = r["z"], r["zb"]
            flux[DIR_N] = _hllc(DIR_N, l, r, vs)
            # South: cell is right.
            l, r, st = _reconstruct(states[DIR_S], beds[DIR_S], cell,
                                    zb[y, x], DIR_S, vs)
            stop += st
            face_z[DIR_S], face_zb[DIR_S] = l["z"], l["zb"]
            flux[DIR_S] = _hllc(DIR_S, l, r, vs)
            # East: cell is left.
            l, r, st = _reconstruct(cell, zb[y, x], states[DIR_E],
                                    beds[DIR_E], DIR_E, vs)
            stop += st
            face_z[DIR_E], face_zb[DIR_E] = r["z"], r["zb"]
            flux[DIR_E] = _hllc(DIR_E, l, r, vs)
            # West: cell is right.
            l, r, st = _reconstruct(states[DIR_W], beds[DIR_W], cell,
                                    zb[y, x], DIR_W, vs)
            stop += st
            face_z[DIR_W], face_zb[DIR_W] = l["z"], l["zb"]
            flux[DIR_W] = _hllc(DIR_W, l, r, vs)

            src_x = -G * 0.5 * (face_z[DIR_E] + face_z[DIR_W]) \
                * (face_zb[DIR_E] - face_zb[DIR_W]) / dx
            src_y = -G * 0.5 * (face_z[DIR_N] + face_z[DIR_S]) \
                * (face_zb[DIR_N] - face_zb[DIR_S]) / dy

            d_z = (flux[DIR_E][0] - flux[DIR_W][0]) / dx \
                + (flux[DIR_N][0] - flux[DIR_S][0]) / dy
            d_qx = (flux[DIR_E][1] - flux[DIR_W][1]) / dx \
                + (flux[DIR_N][1] - flux[DIR_S][1]) / dy - src_x
            d_qy = (flux[DIR_E][2] - flux[DIR_W][2]) / dx \
                + (flux[DIR_N][2] - flux[DIR_S][2]) / dy - src_y

            d_z = 0.0 if abs(d_z) < vs else d_z
            d_qx = 0.0 if abs(d_qx) < vs else d_qx
            d_qy = 0.0 if abs(d_qy) < vs else d_qy

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

            if cz > czmax and czmax > -9990.0:
                czmax = cz
            if cz - zb[y, x] < vs:
                cz = zb[y, x]

            out[0][y, x] = cz
            out[1][y, x] = czmax
            out[2][y, x] = cqx
            out[3][y, x] = cqy

    return tuple(out)
