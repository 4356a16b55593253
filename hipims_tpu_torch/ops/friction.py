"""Point-implicit Manning friction (Liang 2010).

Mirrors implicitFriction (reference: src/Schemes/CLFriction.clc:26-72):
a denominator-implicit update of both discharge components, clamped so
friction can only stop flow, never reverse it.
"""

from __future__ import annotations

import torch

from ..constants import GRAVITY


def implicit_friction(z, qx, qy, zb, manning, dt, very_small):
    """Return (qx_new, qy_new) after one implicit friction step.

    ``dt`` is a 0-d tensor of the state dtype.  No-op where depth or total
    discharge is below the dry threshold."""
    vs = very_small
    h = z - zb
    q_mag = torch.sqrt(qx * qx + qy * qy)
    skip = (h < vs) | (q_mag < vs)

    h_safe = torch.where(skip, 1.0, h)
    q_safe = torch.where(skip, 1.0, q_mag)

    # cf / h^2 = g n^2 h^(-7/3) as one exp/log pair.
    inv_h2 = GRAVITY * manning * manning \
        * torch.exp(torch.log(h_safe) * (-7.0 / 3.0))
    sfx = -inv_h2 * qx * q_mag
    sfy = -inv_h2 * qy * q_mag
    inv_q = 1.0 / q_safe
    dt_ih2_iq = dt * inv_h2 * inv_q
    dx_den = 1.0 + dt_ih2_iq * (2.0 * qx * qx + qy * qy)
    dy_den = 1.0 + dt_ih2_iq * (qx * qx + 2.0 * qy * qy)
    fx = sfx / dx_den
    fy = sfy / dy_den

    # Friction may stop the flow but never reverse it.
    neg_inv_dt = -1.0 / dt
    limit_x = qx * neg_inv_dt
    limit_y = qy * neg_inv_dt
    fx = torch.where(qx >= 0.0, torch.maximum(fx, limit_x),
                     torch.minimum(fx, limit_x))
    fy = torch.where(qy >= 0.0, torch.maximum(fy, limit_y),
                     torch.minimum(fy, limit_y))

    qx_new = torch.where(skip, qx, qx + dt * fx)
    qy_new = torch.where(skip, qy, qy + dt * fy)
    # The clamp bound qx * (-1/dt) can sit 1 ulp past -qx/dt; zero any
    # sign flip so "friction never reverses flow" holds exactly.
    qx_new = torch.where(qx_new * qx < 0.0, 0.0, qx_new)
    qy_new = torch.where(qy_new * qy < 0.0, 0.0, qy_new)
    return qx_new, qy_new
