"""MINMOD/MINBEE slope limiter (Toro 2001, pp. 208-210).

Mirrors slopeLimiter / calculateLimitedSlope (reference:
src/Schemes/Limiters/CLSlopeLimiterMINMOD.clc:26-89): component-wise limited
slopes for (z, h, qx, qy), zeroed entirely at wet/dry fronts.  The CUDA
kernels repeat both functions in ``csrc/muscl_common.cuh``.
"""

from __future__ import annotations

import torch

from ..constants import MINBEE_BETA


def limited_slope(left, center, right):
    """Component-wise MINBEE-limited slope.

    For the reference's beta = 1 the MINBEE function is MINMOD: the slope
    is region_l when r >= 1, region_r when 0 <= r < 1 and 0 otherwise, so
    the piecewise form below needs no division (the ratio form rounds once
    more, by at most an ulp)."""
    region_l = center - left
    region_r = right - center
    if MINBEE_BETA == 1.0:
        pos = (region_l > 0.0) & (region_r > 0.0)
        neg = (region_l < 0.0) & (region_r < 0.0)
        return torch.where(pos, torch.minimum(region_l, region_r),
                           torch.where(neg, torch.maximum(region_l, region_r),
                                       0.0))
    r = torch.where(region_l == 0.0, 0.0, region_r
                    / torch.where(region_l == 0.0, 1.0, region_l))
    phi = torch.maximum(
        torch.clamp(torch.clamp(MINBEE_BETA * r, max=1.0), min=0.0),
        torch.clamp(r, max=MINBEE_BETA))
    return phi * region_l


def slope_vector(z_l, zb_l, qx_l, qy_l,
                 z_c, zb_c, qx_c, qy_c,
                 z_r, zb_r, qx_r, qy_r, very_small):
    """Limited slopes (dz, dh, dqx, dqy); all zero at wet/dry fronts."""
    wet = ((z_l - zb_l) >= very_small) & ((z_r - zb_r) >= very_small)
    sz = limited_slope(z_l, z_c, z_r)
    sh = limited_slope(z_l - zb_l, z_c - zb_c, z_r - zb_r)
    sqx = limited_slope(qx_l, qx_c, qx_r)
    sqy = limited_slope(qy_l, qy_c, qy_r)
    return tuple(torch.where(wet, s, 0.0) for s in (sz, sh, sqx, sqy))
