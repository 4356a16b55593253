"""CFL wave-speed reduction and the per-step time controller.

Mirrors tst_Reduce / tst_Advance_Normal (reference:
src/Schemes/CLDynamicTimestep.clc:167-249, :28-146).  Every quantity is a
0-d tensor on the state's device: nothing here reads back to the host, so
a batch of steps runs with no synchronisation.  The reference's negative
timestep convention is kept: at the sync time dt flips negative, which
suspends the step kernel and the boundaries while leaving the magnitude
readable, so a fixed-length batch idles harmlessly past its target.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as C
from ..state import StepCarry


class TimestepParams(NamedTuple):
    """Static timestep configuration."""

    courant: float = 0.5
    dynamic: bool = True          # CFL-driven vs fixed
    fixed_dt: float = 0.1
    simplified_speed: bool = False  # sqrt(gh) only (inertial scheme)
    minimum: float = C.TIMESTEP_MINIMUM
    maximum: float = C.TIMESTEP_MAXIMUM
    early_limit: float = C.TIMESTEP_EARLY_LIMIT
    early_duration: float = C.TIMESTEP_EARLY_LIMIT_DURATION
    start_minimum: float = C.TIMESTEP_START_MINIMUM
    start_duration: float = C.TIMESTEP_START_MINIMUM_DURATION


def cell_wave_speed(z, zmax, qx, qy, zb, quite_small, simplified=False):
    """Per-cell CFL speed: max over axes of |u| + sqrt(g h) (or sqrt(g h)
    alone), zero on disabled cells and below the QUITE_SMALL depth
    (reference: src/Schemes/CLDynamicTimestep.clc:185-223)."""
    h = z - zb
    wet = (h > quite_small) & (zmax > C.NODATA)
    h_safe = torch.where(wet, h, 1.0)
    celerity = torch.sqrt(C.GRAVITY * torch.clamp(h, min=0.0))
    if simplified:
        speed = celerity
    else:
        speed = torch.maximum(torch.abs(qx), torch.abs(qy)) / h_safe \
            + celerity
    return torch.where(wet, speed, 0.0)


def max_wave_speed(z, zmax, qx, qy, zb, quite_small, simplified=False):
    """Global maximum per-cell wave speed, as a 0-d tensor."""
    return torch.amax(cell_wave_speed(z, zmax, qx, qy, zb, quite_small,
                                      simplified))


def advance(carry: StepCarry, max_speed, sync_time, end_time, dx,
            params: TimestepParams) -> StepCarry:
    """Advance simulation time and compute the next timestep.

    Time moves by max(0, dt); the hydrological accumulator resets after it
    exceeds its own timestep; the new dt is CFL-limited, then clamped by
    the start-up floor, the global minimum, the sync-time suspension flip,
    the early-simulation cap, the end time and the global maximum, in that
    order.  ``sync_time`` is a 0-d tensor and ``max_speed`` a 0-d tensor
    or a step kernel's 1-d partial maxima, whose max (NaN propagating) it
    takes; max_speed == 0 gives dx / 0 = inf, which the later clamps cap.
    ``ops/kernels/timestep.py`` runs the same ladder as one CUDA kernel."""
    if max_speed.dim() > 0:
        max_speed = torch.amax(max_speed)
    dt_eff = torch.clamp(carry.dt, min=0.0)
    t_new = carry.t + dt_eff
    batch_total = carry.batch_dt_total + dt_eff
    stepped = dt_eff > 0.0
    successful = carry.batch_successful + stepped.to(torch.int32)
    skipped = carry.batch_skipped + (~stepped).to(torch.int32)
    t_hydro = torch.where(carry.t_hydro > C.TIMESTEP_HYDROLOGICAL,
                          dt_eff, carry.t_hydro + dt_eff)

    if params.dynamic:
        min_time = dx / max_speed
        force_start = ((t_new < params.start_duration)
                       & (min_time < params.start_minimum))
        min_time = torch.where(force_start, params.start_minimum, min_time)
        dt_new = params.courant * min_time
    else:
        dt_new = torch.full_like(carry.dt, params.fixed_dt)

    dt_new = torch.where((dt_new > 0.0) & (dt_new < params.minimum),
                         params.minimum, dt_new)

    # Suspension at the sync point: land exactly on it if any gap remains,
    # otherwise flip negative to idle until the host moves the target.
    remaining = sync_time - t_new
    reach = (t_new + dt_new) >= sync_time
    dt_new = torch.where(reach,
                         torch.where(remaining > C.VERY_SMALL, remaining,
                                     -dt_new),
                         dt_new)

    dt_new = torch.where((t_new < params.early_duration)
                         & (dt_new > params.early_limit),
                         params.early_limit, dt_new)
    dt_new = torch.where((t_new + dt_new) > end_time, end_time - t_new,
                         dt_new)
    dt_new = torch.where(dt_new > params.maximum, params.maximum, dt_new)

    return StepCarry(t=t_new, dt=dt_new, t_hydro=t_hydro,
                     batch_dt_total=batch_total,
                     batch_successful=successful,
                     batch_skipped=skipped)
