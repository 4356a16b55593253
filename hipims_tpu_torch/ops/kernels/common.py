"""Shared by the kernel wrappers: which device a call runs on, what the
kernels take, how a refused launch is reported, and the result a fused
step's plain version returns."""

from __future__ import annotations

import torch

from ...state import FlowState
from ..timestep import max_wave_speed


def on_card(who, state):
    """True for CUDA tensors, False for CPU tensors; raises otherwise."""
    dev = state.z.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{who} runs on CUDA or CPU tensors, not {dev}")
    return dev.type == "cuda"


def raise_on(err, what):
    """Raise unless ``err`` (a launch's CUDA error code) is 0."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def check_planes(who, tensors, dt, comp):
    """Raise unless ``tensors`` are contiguous (rows, cols) planes of one
    shape, float dtype and device, ``dt`` a 0-d tensor beside them, and
    ``comp`` (if given) a float32 option: what the kernels take."""
    ref = tensors[0]
    if ref.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{who} takes float32 or float64, got {ref.dtype}")
    if ref.dim() != 2 or min(ref.shape) < 3:
        raise ValueError(f"{who} needs a (rows, cols) grid of at least 3x3, "
                         f"got {tuple(ref.shape)}")
    for t in tensors:
        if (t.device != ref.device or t.dtype != ref.dtype
                or t.shape != ref.shape or not t.is_contiguous()):
            raise ValueError(f"{who}: every plane must be a contiguous "
                             "tensor of one shape, dtype and device")
    if dt.dim() != 0 or dt.device != ref.device or dt.dtype != ref.dtype:
        raise ValueError(f"{who}: dt must be a 0-d tensor on the planes' "
                         "device, in their dtype")
    if comp is not None and ref.dtype != torch.float32:
        raise ValueError(f"{who}: the comp plane is a float32 (compensated) "
                         "option")


def launch_step(lib, name, who, inputs, state, comp, dt, n_partials, args):
    """Launch the step kernel ``name``_f32 or ``name``_f64 of ``lib``: it
    reads the planes ``inputs`` (pointers; None where the kernel takes no
    plane) and, in f32, ``comp``; writes the four planes of the new state,
    the new comp and ``n_partials`` partial CFL maxima; and takes
    ``args`` after dt.  Returns (new_state, max_wave_speed[, comp_new])."""
    out = [torch.empty_like(state.z) for _ in range(4)]
    comp_out = torch.empty_like(comp) if comp is not None else None
    speeds = torch.empty(n_partials, dtype=state.z.dtype,
                         device=state.z.device)
    optr = [t.data_ptr() for t in out]
    with torch.cuda.device(state.z.device):
        tail = (speeds.data_ptr(), dt.data_ptr(), *args,
                torch.cuda.current_stream().cuda_stream)
        if state.z.dtype == torch.float32:
            cptr = comp.data_ptr() if comp is not None else None
            coptr = comp_out.data_ptr() if comp is not None else None
            err = getattr(lib, f"{name}_f32")(*inputs, cptr, *optr, coptr,
                                              *tail)
        else:
            err = getattr(lib, f"{name}_f64")(*inputs, *optr, *tail)
    raise_on(err, who)
    new = FlowState(*out)
    if comp is None:
        return new, torch.amax(speeds)
    return new, torch.amax(speeds), comp_out


def plain_step_result(out, comp, static, params, simplified_speed):
    """What a fused step kernel returns, from its plain version's
    whole-grid step ``out`` (a FlowState, or (FlowState, comp_new) when
    ``comp`` is given): (new_state, max_wave_speed[, comp_new])."""
    new, comp_new = (out, None) if comp is None else out
    speed = max_wave_speed(new.z, new.zmax, new.qx, new.qy, static.zb,
                           params.quite_small, simplified_speed)
    return (new, speed) if comp is None else (new, speed, comp_new)
