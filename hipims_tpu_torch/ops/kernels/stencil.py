"""Fused scheme step + CFL partial max: the CUDA kernel and its dispatch.

``stencil_step`` is the port of ``stencil_step_pallas``.  On CPU tensors it
runs the plain PyTorch version (``ops/godunov.py`` + ``max_wave_speed``);
on CUDA tensors it launches kernel K1 (``csrc/stencil.cu``) or raises.
There is no fallback from the card to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...state import FlowState
from ..godunov import SchemeParams, godunov_step
from ..timestep import max_wave_speed
from . import build

_P = ctypes.c_void_p
_F32_ARGS = [_P] * 14 + [ctypes.c_int, ctypes.c_int] + [ctypes.c_double] * 4 \
    + [ctypes.c_int, ctypes.c_int, _P]
_F64_ARGS = [_P] * 12 + [ctypes.c_int, ctypes.c_int] + [ctypes.c_double] * 4 \
    + [ctypes.c_int, ctypes.c_int, _P]


@functools.cache
def _lib():
    """Build (first call only) and load K1, with every C signature typed:
    an untyped pointer would be cut to 32 bits."""
    lib = build.library("stencil", ["stencil.cu"], ["swe_common.cuh"])
    lib.godunov_step_f32.argtypes = _F32_ARGS
    lib.godunov_step_f32.restype = ctypes.c_int
    lib.godunov_step_f64.argtypes = _F64_ARGS
    lib.godunov_step_f64.restype = ctypes.c_int
    lib.godunov_step_partials.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.godunov_step_partials.restype = ctypes.c_int
    return lib


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


def _launch_cuda(state, static, dt, params, comp, simplified_speed):
    planes = [*state, *static] + ([comp] if comp is not None else [])
    check_planes("stencil_step", planes, dt, comp)
    rows, cols = state.z.shape
    lib = _lib()
    out = [torch.empty_like(state.z) for _ in range(4)]
    comp_out = torch.empty_like(comp) if comp is not None else None
    speeds = torch.empty(lib.godunov_step_partials(rows, cols),
                         dtype=state.z.dtype, device=state.z.device)
    with torch.cuda.device(state.z.device):
        stream = torch.cuda.current_stream().cuda_stream
        common = (rows, cols, 1.0 / params.dx, 1.0 / params.dy,
                  params.very_small, params.quite_small,
                  int(params.friction), int(simplified_speed), stream)
        ptr = [t.data_ptr() for t in planes[:6]]
        optr = [t.data_ptr() for t in out]
        if state.z.dtype == torch.float32:
            cptr = comp.data_ptr() if comp is not None else None
            coptr = comp_out.data_ptr() if comp is not None else None
            err = lib.godunov_step_f32(*ptr, cptr, *optr, coptr,
                                       speeds.data_ptr(), dt.data_ptr(),
                                       *common)
        else:
            err = lib.godunov_step_f64(*ptr, *optr, speeds.data_ptr(),
                                       dt.data_ptr(), *common)
    if err != 0:
        raise RuntimeError(f"godunov step kernel launch failed: CUDA error "
                           f"{err}")
    stencil_step.launches += 1
    new = FlowState(*out)
    if comp is None:
        return new, torch.amax(speeds)
    return new, torch.amax(speeds), comp_out


def stencil_step_plain(state: FlowState, static, dt, params: SchemeParams,
                       comp=None, simplified_speed=False):
    """The plain PyTorch version of K1, on any device: the whole-grid
    Godunov step, then the max wave speed over the new state."""
    out = godunov_step(state, static, dt, params, comp=comp)
    new, comp_new = (out, None) if comp is None else out
    speed = max_wave_speed(new.z, new.zmax, new.qx, new.qy, static.zb,
                           params.quite_small, simplified_speed)
    if comp is None:
        return new, speed
    return new, speed, comp_new


def stencil_step(scheme: str, state: FlowState, static, dt,
                 params: SchemeParams, comp=None, simplified_speed=False):
    """One fused step + CFL reduction.

    Returns (new_state, max_wave_speed), or (new_state, max_wave_speed,
    comp_new) when ``comp`` (the compensated-f32 residue of z) is given.
    ``dt`` is a 0-d tensor on the state's device.  The one-cell edge ring
    keeps its values; the max speed covers every cell of the new state.
    CUDA tensors launch K1; CPU tensors take the plain version."""
    if scheme != "godunov":
        raise NotImplementedError(
            f"stencil_step: scheme {scheme!r} is not ported yet "
            "(ROADMAP.md, queue 2)")
    if state.z.device.type == "cuda":
        return _launch_cuda(state, static, dt, params, comp,
                            simplified_speed)
    if state.z.device.type != "cpu":
        raise ValueError(f"stencil_step runs on CUDA or CPU tensors, not "
                         f"{state.z.device}")
    return stencil_step_plain(state, static, dt, params, comp=comp,
                              simplified_speed=simplified_speed)


# Kernel launches since the last reset (the plain version never counts).
stencil_step.launches = 0
