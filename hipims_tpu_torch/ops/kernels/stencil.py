"""Fused scheme step + CFL partial max: the CUDA kernels and their dispatch.

``stencil_step`` is the port of ``stencil_step_pallas``: one fused step of
any scheme.  Each scheme has its own kernel wrapper, with its own launch
count and its own plain PyTorch version:

* ``godunov_fused``   K1 (``csrc/stencil.cu``), plain ``stencil_step_plain``;
* ``inertial_fused``  K4 (``csrc/stencil.cu``), plain ``inertial_step_plain``;
* ``muscl_fused``     K5b (``csrc/muscl_split.cu``, wrapper in
  ``muscl_split.py``), plain ``muscl_step_plain``.

On CPU tensors a wrapper runs its plain version; on CUDA tensors it
launches its kernel or raises.  There is no fallback from the card to the
plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...state import FlowState
from ..godunov import SchemeParams, godunov_step
from ..inertial import inertial_step
from . import build
from .common import check_planes, on_card, plain_step_result, raise_on
from .muscl_split import muscl_fused, muscl_step_plain

_P = ctypes.c_void_p
_F32_ARGS = [_P] * 14 + [ctypes.c_int, ctypes.c_int] + [ctypes.c_double] * 4 \
    + [ctypes.c_int, ctypes.c_int, _P]
_F64_ARGS = [_P] * 12 + [ctypes.c_int, ctypes.c_int] + [ctypes.c_double] * 4 \
    + [ctypes.c_int, ctypes.c_int, _P]


@functools.cache
def _lib():
    """Build (first call only) and load K1 and K4, with every C signature
    typed: an untyped pointer would be cut to 32 bits."""
    lib = build.library("stencil", ["stencil.cu"], ["swe_common.cuh"])
    for scheme in ("godunov", "inertial"):
        for suffix, args in (("f32", _F32_ARGS), ("f64", _F64_ARGS)):
            fn = getattr(lib, f"{scheme}_step_{suffix}")
            fn.argtypes = args
            fn.restype = ctypes.c_int
    lib.stencil_step_partials.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.stencil_step_partials.restype = ctypes.c_int
    return lib


def _launch_cuda(scheme, state, static, dt, params, comp, simplified_speed):
    """Launch K1 (``scheme`` "godunov") or K4 ("inertial")."""
    planes = [*state, *static] + ([comp] if comp is not None else [])
    check_planes(f"{scheme} step", planes, dt, comp)
    rows, cols = state.z.shape
    lib = _lib()
    out = [torch.empty_like(state.z) for _ in range(4)]
    comp_out = torch.empty_like(comp) if comp is not None else None
    speeds = torch.empty(lib.stencil_step_partials(rows, cols),
                         dtype=state.z.dtype, device=state.z.device)
    # K1 multiplies by the inverse spacings; K4 divides by the spacings,
    # as the reference's inertial scheme does.
    spacing = ((params.dx, params.dy) if scheme == "inertial"
               else (1.0 / params.dx, 1.0 / params.dy))
    with torch.cuda.device(state.z.device):
        stream = torch.cuda.current_stream().cuda_stream
        common = (rows, cols, *spacing, params.very_small,
                  params.quite_small, int(params.friction),
                  int(simplified_speed), stream)
        ptr = [t.data_ptr() for t in planes[:6]]
        optr = [t.data_ptr() for t in out]
        if state.z.dtype == torch.float32:
            cptr = comp.data_ptr() if comp is not None else None
            coptr = comp_out.data_ptr() if comp is not None else None
            err = getattr(lib, f"{scheme}_step_f32")(
                *ptr, cptr, *optr, coptr, speeds.data_ptr(), dt.data_ptr(),
                *common)
        else:
            err = getattr(lib, f"{scheme}_step_f64")(
                *ptr, *optr, speeds.data_ptr(), dt.data_ptr(), *common)
    raise_on(err, f"{scheme} step")
    new = FlowState(*out)
    if comp is None:
        return new, torch.amax(speeds)
    return new, torch.amax(speeds), comp_out


def stencil_step_plain(state: FlowState, static, dt, params: SchemeParams,
                       comp=None, simplified_speed=False):
    """The plain PyTorch version of K1, on any device: the whole-grid
    Godunov step, then the max wave speed over the new state."""
    return plain_step_result(godunov_step(state, static, dt, params,
                                          comp=comp),
                             comp, static, params, simplified_speed)


def inertial_step_plain(state: FlowState, static, dt, params: SchemeParams,
                        comp=None, simplified_speed=True):
    """The plain PyTorch version of K4, on any device: the whole-grid
    partial-inertial step, then the max wave speed over the new state."""
    return plain_step_result(inertial_step(state, static, dt, params,
                                           comp=comp),
                             comp, static, params, simplified_speed)


def godunov_fused(state: FlowState, static, dt, params: SchemeParams,
                  comp=None, simplified_speed=False):
    """K1: one first-order Godunov step + CFL max."""
    if not on_card("godunov_fused", state):
        return stencil_step_plain(state, static, dt, params, comp=comp,
                                  simplified_speed=simplified_speed)
    out = _launch_cuda("godunov", state, static, dt, params, comp,
                       simplified_speed)
    godunov_fused.launches += 1
    return out


def inertial_fused(state: FlowState, static, dt, params: SchemeParams,
                   comp=None, simplified_speed=True):
    """K4: one partial-inertial step + CFL max."""
    if not on_card("inertial_fused", state):
        return inertial_step_plain(state, static, dt, params, comp=comp,
                                   simplified_speed=simplified_speed)
    out = _launch_cuda("inertial", state, static, dt, params, comp,
                       simplified_speed)
    inertial_fused.launches += 1
    return out


# Kernel launches since the last reset (the plain versions never count).
godunov_fused.launches = 0
inertial_fused.launches = 0
KERNELS = (godunov_fused, inertial_fused, muscl_fused)
_BY_SCHEME = {"godunov": godunov_fused, "inertial": inertial_fused,
              "muscl-hancock": muscl_fused}
PLAIN = {"godunov": stencil_step_plain, "inertial": inertial_step_plain,
         "muscl-hancock": muscl_step_plain}


def stencil_step(scheme: str, state: FlowState, static, dt,
                 params: SchemeParams, comp=None, simplified_speed=False):
    """One fused step + CFL reduction of ``scheme``.

    Returns (new_state, max_wave_speed), or (new_state, max_wave_speed,
    comp_new) when ``comp`` (the compensated-f32 residue of z) is given.
    ``dt`` is a 0-d tensor on the state's device.  The scheme's static
    edge ring (one cell, two for MUSCL-Hancock) keeps its values; the max
    speed covers every cell of the new state.  CUDA tensors launch the
    scheme's kernel (K1, K4 or K5b); CPU tensors take its plain version."""
    if scheme not in _BY_SCHEME:
        raise ValueError(f"stencil_step: unknown scheme {scheme!r}; "
                         f"expected one of {sorted(_BY_SCHEME)}")
    return _BY_SCHEME[scheme](state, static, dt, params, comp=comp,
                              simplified_speed=simplified_speed)
