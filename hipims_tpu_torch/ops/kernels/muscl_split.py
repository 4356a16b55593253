"""MUSCL-Hancock as a predictor kernel and a corrector kernel: the CUDA
kernels and their dispatch.

``muscl_step_split`` is the port of ``muscl_step_pallas_split``.  Each of
its four kernels (``csrc/muscl_split.cu``) has a wrapper with its own
launch count:

* ``muscl_predict``            K2, variant "split12": base + slopes, 12 planes;
* ``muscl_predict_base``       K5a-P, variant "recompute": the 4 base planes;
* ``muscl_correct``            K3: corrector on the 12 planes;
* ``muscl_correct_recompute``  K5a-C: corrector that rebuilds the slopes.

On CPU tensors a wrapper runs its plain PyTorch version
(``muscl_predict_plain`` / ``muscl_correct_plain``); on CUDA tensors it
launches its kernel or raises.  There is no fallback from the card to the
plain version.

The predictor's planes form one (12 or 4, rows, cols) tensor: base
(z, h, qx, qy), then sx(z, h, qx, qy) and sy(z, h, qx, qy).  Cells of the
one-cell edge ring hold the first-order placeholder (z, z - zb, qx, qy)
and zero slopes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...state import FlowState
from ..godunov import SchemeParams
from ..muscl import (FaceExtrap, faces_from_base_slopes, interior_slopes,
                     muscl_corrector_full, muscl_predictor_base_slopes,
                     with_ring)
from ..timestep import max_wave_speed
from . import build
from .stencil import check_planes

N_PRED = 12        # base(4) + sx(4) + sy(4)
RING = 2           # MUSCL static ring width
VARIANTS = ("split12", "recompute")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_PREDICT_ARGS = [_P] * 6 + [_I, _P, _I, _I] + [_D] * 3 + [_P]
_CORRECT_F32_ARGS = [_P] * 15 + [_I, _I] + [_D] * 4 + [_I, _I, _P]
_CORRECT_F64_ARGS = [_P] * 13 + [_I, _I] + [_D] * 4 + [_I, _I, _P]


@functools.cache
def _lib():
    """Build (first call only) and load the MUSCL kernels, with every C
    signature typed: an untyped pointer would be cut to 32 bits."""
    lib = build.library("muscl_split", ["muscl_split.cu"],
                        ["muscl_common.cuh", "swe_common.cuh"])
    for name, args in (("muscl_predict_f32", _PREDICT_ARGS),
                       ("muscl_predict_f64", _PREDICT_ARGS),
                       ("muscl_correct_f32", _CORRECT_F32_ARGS),
                       ("muscl_correct_f64", _CORRECT_F64_ARGS),
                       ("muscl_correct_partials", [_I, _I])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = _I
    return lib


# ---------------------------------------------------------------------------
# Plain PyTorch versions (any device).
# ---------------------------------------------------------------------------

def muscl_predict_plain(state: FlowState, static, dt, params: SchemeParams,
                        store_slopes=True):
    """The plain version of K2 (``store_slopes``) and K5a-P: the
    predictor's (12 or 4, rows, cols) planes."""
    z, zmax, qx, qy = state
    zb = static.zb
    out = torch.zeros((N_PRED if store_slopes else 4, *z.shape),
                      dtype=z.dtype, device=z.device)
    for k, a in enumerate((z, z - zb, qx, qy)):
        out[k] = a
    base, sx, sy = muscl_predictor_base_slopes(z, zmax, qx, qy, zb, dt,
                                               params)
    for k, a in enumerate((*base, *sx, *sy)[:out.shape[0]]):
        out[k, 1:-1, 1:-1] = a
    return out


def _slope_planes(state: FlowState, static, vs):
    """The 8 slope planes the split12 predictor stores, rebuilt from the
    state: zero on the edge ring and on first-order cells."""
    z, zmax, qx, qy = state
    first_order, sx, sy = interior_slopes(z, zmax, qx, qy, static.zb, vs)
    out = torch.zeros((8, *z.shape), dtype=z.dtype, device=z.device)
    for k, s in enumerate((*sx, *sy)):
        out[k, 1:-1, 1:-1] = torch.where(first_order, 0.0, s)
    return out


def muscl_correct_plain(state: FlowState, static, pred, dt,
                        params: SchemeParams, comp=None):
    """The plain version of K3 (12 predictor planes) and K5a-C (4 base
    planes; the slopes are rebuilt from the state): the corrector, the
    two-cell static ring, and the max wave speed over the new state.
    Returns (new_state, speed) or, with ``comp``, (new_state, speed,
    comp_new)."""
    slopes = (pred[4:] if pred.shape[0] == N_PRED
              else _slope_planes(state, static, params.very_small))
    faces = faces_from_base_slopes(FaceExtrap(*pred[:4]), slopes[:4],
                                   slopes[4:])
    out = muscl_corrector_full(*state, *static, faces, dt, params, comp=comp)
    new = FlowState(*(with_ring(a, o[1:-1, 1:-1], RING)
                      for a, o in zip(state, out[:4])))
    speed = max_wave_speed(new.z, new.zmax, new.qx, new.qy, static.zb,
                           params.quite_small)
    if comp is None:
        return new, speed
    return new, speed, with_ring(comp, out[4][1:-1, 1:-1], RING)


# ---------------------------------------------------------------------------
# Kernel launches.
# ---------------------------------------------------------------------------

def _on_card(who, state):
    """True for CUDA tensors, False for CPU tensors; raises otherwise."""
    dev = state.z.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{who} runs on CUDA or CPU tensors, not {dev}")
    return dev.type == "cuda"


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _predict_cuda(state, static, dt, params, store_slopes):
    who = "muscl_predict" if store_slopes else "muscl_predict_base"
    check_planes(who, [*state, static.zb], dt, None)
    rows, cols = state.z.shape
    pred = torch.empty((N_PRED if store_slopes else 4, rows, cols),
                       dtype=state.z.dtype, device=state.z.device)
    fn = (_lib().muscl_predict_f32 if state.z.dtype == torch.float32
          else _lib().muscl_predict_f64)
    with torch.cuda.device(state.z.device):
        err = fn(*(t.data_ptr() for t in (*state, static.zb)),
                 pred.data_ptr(), int(store_slopes), dt.data_ptr(), rows,
                 cols, 1.0 / params.dx, 1.0 / params.dy, params.very_small,
                 torch.cuda.current_stream().cuda_stream)
    _raise_on(err, who)
    return pred


def _correct_cuda(state, static, pred, dt, params, comp, recompute):
    who = "muscl_correct_recompute" if recompute else "muscl_correct"
    planes = [*state, *static] + ([comp] if comp is not None else [])
    check_planes(who, planes, dt, comp)
    want = (4 if recompute else N_PRED, *state.z.shape)
    if (tuple(pred.shape) != want or pred.dtype != state.z.dtype
            or pred.device != state.z.device or not pred.is_contiguous()):
        raise ValueError(f"{who}: the predictor planes must be one "
                         f"contiguous {want} tensor beside the state")
    rows, cols = state.z.shape
    lib = _lib()
    out = [torch.empty_like(state.z) for _ in range(4)]
    comp_out = torch.empty_like(comp) if comp is not None else None
    speeds = torch.empty(lib.muscl_correct_partials(rows, cols),
                         dtype=state.z.dtype, device=state.z.device)
    ptr = [t.data_ptr() for t in (*state, *static, pred)]
    optr = [t.data_ptr() for t in out]
    with torch.cuda.device(state.z.device):
        common = (rows, cols, 1.0 / params.dx, 1.0 / params.dy,
                  params.very_small, params.quite_small,
                  int(params.friction), int(recompute),
                  torch.cuda.current_stream().cuda_stream)
        if state.z.dtype == torch.float32:
            cptr = comp.data_ptr() if comp is not None else None
            coptr = comp_out.data_ptr() if comp is not None else None
            err = lib.muscl_correct_f32(*ptr, cptr, *optr, coptr,
                                        speeds.data_ptr(), dt.data_ptr(),
                                        *common)
        else:
            err = lib.muscl_correct_f64(*ptr, *optr, speeds.data_ptr(),
                                        dt.data_ptr(), *common)
    _raise_on(err, who)
    new = FlowState(*out)
    if comp is None:
        return new, torch.amax(speeds)
    return new, torch.amax(speeds), comp_out


def muscl_predict(state: FlowState, static, dt, params: SchemeParams):
    """K2: the half-step predictor's 12 planes (base + limited slopes)."""
    if not _on_card("muscl_predict", state):
        return muscl_predict_plain(state, static, dt, params)
    pred = _predict_cuda(state, static, dt, params, True)
    muscl_predict.launches += 1
    return pred


def muscl_predict_base(state: FlowState, static, dt, params: SchemeParams):
    """K5a-P: the half-step predictor's 4 base planes."""
    if not _on_card("muscl_predict_base", state):
        return muscl_predict_plain(state, static, dt, params,
                                   store_slopes=False)
    pred = _predict_cuda(state, static, dt, params, False)
    muscl_predict_base.launches += 1
    return pred


def muscl_correct(state: FlowState, static, pred, dt, params: SchemeParams,
                  comp=None):
    """K3: the corrector on K2's 12 planes, the two-cell static ring and
    the CFL max.  Returns as ``muscl_correct_plain``."""
    if not _on_card("muscl_correct", state):
        return muscl_correct_plain(state, static, pred, dt, params,
                                   comp=comp)
    out = _correct_cuda(state, static, pred, dt, params, comp, False)
    muscl_correct.launches += 1
    return out


def muscl_correct_recompute(state: FlowState, static, pred, dt,
                            params: SchemeParams, comp=None):
    """K5a-C: the corrector on K5a-P's 4 base planes, rebuilding the
    limited slopes from the state.  Returns as ``muscl_correct_plain``."""
    if not _on_card("muscl_correct_recompute", state):
        return muscl_correct_plain(state, static, pred, dt, params,
                                   comp=comp)
    out = _correct_cuda(state, static, pred, dt, params, comp, True)
    muscl_correct_recompute.launches += 1
    return out


# Kernel launches since the last reset (the plain versions never count).
KERNELS = (muscl_predict, muscl_predict_base, muscl_correct,
           muscl_correct_recompute)
for _k in KERNELS:
    _k.launches = 0


def muscl_step_split(state: FlowState, static, dt, params: SchemeParams,
                     variant=None, comp=None):
    """One MUSCL-Hancock step as predictor + corrector, and its CFL max.

    Returns (new_state, max_wave_speed), plus the updated compensation
    plane when ``comp`` (the compensated-f32 residue of z) is given; only
    the corrector touches it.  ``variant`` picks the kernel pair:
    "split12" (the default, as in the JAX package) or "recompute".  ``dt``
    is a 0-d tensor on the state's device; the two-cell edge ring keeps
    its values."""
    variant = "split12" if variant is None else variant
    if variant not in VARIANTS:
        raise ValueError(f"unknown MUSCL split variant '{variant}'")
    if variant == "split12":
        pred = muscl_predict(state, static, dt, params)
        return muscl_correct(state, static, pred, dt, params, comp=comp)
    pred = muscl_predict_base(state, static, dt, params)
    return muscl_correct_recompute(state, static, pred, dt, params,
                                   comp=comp)
