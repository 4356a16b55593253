"""MUSCL-Hancock as a predictor kernel and a corrector kernel: the CUDA
kernels and their dispatch.

``muscl_step_split`` is the port of ``muscl_step_pallas_split``.  Each of
its four kernels (``csrc/muscl_split.cu``) has a wrapper with its own
launch count:

* ``muscl_predict``            K2, variant "split12": base + slopes, 12 planes;
* ``muscl_predict_base``       K5a-P, variant "recompute": the 4 base planes;
* ``muscl_correct``            K3: corrector on the 12 planes, row-marching
  (its launch geometry comes from ``geometry.march_geometry``);
* ``muscl_correct_recompute``  K5a-C: the same row-marching corrector, which
  rebuilds each cell's slopes once from the state (two halo lanes);
* ``muscl_fused``              K5b: the whole step in one kernel, the same
  row-marching corrector with slopes and half-step base PREDICTED from the
  state, once per cell (``stencil_step("muscl-hancock")``; no
  ``Simulation`` path takes it, as in the JAX package).

On CPU tensors a wrapper runs its plain PyTorch version
(``muscl_predict_plain`` / ``muscl_correct_plain`` / ``muscl_step_plain``);
on CUDA tensors it launches its kernel or raises.  There is no fallback
from the card to the plain version.

The predictor's planes form one (12 or 4, rows, cols) tensor: base
(z, h, qx, qy), then sx(z, h, qx, qy) and sy(z, h, qx, qy).  Cells of the
one-cell edge ring hold the first-order placeholder (z, z - zb, qx, qy)
and zero slopes.

On a mesh block (``parallel/halo_deep.py``) the correctors K3 and K5a-C
and the whole step K5b take the mesh options ``origin``, ``logical`` and
``speed_window`` (``common.mesh_window``): the logical grid's two-cell
ring is frozen in global coordinates, beside the array's own, and the CFL
max covers the owned cells.  The predictors take none, as in the JAX
package: they run unchanged on the extended block, and the rebuilt (and
K5b's predicted) slopes' edge test stays on the array's own ring.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...state import FlowState
from ..godunov import SchemeParams
from ..muscl import (FaceExtrap, faces_from_base_slopes, interior_slopes,
                     muscl_corrector_full, muscl_predictor_base_slopes,
                     muscl_step, with_ring)
from . import build
from .common import (check_planes, launch_step, mesh_window, on_card,
                     plain_step_result, raise_on)
from .geometry import march_geometry

N_PRED = 12        # base(4) + sx(4) + sy(4)
RING = 2           # MUSCL static ring width
VARIANTS = ("split12", "recompute")
# Where the corrector finds the slopes (csrc/muscl_split.cu SlopeSource):
# K3 loads K2's 8 slope planes, K5a-C rebuilds them beside K5a-P's 4 base
# planes, K5b rebuilds them and predicts the base from them; the predictor
# planes each takes, and its warps' halo lanes.
LOADED, REBUILT, PREDICTED = 0, 1, 2
CORRECTOR_PLANES = {LOADED: N_PRED, REBUILT: 4, PREDICTED: 0}
CORRECTOR_HALO = {LOADED: 1, REBUILT: 2, PREDICTED: 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_PREDICT_ARGS = [_P] * 6 + [_I, _P, _I, _I] + [_D] * 3 + [_P]
_CORRECT_F32_ARGS = [_P] * 15 + [_I] * 13 + [_D] * 4 + [_I, _I, _P]
_CORRECT_F64_ARGS = [_P] * 13 + [_I] * 13 + [_D] * 4 + [_I, _I, _P]
_FUSED_F32_ARGS = [_P] * 14 + [_I] * 13 + [_D] * 4 + [_I, _P]
_FUSED_F64_ARGS = [_P] * 12 + [_I] * 13 + [_D] * 4 + [_I, _P]


@functools.cache
def _lib():
    """Build (first call only) and load the MUSCL kernels, with every C
    signature typed: an untyped pointer would be cut to 32 bits."""
    lib = build.library("muscl_split", ["muscl_split.cu"],
                        ["march.cuh", "muscl_common.cuh", "swe_common.cuh"])
    for name, args in (("muscl_predict_f32", _PREDICT_ARGS),
                       ("muscl_predict_f64", _PREDICT_ARGS),
                       ("muscl_correct_f32", _CORRECT_F32_ARGS),
                       ("muscl_correct_f64", _CORRECT_F64_ARGS),
                       ("muscl_fused_f32", _FUSED_F32_ARGS),
                       ("muscl_fused_f64", _FUSED_F64_ARGS)):
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
                        params: SchemeParams, comp=None, origin=None,
                        logical=None, speed_window=None):
    """The plain version of K3 (12 predictor planes) and K5a-C (4 base
    planes; the slopes are rebuilt from the state): the corrector, the
    two-cell static ring, and the max wave speed over the new state (with
    the mesh options, ``common.plain_step_result``).  Returns
    (new_state, speed) or, with ``comp``, (new_state, speed, comp_new)."""
    slopes = (pred[4:] if pred.shape[0] == N_PRED
              else _slope_planes(state, static, params.very_small))
    faces = faces_from_base_slopes(FaceExtrap(*pred[:4]), slopes[:4],
                                   slopes[4:])
    out = muscl_corrector_full(*state, *static, faces, dt, params, comp=comp)
    new = FlowState(*(with_ring(a, o[1:-1, 1:-1], RING)
                      for a, o in zip(state, out[:4])))
    if comp is not None:
        new = (new, with_ring(comp, out[4][1:-1, 1:-1], RING))
    return plain_step_result(state, new, comp, static, params, False, RING,
                             origin, logical, speed_window)


def muscl_step_plain(state: FlowState, static, dt, params: SchemeParams,
                     comp=None, simplified_speed=False, origin=None,
                     logical=None, speed_window=None):
    """The plain version of K5b, on any device: the whole-grid MUSCL-
    Hancock step, then the max wave speed over the new state (with the
    mesh options, ``common.plain_step_result``)."""
    return plain_step_result(state, muscl_step(state, static, dt, params,
                                               comp=comp),
                             comp, static, params, simplified_speed, RING,
                             origin, logical, speed_window)


# ---------------------------------------------------------------------------
# Kernel launches.
# ---------------------------------------------------------------------------

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
    raise_on(err, who)
    return pred


def _check_step(who, state, static, pred, n_pred, dt, comp):
    """check_planes for a corrector, and ``pred`` (unless ``n_pred`` is 0:
    K5b rebuilds its predictor) one contiguous (n_pred, rows, cols) tensor
    beside the state; returns the planes' pointers, pred's last."""
    check_planes(who, [*state, *static] + ([comp] if comp is not None
                                           else []), dt, comp)
    ptrs = [t.data_ptr() for t in (*state, *static)]
    if not n_pred:
        return ptrs
    want = (n_pred, *state.z.shape)
    if (tuple(pred.shape) != want or pred.dtype != state.z.dtype
            or pred.device != state.z.device or not pred.is_contiguous()):
        raise ValueError(f"{who}: the predictor planes must be one "
                         f"contiguous {want} tensor beside the state")
    return ptrs + [pred.data_ptr()]


def _spacing(params):
    return (1.0 / params.dx, 1.0 / params.dy, params.very_small,
            params.quite_small, int(params.friction))


def _correct_cuda(state, static, pred, dt, params, comp, slopes=LOADED,
                  window=None, chunk=None, partials=False):
    """Launch the row-marching corrector, K3 (``slopes`` LOADED, K2's 12
    planes) or K5a-C (REBUILT, K5a-P's 4 base planes), with the mesh
    ``window`` (``common.mesh_window``; None: the whole grid) on the
    geometry of its grid and halo, ``chunk`` rows per block unless
    ``geometry.march_geometry`` picks them."""
    who = "muscl_correct" if slopes == LOADED else "muscl_correct_recompute"
    inputs = _check_step(who, state, static, pred, CORRECTOR_PLANES[slopes],
                         dt, comp)
    geom = march_geometry(*state.z.shape, chunk=chunk,
                          halo=CORRECTOR_HALO[slopes])
    window = window or mesh_window(state.z.shape)
    return launch_step(_lib(), "muscl_correct", who, inputs, state, comp, dt,
                       geom.partials, (*state.z.shape, *geom.args(), *window,
                                       *_spacing(params), slopes), partials)


def _fused_cuda(state, static, dt, params, comp, window=None, chunk=None,
                partials=False):
    """Launch K5b, the row-marching corrector with slopes and base
    PREDICTED from the state, with the mesh ``window``
    (``common.mesh_window``; None: the whole grid) on the geometry of its
    grid and halo, ``chunk`` rows per block unless
    ``geometry.march_geometry`` picks them."""
    inputs = _check_step("muscl_fused", state, static, None,
                         CORRECTOR_PLANES[PREDICTED], dt, comp)
    geom = march_geometry(*state.z.shape, chunk=chunk,
                          halo=CORRECTOR_HALO[PREDICTED])
    window = window or mesh_window(state.z.shape)
    return launch_step(_lib(), "muscl_fused", "muscl_fused", inputs, state,
                       comp, dt, geom.partials, (*state.z.shape,
                                                 *geom.args(), *window,
                                                 *_spacing(params)), partials)


def muscl_predict(state: FlowState, static, dt, params: SchemeParams):
    """K2: the half-step predictor's 12 planes (base + limited slopes)."""
    if not on_card("muscl_predict", state):
        return muscl_predict_plain(state, static, dt, params)
    pred = _predict_cuda(state, static, dt, params, True)
    muscl_predict.launches += 1
    return pred


def muscl_predict_base(state: FlowState, static, dt, params: SchemeParams):
    """K5a-P: the half-step predictor's 4 base planes."""
    if not on_card("muscl_predict_base", state):
        return muscl_predict_plain(state, static, dt, params,
                                   store_slopes=False)
    pred = _predict_cuda(state, static, dt, params, False)
    muscl_predict_base.launches += 1
    return pred


def muscl_correct(state: FlowState, static, pred, dt, params: SchemeParams,
                  comp=None, origin=None, logical=None, speed_window=None,
                  partials=False):
    """K3: the corrector on K2's 12 planes, the two-cell static ring and
    the CFL max.  Returns as ``muscl_correct_plain``."""
    if not on_card("muscl_correct", state):
        return muscl_correct_plain(state, static, pred, dt, params, comp,
                                   origin, logical, speed_window)
    out = _correct_cuda(state, static, pred, dt, params, comp, LOADED,
                        mesh_window(state.z.shape, origin, logical,
                                    speed_window), partials=partials)
    muscl_correct.launches += 1
    return out


def muscl_correct_recompute(state: FlowState, static, pred, dt,
                            params: SchemeParams, comp=None, origin=None,
                            logical=None, speed_window=None, partials=False):
    """K5a-C: the corrector on K5a-P's 4 base planes, rebuilding the
    limited slopes from the state.  Returns as ``muscl_correct_plain``."""
    if not on_card("muscl_correct_recompute", state):
        return muscl_correct_plain(state, static, pred, dt, params, comp,
                                   origin, logical, speed_window)
    out = _correct_cuda(state, static, pred, dt, params, comp, REBUILT,
                        mesh_window(state.z.shape, origin, logical,
                                    speed_window), partials=partials)
    muscl_correct_recompute.launches += 1
    return out


def muscl_fused(state: FlowState, static, dt, params: SchemeParams,
                comp=None, simplified_speed=False, origin=None, logical=None,
                speed_window=None, partials=False):
    """K5b: one whole MUSCL-Hancock step + CFL max in one launch, with the
    mesh options of a halo-extended block.  Returns as
    ``muscl_step_plain``.  The CFL speed is always the full one: the
    MUSCL-Hancock scheme never takes the simplified sqrt(gh) speed."""
    if simplified_speed:
        raise ValueError("muscl_fused: the MUSCL-Hancock step has no "
                         "simplified CFL speed")
    if not on_card("muscl_fused", state):
        return muscl_step_plain(state, static, dt, params, comp, False,
                                origin, logical, speed_window)
    out = _fused_cuda(state, static, dt, params, comp,
                      mesh_window(state.z.shape, origin, logical,
                                  speed_window), partials=partials)
    muscl_fused.launches += 1
    return out


# Kernel launches since the last reset (the plain versions never count).
# K5b is counted with the fused step kernels (stencil.KERNELS).
KERNELS = (muscl_predict, muscl_predict_base, muscl_correct,
           muscl_correct_recompute)
for _k in (*KERNELS, muscl_fused):
    _k.launches = 0


def muscl_step_split(state: FlowState, static, dt, params: SchemeParams,
                     variant=None, comp=None, origin=None, logical=None,
                     speed_window=None, partials=False):
    """One MUSCL-Hancock step as predictor + corrector, and its CFL max.

    Returns (new_state, max_wave_speed), plus the updated compensation
    plane when ``comp`` (the compensated-f32 residue of z) is given; only
    the corrector touches it.  ``variant`` picks the kernel pair:
    "split12" (the default, as in the JAX package) or "recompute".  ``dt``
    is a 0-d tensor on the state's device; the two-cell edge ring keeps
    its values.  The mesh options and ``partials`` (``stencil.stencil_step``)
    go to the corrector of either variant."""
    variant = "split12" if variant is None else variant
    if variant not in VARIANTS:
        raise ValueError(f"unknown MUSCL split variant '{variant}'")
    if variant == "split12":
        pred = muscl_predict(state, static, dt, params)
        correct = muscl_correct
    else:
        pred = muscl_predict_base(state, static, dt, params)
        correct = muscl_correct_recompute
    return correct(state, static, pred, dt, params, comp, origin, logical,
                   speed_window, partials)
