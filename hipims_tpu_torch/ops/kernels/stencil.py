"""Fused scheme step + CFL partial max: the CUDA kernels and their dispatch.

``stencil_step`` is the port of ``stencil_step_pallas``: one fused step of
any scheme.  Each scheme has its own kernel wrapper, with its own launch
count and its own plain PyTorch version:

* ``godunov_fused``   K1 (``csrc/stencil.cu``, row-marching: its launch
  geometry comes from ``geometry.march_geometry``), plain
  ``stencil_step_plain``;
* ``inertial_fused``  K4 (``csrc/stencil.cu``, row-marching as K1), plain
  ``inertial_step_plain``;
* ``muscl_fused``     K5b (``csrc/muscl_split.cu``, wrapper in
  ``muscl_split.py``), plain ``muscl_step_plain``.

On CPU tensors a wrapper runs its plain version; on CUDA tensors it
launches its kernel or raises.  There is no fallback from the card to the
plain version.

All three also take the mesh options of a halo-extended block
(``parallel/halo_deep.py``): ``origin``, ``logical`` and ``speed_window``
(``common.mesh_window``), as the TPU kernel takes ``origin`` and
``speed_window`` for every scheme.  K5b's are held at op level: no mesh
path runs it, in either package (a mesh runs MUSCL as predictor +
corrector).
"""

from __future__ import annotations

import ctypes
import functools

from ...state import FlowState
from ..godunov import SchemeParams, godunov_step
from ..inertial import inertial_step
from . import build
from .common import (check_planes, launch_step, mesh_window, on_card,
                     plain_step_result)
from .geometry import march_geometry
from .muscl_split import muscl_fused, muscl_step_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
# (f32, f64) signatures: both take the grid, the march geometry (chunk,
# grid) and the mesh window's 8 ints; K1 also takes friction, which is
# part of K4's scheme.
_ARGS = {
    "godunov": ([_P] * 14 + [_I] * 13 + [_D] * 4 + [_I, _I, _P],
                [_P] * 12 + [_I] * 13 + [_D] * 4 + [_I, _I, _P]),
    "inertial": ([_P] * 14 + [_I] * 13 + [_D] * 4 + [_I, _P],
                 [_P] * 12 + [_I] * 13 + [_D] * 4 + [_I, _P]),
}


@functools.cache
def _lib():
    """Build (first call only) and load K1 and K4, with every C signature
    typed: an untyped pointer would be cut to 32 bits."""
    lib = build.library("stencil", ["stencil.cu"],
                        ["march.cuh", "swe_common.cuh"])
    for scheme, sigs in _ARGS.items():
        for suffix, args in zip(("f32", "f64"), sigs):
            fn = getattr(lib, f"{scheme}_step_{suffix}")
            fn.argtypes = args
            fn.restype = _I
    return lib


def _planes(state, static, comp):
    return [*state, *static] + ([comp] if comp is not None else [])


def _godunov_cuda(state, static, dt, params, comp, simplified_speed,
                  window=None, chunk=None, partials=False):
    """Launch K1 with the mesh ``window`` (``common.mesh_window``; None:
    the whole grid) on the row-marching geometry of its grid, ``chunk``
    rows per block unless ``geometry.march_geometry`` picks them."""
    check_planes("godunov step", _planes(state, static, comp), dt, comp)
    geom = march_geometry(*state.z.shape, chunk=chunk)
    window = window or mesh_window(state.z.shape)
    # K1 multiplies by the inverse spacings.
    args = (*state.z.shape, *geom.args(), *window, 1.0 / params.dx,
            1.0 / params.dy,
            params.very_small, params.quite_small, int(params.friction),
            int(simplified_speed))
    return launch_step(_lib(), "godunov_step", "godunov step",
                       [t.data_ptr() for t in (*state, *static)], state,
                       comp, dt, geom.partials, args, partials)


def _inertial_cuda(state, static, dt, params, comp, simplified_speed,
                   window=None, chunk=None, partials=False):
    """Launch K4 with the mesh ``window`` on the row-marching geometry of
    its grid, as K1."""
    check_planes("inertial step", _planes(state, static, comp), dt, comp)
    geom = march_geometry(*state.z.shape, chunk=chunk)
    window = window or mesh_window(state.z.shape)
    # K4 divides by the spacings, as the reference's inertial scheme does;
    # its friction is part of the scheme.
    args = (*state.z.shape, *geom.args(), *window, params.dx, params.dy,
            params.very_small, params.quite_small, int(simplified_speed))
    return launch_step(_lib(), "inertial_step", "inertial step",
                       [t.data_ptr() for t in (*state, *static)], state,
                       comp, dt, geom.partials, args, partials)


def stencil_step_plain(state: FlowState, static, dt, params: SchemeParams,
                       comp=None, simplified_speed=False, origin=None,
                       logical=None, speed_window=None):
    """The plain PyTorch version of K1, on any device: the whole-grid
    Godunov step, then the max wave speed over the new state (with the
    mesh options, ``common.plain_step_result``)."""
    return plain_step_result(state, godunov_step(state, static, dt, params,
                                                 comp=comp),
                             comp, static, params, simplified_speed, 1,
                             origin, logical, speed_window)


def inertial_step_plain(state: FlowState, static, dt, params: SchemeParams,
                        comp=None, simplified_speed=True, origin=None,
                        logical=None, speed_window=None):
    """The plain PyTorch version of K4, on any device: the whole-grid
    partial-inertial step, then the max wave speed over the new state
    (with the mesh options, ``common.plain_step_result``)."""
    return plain_step_result(state, inertial_step(state, static, dt, params,
                                                  comp=comp),
                             comp, static, params, simplified_speed, 1,
                             origin, logical, speed_window)


def godunov_fused(state: FlowState, static, dt, params: SchemeParams,
                  comp=None, simplified_speed=False, origin=None,
                  logical=None, speed_window=None, partials=False):
    """K1: one first-order Godunov step + CFL max."""
    if not on_card("godunov_fused", state):
        return stencil_step_plain(state, static, dt, params, comp,
                                  simplified_speed, origin, logical,
                                  speed_window)
    out = _godunov_cuda(state, static, dt, params, comp, simplified_speed,
                        mesh_window(state.z.shape, origin, logical,
                                    speed_window), partials=partials)
    godunov_fused.launches += 1
    return out


def inertial_fused(state: FlowState, static, dt, params: SchemeParams,
                   comp=None, simplified_speed=True, origin=None,
                   logical=None, speed_window=None, partials=False):
    """K4: one partial-inertial step + CFL max."""
    if not on_card("inertial_fused", state):
        return inertial_step_plain(state, static, dt, params, comp,
                                   simplified_speed, origin, logical,
                                   speed_window)
    out = _inertial_cuda(state, static, dt, params, comp, simplified_speed,
                         mesh_window(state.z.shape, origin, logical,
                                     speed_window), partials=partials)
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
                 params: SchemeParams, comp=None, simplified_speed=False,
                 origin=None, logical=None, speed_window=None,
                 partials=False):
    """One fused step + CFL reduction of ``scheme``.

    Returns (new_state, max_wave_speed), or (new_state, max_wave_speed,
    comp_new) when ``comp`` (the compensated-f32 residue of z) is given.
    ``dt`` is a 0-d tensor on the state's device.  The scheme's static
    edge ring (one cell, two for MUSCL-Hancock) keeps its values; the max
    speed covers every cell of the new state.  On a mesh block, ``origin``
    (the global index of the array's [0, 0]), ``logical`` (the logical
    grid's rows, cols) and ``speed_window`` (r0, nr, c0, nc: the owned
    cells) also freeze the logical grid's ring (two cells for
    MUSCL-Hancock) in global coordinates and restrict the max to the
    owned cells (``common.mesh_window``).  With ``partials`` the kernel's
    1-d partial maxima come back in the max's place, unreduced, for
    ``kernels.timestep.advance`` to fold (the plain version's max stays
    0-d).  CUDA tensors launch the scheme's kernel (K1, K4 or K5b); CPU
    tensors take its plain version."""
    if scheme not in _BY_SCHEME:
        raise ValueError(f"stencil_step: unknown scheme {scheme!r}; "
                         f"expected one of {sorted(_BY_SCHEME)}")
    return _BY_SCHEME[scheme](state, static, dt, params, comp=comp,
                              simplified_speed=simplified_speed,
                              origin=origin, logical=logical,
                              speed_window=speed_window, partials=partials)
