"""The time controller ``advance`` as one CUDA kernel, with the max over the
scheme kernel's CFL partial maxima folded in (``csrc/timestep.cu``).

``advance`` takes what ``ops.timestep.advance`` takes and returns the same
new carry, bit for bit.  Its ``max_speed`` may be a 0-d max or a step
kernel's 1-d partial maxima (``launch_step(..., partials=True)``), which
the kernel folds with a NaN-propagating max.  On CPU tensors it runs the
plain version, ``ops.timestep.advance``; on CUDA tensors it launches the
kernel or raises.  There is no fallback from the card to the plain
version.

The kernel reads the old carry and writes a new one, so the old carry is
left as it was (``parallel/halo_deep.py`` keeps one to re-run a window
from).  The new carry's four floats are 0-d views of one tensor and its
two counters of another: two allocations a step, not six.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ... import constants as C
from ...state import StepCarry
from .. import timestep as plain
from . import build
from .common import raise_on

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
# speeds, n, the carry's six, sync, out, counts; the ladder's 12 doubles,
# dynamic, the device and its stream.
_ARGS = [_P, _I] + [_P] * 9 + [ctypes.POINTER(_D), _I, _I, _P]


@functools.cache
def _lib():
    """Build (first call only) and load the kernel, with its C signatures
    typed: an untyped pointer would be cut to 32 bits."""
    lib = build.library("timestep", ["timestep.cu"], ["swe_common.cuh"])
    for name in ("advance_f32", "advance_f64"):
        fn = getattr(lib, name)
        fn.argtypes = _ARGS
        fn.restype = _I
    return lib


@functools.lru_cache(maxsize=16)
def _ladder(params: plain.TimestepParams, dx: float, end_time: float):
    """The ladder's Python scalars as the C entry point reads them
    (csrc/timestep.cu ``Ladder``), built once per run's settings."""
    return (_D * 12)(dx, params.courant, params.fixed_dt, params.minimum,
                     params.maximum, params.early_limit,
                     params.early_duration, params.start_minimum,
                     params.start_duration, end_time, C.VERY_SMALL,
                     C.TIMESTEP_HYDROLOGICAL)


def _check(carry: StepCarry, max_speed, sync_time):
    """Raise unless the carry, ``sync_time`` and ``max_speed`` (0-d, or 1-d
    contiguous and not empty) share one card and one float dtype and the
    counters are int32: what the kernel takes."""
    t = carry.t
    dtype, card = t.dtype, t.get_device()
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"advance takes float32 or float64, got {dtype}")
    for x in (carry.dt, carry.t_hydro, carry.batch_dt_total, sync_time,
              max_speed):
        if x.get_device() != card or x.dtype is not dtype:
            raise ValueError("advance: the carry's times, sync_time and "
                             "max_speed must share one device and dtype")
    for x in (carry.batch_successful, carry.batch_skipped):
        if x.get_device() != card or x.dtype is not torch.int32:
            raise ValueError("advance: the carry's counters must be int32 "
                             "beside its times")
    if (max_speed.dim() > 1 or max_speed.numel() == 0
            or not max_speed.is_contiguous()):
        raise ValueError("advance: max_speed must be 0-d or a non-empty "
                         "contiguous 1-d tensor of partial maxima")


def advance(carry: StepCarry, max_speed, sync_time, end_time, dx,
            params: plain.TimestepParams) -> StepCarry:
    """``ops.timestep.advance`` in one launch on CUDA tensors, the plain
    version on CPU tensors; ``max_speed`` may be 1-d partial maxima."""
    dev = carry.t.device
    if dev.type == "cpu":
        return plain.advance(carry, max_speed, sync_time, end_time, dx,
                             params)
    if dev.type != "cuda":
        raise ValueError(f"advance runs on CUDA or CPU tensors, not {dev}")
    _check(carry, max_speed, sync_time)
    dtype = carry.t.dtype
    times = torch.empty(4, dtype=dtype, device=dev)
    counts = torch.empty(2, dtype=torch.int32, device=dev)
    fn = _lib().advance_f32 if dtype == torch.float32 else _lib().advance_f64
    # The C entry point guards the device itself, and the raw stream of
    # the carry's card is PyTorch's current one there: both cost well
    # under a microsecond, torch.cuda.device and current_stream() several.
    err = fn(max_speed.data_ptr(), max_speed.numel(),
             *(x.data_ptr() for x in carry), sync_time.data_ptr(),
             times.data_ptr(), counts.data_ptr(),
             _ladder(params, float(dx), float(end_time)),
             int(params.dynamic), dev.index,
             torch._C._cuda_getCurrentRawStream(dev.index))
    raise_on(err, "advance")
    advance.launches += 1
    return StepCarry(*times.unbind(), *counts.unbind())


# Kernel launches since the last reset (the plain version never counts).
advance.launches = 0
KERNELS = (advance,)
