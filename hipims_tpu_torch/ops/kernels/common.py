"""Shared by the kernel wrappers: which device a call runs on, what the
kernels take, how a refused launch is reported, and the result a fused
step's plain version returns."""

from __future__ import annotations

import torch

from ...state import FlowState
from ..boundaries import interior_force_mask
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


def launch_step(lib, name, who, inputs, state, comp, dt, n_partials, args,
                partials=False):
    """Launch the step kernel ``name``_f32 or ``name``_f64 of ``lib``: it
    reads the planes ``inputs`` (pointers; None where the kernel takes no
    plane) and, in f32, ``comp``; writes the four planes of the new state,
    the new comp and ``n_partials`` partial CFL maxima; and takes
    ``args`` after dt.  Returns (new_state, max_wave_speed[, comp_new]):
    the 0-d max of the partials, or with ``partials`` the 1-d partials
    themselves, which ``timestep.advance`` folds in its own launch."""
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
    speed = speeds if partials else torch.amax(speeds)
    return (new, speed) if comp is None else (new, speed, comp_out)


def mesh_window(shape, origin=None, logical=None, speed_window=None):
    """The kernels' MeshWindow (``csrc/march.cuh``) as 8 ints, and the
    check of the three mesh options of a step: ``origin`` (oy, ox), the
    global index of the array's [0, 0] cell; ``logical`` (rows, cols), the
    logical grid whose static ring is frozen in global coordinates; and
    ``speed_window`` (r0, nr, c0, nc), the array's owned cells, the only
    ones that feed the CFL max.  None is the one-device default: the array
    is the logical grid and owns every cell."""
    rows, cols = shape
    oy, ox = (0, 0) if origin is None else (int(v) for v in origin)
    lr, lc = (rows, cols) if logical is None else (int(v) for v in logical)
    r0, nr, c0, nc = ((0, rows, 0, cols) if speed_window is None
                      else (int(v) for v in speed_window))
    if not (0 <= r0 and nr >= 1 and r0 + nr <= rows
            and 0 <= c0 and nc >= 1 and c0 + nc <= cols):
        raise ValueError(f"speed_window {(r0, nr, c0, nc)} is not a "
                         f"non-empty window of the {rows}x{cols} array")
    return oy, ox, lr, lc, r0, nr, c0, nc


def plain_step_result(state, out, comp, static, params, simplified_speed,
                      radius=1, origin=None, logical=None,
                      speed_window=None):
    """What a fused step kernel returns, from its plain version's
    whole-grid step ``out`` of ``state`` (a FlowState, or (FlowState,
    comp_new) when ``comp`` is given): (new_state, max_wave_speed[,
    comp_new]).  With the mesh options (``mesh_window``) the cells on the
    logical ring of width ``radius`` keep their old values, comp included,
    and the max covers the owned cells only, as ``parallel/halo_deep.py``
    of the JAX package does around its XLA step."""
    new, comp_new = (out, None) if comp is None else out
    window = mesh_window(state.z.shape, origin, logical, speed_window)
    if origin is not None or logical is not None:
        ring = ~interior_force_mask(state.z.shape, radius, state.z.device,
                                    window[:2], window[2:4])
        new = FlowState(*(torch.where(ring, o, v) for o, v in zip(state,
                                                                   new)))
        if comp is not None:
            comp_new = torch.where(ring, comp, comp_new)
    r0, nr, c0, nc = window[4:]
    own = (slice(r0, r0 + nr), slice(c0, c0 + nc))
    speed = max_wave_speed(new.z[own], new.zmax[own], new.qx[own],
                           new.qy[own], static.zb[own], params.quite_small,
                           simplified_speed)
    return (new, speed) if comp is None else (new, speed, comp_new)
