"""Flow-state, static-field and time-controller NamedTuples of tensors.

The same struct-of-arrays layout as the JAX package: each prognostic field
is its own ``(rows, cols)`` row-major plane, row 0 = south, north = +row.
All four prognostic fields share one dtype (float32 or float64).  Unlike
the TPU build there is no tile padding: the logical grid IS the tensor.

``from_numpy`` / ``to_numpy`` move a state, static field set or carry
between host numpy arrays (for example the JAX package's, read back with
``np.asarray``) and tensors on a chosen device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import constants as C


class FlowState(NamedTuple):
    """Prognostic per-cell state.

    z:    free-surface level (FSL)       [m]
    zmax: maximum FSL seen so far        [m]  (NODATA marks disabled cells)
    qx:   unit-width discharge, x        [m^2/s]
    qy:   unit-width discharge, y        [m^2/s]
    """

    z: torch.Tensor
    zmax: torch.Tensor
    qx: torch.Tensor
    qy: torch.Tensor

    @property
    def shape(self):
        return self.z.shape

    @property
    def dtype(self):
        return self.z.dtype


class DomainStatic(NamedTuple):
    """Time-invariant per-cell data: bed elevation and Manning's n."""

    zb: torch.Tensor
    manning: torch.Tensor


class StepCarry(NamedTuple):
    """0-d device scalars advanced by the per-step time controller:
    simulation time, current timestep (<= 0 suspends the step), the
    hydrological accumulator and the counters the host reads per batch."""

    t: torch.Tensor
    dt: torch.Tensor
    t_hydro: torch.Tensor
    batch_dt_total: torch.Tensor
    batch_successful: torch.Tensor
    batch_skipped: torch.Tensor


def initial_carry(dtype, device, t0=0.0, dt0=0.01) -> StepCarry:
    """Fresh carry at simulation start."""
    def f(v):
        return torch.tensor(v, dtype=dtype, device=device)

    def i(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    return StepCarry(t=f(t0), dt=f(dt0), t_hydro=f(0.0),
                     batch_dt_total=f(0.0), batch_successful=i(0),
                     batch_skipped=i(0))


def make_initial_state(zb, depth=None, fsl=None, qx=None, qy=None,
                       active=None, *, dtype, device) -> FlowState:
    """FlowState from a bed raster plus optional initial conditions.

    Every input is cast to ``dtype`` BEFORE it is combined (z = zb + depth
    rounds once in the working precision), as the JAX package does.
    Disabled cells (``active == False``) carry NODATA in z and zmax."""
    def t(a):
        return torch.as_tensor(np.array(a), device=device).to(dtype)

    zb = t(zb)
    if fsl is not None:
        z = torch.maximum(t(fsl), zb)
    elif depth is not None:
        z = zb + t(depth)
    else:
        z = zb.clone()
    qx = torch.zeros_like(zb) if qx is None else t(qx)
    qy = torch.zeros_like(zb) if qy is None else t(qy)
    zmax = z
    if active is not None:
        act = torch.as_tensor(np.asarray(active, dtype=bool), device=device)
        z = torch.where(act, z, C.NODATA)
        zmax = torch.where(act, zmax, C.NODATA)
        qx = torch.where(act, qx, 0.0)
        qy = torch.where(act, qy, 0.0)
    return FlowState(z=z, zmax=zmax.clone(), qx=qx, qy=qy)


_BY_FIELDS = {cls._fields: cls for cls in (FlowState, DomainStatic,
                                           StepCarry)}


def from_numpy(value, device, dtype=None):
    """Host arrays -> tensors on ``device``.

    ``value`` is one array or any NamedTuple whose fields are those of
    FlowState, DomainStatic or StepCarry (the JAX package's tuples
    qualify); the result is the matching NamedTuple of this package.
    ``dtype`` casts the floating-point fields only (the carry's int32
    counters stay integers)."""
    def conv(a):
        x = torch.as_tensor(np.array(a, copy=True), device=device)
        if dtype is not None and x.is_floating_point():
            x = x.to(dtype)
        return x

    fields = getattr(value, "_fields", None)
    if fields is None:
        return conv(value)
    cls = _BY_FIELDS.get(tuple(fields))
    if cls is None:
        raise TypeError(f"no port NamedTuple has the fields {fields}")
    return cls(*(conv(a) for a in value))


def to_numpy(value):
    """Tensors -> host numpy arrays, keeping the NamedTuple type."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return type(value)(*(a.detach().cpu().numpy() for a in value))
