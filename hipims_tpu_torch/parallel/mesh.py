"""The device mesh and the blocks it splits a grid into.

A ``Mesh`` is a (py, px) array of torch devices, under ``.devices`` as in
``jax.sharding.Mesh``: rows of the grid are split over the first axis,
columns over the second.  The reference only ever splits domains row-wise
(src/Domain/Links/CDomainLink.cpp:297-336 assumes matching columns); here,
as in the JAX package, the split is two-dimensional, so the halo bytes
scale with a block's perimeter, not with the grid's width.

Under a process group (``parallel/distributed.py``) the mesh also says
which rank owns each block: the blocks are dealt out in row-major order in
contiguous equal groups, one group per rank (the JAX package's device
order, process-major), and a rank's blocks sit on its ``rank_device``.

The JAX package's ``grid_sharding``, ``replicated`` and
``shard_simulation_arrays`` are JAX sharding objects and have no
counterpart: ``parallel/halo_deep.py`` places the blocks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import distributed


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (py, px) numpy object array of ``torch.device``s and the (py, px)
    ranks that own the blocks (all 0 in one process)."""

    devices: np.ndarray
    ranks: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.ranks is None:
            object.__setattr__(self, "ranks",
                               np.zeros(self.devices.shape, dtype=np.int64))

    @property
    def shape(self) -> Tuple[int, int]:
        return self.devices.shape

    def first_device(self, rank: int = 0) -> torch.device:
        """The device of ``rank``'s first block in row-major order."""
        owned = np.argwhere(self.ranks == rank)
        if len(owned) == 0:
            raise ValueError(f"rank {rank} owns no block of the "
                             f"{self.shape} mesh")
        return self.devices[tuple(owned[0])]


def _factor_2d(n: int) -> Tuple[int, int]:
    """Most-square factorisation of n (rows x cols)."""
    best = (1, n)
    for a in range(1, int(math.isqrt(n)) + 1):
        if n % a == 0:
            best = (a, n // a)
    return best


def make_mesh(n_devices: Optional[int] = None,
              shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A 2-D mesh of ``n_devices`` blocks (by default the product of
    ``shape``, else one per device and rank), of ``shape`` (by default the
    most square factorisation).

    ``devices=None`` means the visible CUDA devices, repeated round-robin
    when there are fewer than ``n_devices``: several blocks then share a
    card, as the JAX tests' virtual CPU devices share one host, and one
    H100 runs a 2x2 mesh.  A CPU caller passes
    ``devices=[torch.device("cpu")] * n``; an explicit list must hold at
    least ``n_devices`` entries.

    Under a process group of W ranks, block k (row-major) belongs to rank
    k // (n / W), and ``n_devices % W != 0`` raises ValueError; with
    ``devices=None`` a rank's blocks sit on its ``rank_device``."""
    world = distributed.world_size()
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "devices=[torch.device('cpu')] * n for a CPU "
                               "mesh")
        n = n_devices or (shape[0] * shape[1] if shape else count * world)
        if world == 1:
            devices = [torch.device("cuda", i % count) for i in range(n)]
        else:
            mine = distributed.rank_device("gpu")
            devices = [mine if _owner(k, n, world) == distributed.rank()
                       else torch.device("cuda", _owner(k, n, world) % count)
                       for k in range(n)]
    devices = [torch.device(d) for d in devices]
    n = n_devices or (shape[0] * shape[1] if shape else len(devices))
    if shape is None:
        shape = _factor_2d(n)
    shape = (int(shape[0]), int(shape[1]))
    if shape[0] < 1 or shape[1] < 1 or shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    if len(devices) < n:
        raise ValueError(f"make_mesh: {n} blocks need {n} devices, got "
                         f"{len(devices)}")
    if n % world:
        raise ValueError(f"make_mesh: {n} blocks do not split evenly over "
                         f"{world} ranks")
    grid = np.empty(shape, dtype=object)
    ranks = np.empty(shape, dtype=np.int64)
    for k in range(n):
        grid[k // shape[1], k % shape[1]] = devices[k]
        ranks[k // shape[1], k % shape[1]] = _owner(k, n, world)
    return Mesh(grid, ranks)


def _owner(k: int, n: int, world: int) -> int:
    """The rank of block k of n: contiguous equal groups in row-major
    order."""
    return k // max(n // world, 1)


def block_spans(n: int, parts: int):
    """[(start, size)] of ``parts`` consecutive spans covering ``n`` cells
    as evenly as possible: the first ``n % parts`` spans are one cell
    longer.  An even split (every grid of the JAX tests and the 9.04
    M-cell model) gives equal spans; an uneven one, which the JAX
    package's shard_map cannot take, differs by at most one cell."""
    base, extra = divmod(n, parts)
    spans, start = [], 0
    for k in range(parts):
        size = base + (1 if k < extra else 0)
        spans.append((start, size))
        start += size
    return spans


def block_geometry(rows: int, cols: int, shape):
    """{(iy, ix): (r0, nr, c0, nc)}: the rows [r0, r0 + nr) and columns
    [c0, c0 + nc) of the logical grid that block (iy, ix) of a ``shape``
    mesh owns.  The blocks cover the grid once."""
    ys, xs = block_spans(rows, shape[0]), block_spans(cols, shape[1])
    return {(iy, ix): (r0, nr, c0, nc)
            for iy, (r0, nr) in enumerate(ys)
            for ix, (c0, nc) in enumerate(xs)}
