"""Launch geometry of the row-marching kernels: the Godunov step K1 and
the partial-inertial step K4 (``csrc/stencil.cu``), and the MUSCL
corrector K3 (split12), K5a-C (recompute) and K5b (the whole step)
(``csrc/muscl_split.cu``).

A block is ``WARPS`` warps side by side.  Each warp loads 32 columns and
owns ``lane_cols(halo)`` of them, with ``halo`` halo lanes on either side,
so a block owns a strip of ``strip(halo)`` columns (``csrc/march.cuh``
computes both the same way); it marches down ``chunk`` rows.  K1, K3 and
K4 take one halo lane, K5a-C and K5b two (their first owned lane's west
face needs the slope of the column west of it, which needs one column
more).  The kernels compute where each lane works from the chunk and
their block index (``csrc/march.cuh`` ``march_pos``); ``lane_columns``
repeats that arithmetic so that the CPU tests can check the cover of the
grid.
Nothing here needs a card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

WARP = 32
WARPS = 4                  # csrc/march.cuh MARCH_WARPS
THREADS = WARPS * WARP
HALOS = (1, 2)             # the halo widths the kernels take


def lane_cols(halo: int) -> int:
    """The columns a warp owns (csrc/march.cuh lane_cols)."""
    return WARP - 2 * halo


def strip(halo: int) -> int:
    """The columns a block owns (csrc/march.cuh strip)."""
    return WARPS * lane_cols(halo)


# Rows per block: between CHUNK_MIN and CHUNK_MAX, as many as give about
# TARGET_BLOCKS blocks, 40 per SM of an H100's 132.  An SM holds 6-7 of
# these blocks in f32 (3-4 in f64: their registers bound it), so the grid
# runs in several waves and the last wave's tail is a small share, while a
# chunk of at least 8 rows re-solves at most one face row in eight (its
# first south face) and loads two halo rows.  On the card, 8-16 rows per
# block gave K1 and K3 their best times at 9.04 M cells, 64 rows 10-20%
# more (PERF.md).
CHUNK_MIN, CHUNK_MAX = 8, 64
TARGET_BLOCKS = 40 * 132


@dataclass(frozen=True)
class MarchGeometry:
    """What a row-marching launch takes: the rows per block, and the grid
    (strips, chunks) as (blockIdx.x, blockIdx.y), for warps with ``halo``
    halo lanes on either side."""

    rows: int
    cols: int
    chunk: int
    grid: tuple[int, int]
    halo: int

    @property
    def partials(self) -> int:
        """The size of the partials buffer: one CFL max per block, at
        blockIdx.y * grid[0] + blockIdx.x (swe_common.cuh
        block_max_store)."""
        return self.grid[0] * self.grid[1]

    def args(self):
        """(chunk, grid_x, grid_y), as the C launchers take them."""
        return (self.chunk, *self.grid)

    def block_rows(self, by: int) -> range:
        """The rows block row ``by`` writes."""
        r0 = by * self.chunk
        return range(r0, min(r0 + self.chunk, self.rows))

    def lane_columns(self, bx: int):
        """(columns, writes) of the THREADS lanes of a block in strip
        ``bx``, as ``march_pos`` computes them: the column each lane loads
        (before clamping) and whether it writes it."""
        t = np.arange(THREADS)
        lane = t % WARP
        h = self.halo
        col = bx * strip(h) + (t // WARP) * lane_cols(h) + lane - h
        return col, (lane >= h) & (lane < WARP - h) & (col < self.cols)


def march_geometry(rows: int, cols: int, chunk: int | None = None,
                   halo: int = 1):
    """The geometry of a row-marching launch over a (rows, cols) grid with
    ``halo`` halo lanes per warp side; ``chunk`` (rows per block) is chosen
    as the module's note says unless given."""
    if rows < 1 or cols < 1:
        raise ValueError(f"march_geometry: bad grid {rows}x{cols}")
    if halo not in HALOS:
        raise ValueError(f"march_geometry: halo must be one of {HALOS}, "
                         f"got {halo}")
    strips = math.ceil(cols / strip(halo))
    if chunk is None:
        per_strip = math.ceil(TARGET_BLOCKS / strips)
        chunk = min(CHUNK_MAX, max(CHUNK_MIN, math.ceil(rows / per_strip)))
    if chunk < 1:
        raise ValueError(f"march_geometry: chunk must be >= 1, got {chunk}")
    return MarchGeometry(rows, cols, chunk,
                         (strips, math.ceil(rows / chunk)), halo)
