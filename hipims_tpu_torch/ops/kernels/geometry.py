"""Launch geometry of the row-marching kernels: the Godunov step K1
(``csrc/stencil.cu``) and the split12 MUSCL corrector K3
(``csrc/muscl_split.cu``).

A block is ``WARPS`` warps side by side.  Each warp owns ``LANE_COLS``
columns and loads 32, with a halo lane on either side, so a block owns a
strip of ``STRIP`` columns (constants of ``csrc/march.cuh`` too); it
marches down ``chunk`` rows.  The kernels compute where each lane works
from the chunk and their block index (``csrc/march.cuh`` ``march_pos``);
``lane_columns`` repeats that arithmetic so that the CPU tests can check
the cover of the grid.  Nothing here needs a card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

WARP = 32
WARPS = 4                  # csrc/march.cuh MARCH_WARPS
LANE_COLS = WARP - 2       # csrc/march.cuh LANE_COLS
STRIP = WARPS * LANE_COLS  # csrc/march.cuh STRIP
THREADS = WARPS * WARP
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
    (strips, chunks) as (blockIdx.x, blockIdx.y)."""

    rows: int
    cols: int
    chunk: int
    grid: tuple[int, int]

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
        col = bx * STRIP + (t // WARP) * LANE_COLS + lane - 1
        return col, (lane >= 1) & (lane <= LANE_COLS) & (col < self.cols)


def march_geometry(rows: int, cols: int, chunk: int | None = None):
    """The geometry of a row-marching launch over a (rows, cols) grid;
    ``chunk`` (rows per block) is chosen as the module's note says unless
    given."""
    if rows < 1 or cols < 1:
        raise ValueError(f"march_geometry: bad grid {rows}x{cols}")
    strips = math.ceil(cols / STRIP)
    if chunk is None:
        per_strip = math.ceil(TARGET_BLOCKS / strips)
        chunk = min(CHUNK_MAX, max(CHUNK_MIN, math.ceil(rows / per_strip)))
    if chunk < 1:
        raise ValueError(f"march_geometry: chunk must be >= 1, got {chunk}")
    return MarchGeometry(rows, cols, chunk,
                         (strips, math.ceil(rows / chunk)))
