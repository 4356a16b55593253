"""The launch geometry of the row-marching kernels K1 and K3
(hipims_tpu_torch/ops/kernels/geometry.py), on the CPU: every cell is
written by exactly one lane of one block, the partials buffer has one slot
per block, the main paths' grid fills an H100 several times over, and the
constants that csrc/march.cuh repeats agree."""

import re
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as hs

from hipims_tpu_torch.ops.kernels import geometry as G

H100_SMS = 132
# (rows, cols): the card tests' shapes, chip_smoke's cases, and shapes one
# more than a chunk or strip multiple.
SHAPES = [(3, 3), (4, 4), (5, 5), (4, 37), (33, 65), (130, 97), (65, 121),
          (32, 128), (1408, 1408), (1409, 1411), (2944, 3072), (2945, 3073),
          (3000, 3100), (17, 241), (3, 3100), (3000, 3), (1297, 1441)]


def _cover(geom):
    """How often each row and each column is written.  Block (bx, by)
    writes its rows times its writing lanes' columns, so each cell is
    written once exactly when every row count and column count is 1."""
    rows = np.zeros(geom.rows, int)
    for by in range(geom.grid[1]):
        r = geom.block_rows(by)
        assert len(r) > 0, f"block row {by} writes nothing"
        rows[r.start:r.stop] += 1
    cols = np.zeros(geom.cols, int)
    for bx in range(geom.grid[0]):
        col, writes = geom.lane_columns(bx)
        assert writes.any(), f"strip {bx} writes nothing"
        assert col[writes].min() >= 0
        np.add.at(cols, col[writes], 1)
    return rows, cols


def _check(geom):
    rows, cols = _cover(geom)
    assert (rows == 1).all() and (cols == 1).all()
    # What the C launchers accept (csrc/march.cuh march_geometry_ok).
    chunk, gx, gy = geom.args()
    assert chunk >= 1 and G.STRIP == G.LANE_COLS * G.WARPS
    assert gx * G.STRIP >= geom.cols and gy * chunk >= geom.rows
    assert gy <= 65535


@pytest.mark.parametrize("rows,cols", SHAPES)
def test_every_cell_written_once(rows, cols):
    _check(G.march_geometry(rows, cols))


@pytest.mark.parametrize("chunk", [1, 2, 7, 16, 64, 200])
def test_every_cell_written_once_any_chunk(chunk):
    for rows, cols in ((3, 3), (65, 121), (130, 97), (1409, 1411)):
        geom = G.march_geometry(rows, cols, chunk=chunk)
        assert geom.chunk == chunk
        _check(geom)


@settings(max_examples=60, deadline=None)
@given(rows=hs.integers(3, 3000), cols=hs.integers(3, 3100),
       chunk=hs.one_of(hs.none(), hs.integers(1, 300)))
def test_every_cell_written_once_drawn(rows, cols, chunk):
    _check(G.march_geometry(rows, cols, chunk=chunk))


@pytest.mark.parametrize("rows,cols", SHAPES)
def test_one_partials_slot_per_block(rows, cols):
    """block_max_store writes block (bx, by) to slot by * grid_x + bx: the
    slots are distinct and fill the buffer the wrapper allocates."""
    geom = G.march_geometry(rows, cols)
    gx, gy = geom.grid
    slots = {by * gx + bx for by in range(gy) for bx in range(gx)}
    assert geom.partials == gx * gy == len(slots)
    assert slots == set(range(geom.partials))


def test_ragged_card_shape_is_one_past_chunk_and_strip():
    """The card tests' ragged shape (65, 121) ends one row past a chunk
    and one column past a strip."""
    geom = G.march_geometry(65, 121)
    assert 65 % geom.chunk == 1 and 121 % G.STRIP == 1
    assert geom.grid == (2, 65 // geom.chunk + 1)


def test_chip_smoke_ragged_case_is_one_past_chunk_and_strip():
    import chip_smoke

    (rows, cols), = [c[:2] for c in chip_smoke.CASES if c[:2] == (1297, 1441)]
    geom = G.march_geometry(rows, cols)
    assert rows % geom.chunk == 1 and cols % G.STRIP == 1


def test_main_path_grid_fills_the_card():
    """At the main paths' 2944 x 3072 the grid gives at least 4 blocks per
    SM of an H100."""
    geom = G.march_geometry(2944, 3072)
    assert geom.partials >= 4 * H100_SMS
    assert G.CHUNK_MIN <= geom.chunk <= G.CHUNK_MAX


def test_rejects_bad_grids():
    for rows, cols, chunk in ((0, 5, None), (5, 0, None), (5, 5, 0)):
        with pytest.raises(ValueError):
            G.march_geometry(rows, cols, chunk=chunk)


def test_constants_match_march_header():
    header = (Path(G.__file__).parents[2] / "csrc" / "march.cuh").read_text()
    found = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", header))
    assert int(found["MARCH_WARPS"]) == G.WARPS
    assert int(found["LANE_COLS"]) == G.LANE_COLS == G.WARP - 2
    assert found["MARCH_THREADS"] == "32 * MARCH_WARPS"
    assert found["STRIP"] == "LANE_COLS * MARCH_WARPS"
    assert G.THREADS == 32 * G.WARPS
