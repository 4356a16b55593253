"""The launch geometry of the row-marching kernels K1, K3, K4 (one halo
lane per warp side), K5a-C and K5b (two) (hipims_tpu_torch/ops/kernels/
geometry.py), on the CPU: at either halo width every cell is written by
exactly one lane of one block, the partials buffer has one slot per block,
the main paths' grid fills an H100 several times over, and the constants
that csrc/march.cuh repeats agree."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hs

from hipims_tpu_torch.ops.godunov import SchemeParams
from hipims_tpu_torch.ops.kernels import geometry as G
from hipims_tpu_torch.state import DomainStatic, FlowState

H100_SMS = 132
# (rows, cols): the card tests' shapes, chip_smoke's cases, and shapes one
# more than a chunk or strip multiple.
SHAPES = [(3, 3), (4, 4), (5, 5), (4, 37), (33, 65), (130, 97), (65, 121),
          (65, 113), (32, 128), (1408, 1408), (1409, 1411), (2944, 3072),
          (2945, 3073), (3000, 3100), (17, 241), (3, 3100), (3000, 3),
          (1297, 1441), (1297, 1681)]
HALOS = pytest.mark.parametrize("halo", G.HALOS)


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
    strip = G.strip(geom.halo)
    assert chunk >= 1 and strip == G.lane_cols(geom.halo) * G.WARPS
    assert gx * strip >= geom.cols and gy * chunk >= geom.rows
    assert gy <= 65535


@HALOS
@pytest.mark.parametrize("rows,cols", SHAPES)
def test_every_cell_written_once(rows, cols, halo):
    _check(G.march_geometry(rows, cols, halo=halo))


@HALOS
@pytest.mark.parametrize("chunk", [1, 2, 7, 16, 64, 200])
def test_every_cell_written_once_any_chunk(chunk, halo):
    for rows, cols in ((3, 3), (65, 121), (65, 113), (130, 97),
                       (1409, 1411)):
        geom = G.march_geometry(rows, cols, chunk=chunk, halo=halo)
        assert geom.chunk == chunk and geom.halo == halo
        _check(geom)


@settings(max_examples=60, deadline=None)
@given(rows=hs.integers(3, 3000), cols=hs.integers(3, 3100),
       chunk=hs.one_of(hs.none(), hs.integers(1, 300)),
       halo=hs.sampled_from(G.HALOS))
def test_every_cell_written_once_drawn(rows, cols, chunk, halo):
    _check(G.march_geometry(rows, cols, chunk=chunk, halo=halo))


@HALOS
@pytest.mark.parametrize("rows,cols", SHAPES)
def test_one_partials_slot_per_block(rows, cols, halo):
    """block_max_store writes block (bx, by) to slot by * grid_x + bx: the
    slots are distinct and fill the buffer the wrapper allocates."""
    geom = G.march_geometry(rows, cols, halo=halo)
    gx, gy = geom.grid
    slots = {by * gx + bx for by in range(gy) for bx in range(gx)}
    assert geom.partials == gx * gy == len(slots)
    assert slots == set(range(geom.partials))


@pytest.mark.parametrize("halo,shape", [(1, (65, 121)), (2, (65, 113))])
def test_ragged_card_shape_is_one_past_chunk_and_strip(halo, shape):
    """The card tests' ragged shapes end one row past a chunk and one
    column past a strip: (65, 121) of the one-lane halo, (65, 113) of the
    two-lane halo, also one column past a warp's 28."""
    rows, cols = shape
    geom = G.march_geometry(rows, cols, halo=halo)
    assert rows % geom.chunk == 1 and cols % G.strip(halo) == 1
    assert cols % G.lane_cols(halo) == 1
    assert geom.grid == (2, rows // geom.chunk + 1)


@HALOS
def test_chip_smoke_ragged_case_is_one_past_chunk_and_strip(halo):
    """chip_smoke's ragged case ends one row past a chunk and one column
    past a strip of either geometry."""
    import chip_smoke

    (rows, cols), = [c[:2] for c in chip_smoke.CASES if c[:2] == (1297, 1681)]
    geom = G.march_geometry(rows, cols, halo=halo)
    assert rows % geom.chunk == 1 and cols % G.strip(halo) == 1


@HALOS
def test_main_path_grid_fills_the_card(halo):
    """At the main paths' 2944 x 3072 the grid gives at least 4 blocks per
    SM of an H100."""
    geom = G.march_geometry(2944, 3072, halo=halo)
    assert geom.partials >= 4 * H100_SMS
    assert G.CHUNK_MIN <= geom.chunk <= G.CHUNK_MAX


def test_rejects_bad_grids():
    for rows, cols, chunk, halo in ((0, 5, None, 1), (5, 0, None, 1),
                                    (5, 5, 0, 1), (5, 5, None, 0),
                                    (5, 5, None, 3)):
        with pytest.raises(ValueError):
            G.march_geometry(rows, cols, chunk=chunk, halo=halo)


def test_constants_match_march_header():
    header = (Path(G.__file__).parents[2] / "csrc" / "march.cuh").read_text()
    found = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", header))
    assert int(found["MARCH_WARPS"]) == G.WARPS
    assert found["MARCH_THREADS"] == "32 * MARCH_WARPS"
    assert G.THREADS == 32 * G.WARPS
    flat = " ".join(header.split())
    assert ("constexpr int lane_cols(int halo) { return 32 - 2 * halo; }"
            in flat)
    assert ("constexpr int strip(int halo) { return lane_cols(halo) * "
            "MARCH_WARPS; }" in flat)
    assert [G.lane_cols(h) for h in G.HALOS] == [30, 28]
    assert [G.strip(h) for h in G.HALOS] == [120, 112]


def test_corrector_halos_match_muscl_source(monkeypatch):
    """K3 takes one halo lane, K5a-C and K5b two, in the wrapper and in
    csrc/muscl_split.cu corrector_halo; K5b's launcher sizes its launch
    and partials for the two-lane halo and, without mesh options, passes
    the one-device mesh window."""
    from hipims_tpu_torch.ops.kernels import muscl_split as ms
    from hipims_tpu_torch.ops.kernels.common import mesh_window

    src = Path(G.__file__).parents[2] / "csrc" / "muscl_split.cu"
    flat = " ".join(src.read_text().split())
    assert "return slopes == LOADED ? 1 : 2;" in flat
    assert ("enum SlopeSource { LOADED = 0, REBUILT = 1, PREDICTED = 2 };"
            in flat)
    assert (ms.LOADED, ms.REBUILT, ms.PREDICTED) == (0, 1, 2)
    assert ms.CORRECTOR_HALO == {ms.LOADED: 1, ms.REBUILT: 2,
                                 ms.PREDICTED: 2}
    assert ms.CORRECTOR_PLANES[ms.PREDICTED] == 0

    # _fused_cuda up to its launch, on CPU tensors: the geometry and the
    # partials it hands the C entry point.
    seen = {}

    def launch(lib, name, who, inputs, state, comp, dt, n_partials, args):
        seen.update(name=name, inputs=len(inputs), partials=n_partials,
                    args=args)

    monkeypatch.setattr(ms, "launch_step", launch)
    monkeypatch.setattr(ms, "_lib", lambda: None)
    rows, cols = 65, 113
    planes = [torch.zeros(rows, cols, dtype=torch.float64)
              for _ in range(6)]
    params = SchemeParams(2.0, 2.0)
    dt = torch.tensor(0.05, dtype=torch.float64)
    for chunk in (None, 15):
        ms._fused_cuda(FlowState(*planes[:4]), DomainStatic(*planes[4:]),
                       dt, params, None, chunk=chunk)
        geom = G.march_geometry(rows, cols, chunk=chunk, halo=2)
        assert seen == dict(name="muscl_fused", inputs=6,
                            partials=geom.partials,
                            args=(rows, cols, *geom.args(),
                                  *mesh_window((rows, cols)), 0.5, 0.5,
                                  params.very_small, params.quite_small, 1))
    assert geom.grid == (2, 5)
