"""The float64 reference in row blocks (``reference.run_blocks``) against
the whole grid on one device (``reference.run``), on the CPU: the same
bits at every sync time, for one, two and four blocks of a row count
that four does not divide, under both schemes, uniform and gridded rain,
and syncs that the runs idle at; and different planes with the blocks'
halo trade left out.

The grids' interior widths (the columns inside the scheme's edge ring)
are multiples of 16 cells.  On the CPU, torch's ``pow`` rounds the
elements of its vectorised loop and those of the loop's scalar tail
differently in the last bit, and a block's tail falls on other cells
than the whole grid's; at these widths no loop has a tail.  On the card
every element runs the same code, whatever the width.

    python -m pytest --noconftest -p no:cacheprovider portbench/tests
"""

import numpy as np
import pytest
from dummy_cells import RADAR, add_cell

from portbench import model_dir, spec
from portbench.reference import model as reference
from portbench.reference import swe

SEED = 2147484003
SYNCS = [9.0, 21.0]
COLS = {"godunov": 50, "muscl-hancock": 52}
RAIN = {"gridded": RADAR,
        "uniform": {"kind": "rain", "series": [[0.0, 400.0], [12.0, 90.0],
                                               [3600.0, 90.0]]}}


def _model(tmp_path, scheme, rain):
    """The reference's model of a dummy cell: the valley's reservoir
    released, rained on, ``scheme`` on 30 rows."""
    workload = add_cell(tmp_path, rain, boundaries=[RAIN[rain]],
                        segment_s=SYNCS[-1], output_times_s=SYNCS[:-1])
    bench = spec.benchmark(tmp_path)
    config = spec.config(bench, spec.cell(bench, workload)["config"],
                         tmp_path)
    config.update(rows=30, cols=COLS[scheme], scheme=scheme)
    traffic = spec.traffic(rain, tmp_path)
    return reference.load(model_dir.write(tmp_path / "model", config,
                                          traffic, SEED))


def _same(a, b):
    return all(x["t"] == y["t"] and x["t_hydro"] == y["t_hydro"]
               and x["steps"] == y["steps"]
               and all(np.array_equal(p, q)
                       for p, q in zip(x["state"], y["state"]))
               for x, y in zip(a, b))


@pytest.mark.parametrize("rain", ["uniform", "gridded"])
@pytest.mark.parametrize("scheme", ["godunov", "muscl-hancock"])
def test_blocks_give_the_whole_grids_bits(tmp_path, monkeypatch, scheme,
                                          rain):
    model = _model(tmp_path, scheme, rain)
    idle = []
    real = swe.advance

    def counted(c, *args):
        idle.append(float(c.dt) <= 0.0)
        return real(c, *args)

    monkeypatch.setattr(swe, "advance", counted)
    whole = list(reference.run(model, SYNCS, "cpu", check_every=16))
    assert any(idle) and [o["t"] for o in whole] == SYNCS
    wet = whole[-1]["state"][0] - whole[-1]["state"][4]
    assert (wet[1:-1, 1:-1] > 1e-3).any()
    for n in (1, 2, 4):
        blocks = list(reference.run_blocks(model, SYNCS, ["cpu"] * n,
                                           check_every=16))
        assert _same(whole, blocks), n


def test_blocks_without_the_halo_trade_differ(tmp_path, monkeypatch):
    model = _model(tmp_path, "muscl-hancock", "gridded")
    whole = list(reference.run(model, SYNCS, "cpu", check_every=16))
    monkeypatch.setattr(reference, "trade_halos", lambda blocks: None)
    blocks = list(reference.run_blocks(model, SYNCS, ["cpu"] * 2,
                                       check_every=16))
    assert not _same(whole, blocks)
    assert not np.array_equal(whole[-1]["state"][0], blocks[-1]["state"][0])


def test_row_blocks_are_even_and_refuse_thin_blocks(tmp_path):
    assert reference.row_blocks(30, 4) == [(0, 8), (8, 16), (16, 23),
                                           (23, 30)]
    model = _model(tmp_path, "muscl-hancock", "uniform")
    with pytest.raises(ValueError, match="halo rows"):
        next(reference.run_blocks(model, SYNCS, ["cpu"] * 16))
