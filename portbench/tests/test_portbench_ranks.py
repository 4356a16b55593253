"""A cell on several ranks, added by files alone, run on the CPU: four
gloo ranks of a 2x2 lock-step mesh (``ranks.launch``, the path that
``run.py`` takes for a cell on four chips), judged against the float64
reference in row blocks, one for each rank; the same run with the
exchange between ranks left out (halo strips never refreshed), which has
to come out not correct; and a rank killed mid-window, which has to end
the run.

    python -m pytest --noconftest -p no:cacheprovider portbench/tests
"""

import io
import json
import sys
import time

import pytest
from dummy_cells import LAYOUT_2X2, ROOT, add_cell

from portbench import harness, ranks

SEED = 2147483999
# A patched rank: the lines run before ranks.main.
NO_EXCHANGE = """
from hipims_tpu_torch.parallel.halo_deep import HaloDeepBlocks
HaloDeepBlocks._refresh_all = lambda self, states, comps: None
"""
KILL_RANK_2 = """
import json, os, signal, threading
from portbench import harness
if json.loads(sys.argv[1])["rank"] == 2:
    real = harness.Segments.run
    calls = []
    def run(self):
        calls.append(1)
        if len(calls) == 3:     # mid-way through the second timed segment
            threading.Timer(0.5, os.kill,
                            (os.getpid(), signal.SIGKILL)).start()
        return real(self)
    harness.Segments.run = run
"""


def launch(tmp_path, seconds=0.0, patch=None, deadline_s=240.0):
    """(exit code, rank 0's standard output) of a four-rank run of a
    dummy cell under ``tmp_path``, its ranks started with ``patch``."""
    workload = add_cell(tmp_path, "radar2x2", layout=LAYOUT_2X2)
    entry = None
    if patch:
        script = tmp_path / "rank.py"
        script.write_text(
            f"import sys\nsys.path.insert(0, {str(ROOT)!r})\n{patch}\n"
            "from portbench import ranks\nsys.exit(ranks.main())\n")
        entry = [sys.executable, str(script)]
    out = io.StringIO()
    rc = ranks.launch({"workload": workload, "seed": SEED,
                       "seconds": seconds, "trace": 0, "device": "cpu",
                       "root": str(tmp_path)}, 4, entry=entry, stdout=out,
                      deadline_s=deadline_s)
    return rc, out.getvalue()


def result_of(stdout):
    return json.loads(stdout.strip().splitlines()[-1])


def test_four_ranks_are_correct(tmp_path):
    rc, stdout = launch(tmp_path)
    assert rc == 0
    res = result_of(stdout)
    assert res["correct"], res["compared"]
    assert res["device"]["count"] == 4
    assert set(res["metrics"]) == {"sim_speed", "peak_mem_GiB", "setup_s"}
    # Judged by the reference in one row block for each rank.
    assert " steps on cpu, cpu, cpu, cpu\n" in stdout


def test_exchange_left_out_is_not_correct(tmp_path):
    rc, stdout = launch(tmp_path, patch=NO_EXCHANGE)
    assert rc == 0
    res = result_of(stdout)
    assert not res["correct"], res["compared"]


def test_a_dead_rank_ends_the_run(tmp_path):
    t0 = time.perf_counter()
    rc, stdout = launch(tmp_path, seconds=60.0, patch=KILL_RANK_2)
    assert rc != 0
    assert not stdout.strip()
    # Ended at once, not at the deadline or the collectives' time limit.
    assert time.perf_counter() - t0 < 100.0


def test_chips_must_match_the_layout(tmp_path):
    workload = add_cell(tmp_path, "radar2x2", layout=LAYOUT_2X2)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"][-1]["chips"] = 1
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(ValueError, match="layout of 4"):
        harness.run_cell(workload, SEED, 0.0, False, device="cpu",
                         root=tmp_path)
