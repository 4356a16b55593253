"""The command's refusals, what a run loads, and a cell added by files
alone.  On this CPU machine the runs go through ``harness.run_cell`` at
tiny sizes on the CPU, an entry the command line cannot reach.

    python -m pytest --noconftest -p no:cacheprovider portbench/tests
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import spec

ROOT = Path(__file__).resolve().parents[2]
TINY = {"rows": 24, "cols": 48, "segment_s": 8.0, "output_times_s": [8.0]}
COMMAND = spec.benchmark()["command"]


def run_command(cwd, *extra):
    cmd = [sys.executable] + COMMAND[1:] + [
        "--workload", "malpasset-10m.dambreak", "--seed", "3000000001",
        "--seconds", "1", "--trace", "0", *extra]
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_command_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    res = run_command(ROOT)
    assert res.returncode != 0
    assert not res.stdout.strip()
    assert "CUDA" in res.stderr


def test_command_fails_in_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for p in spec.benchmark()["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    res = run_command(tmp_path)
    assert res.returncode != 0
    assert not res.stdout.strip()


def test_a_run_loads_no_jax_and_not_the_jax_package(tmp_path):
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from portbench import harness\n"
        f"r = harness.run_cell('malpasset-10m.dambreak', 7, 0.0, True,\n"
        f"    device='cpu', sizes={TINY!r})\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    tops = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert "hipims_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "hipims_tpu", "chip_smoke",
                       "kernel_ab"}


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A later PR's cell: a traffic file, a limits file, a metric reader
    and entries in BENCHMARK.json; no file of the benchmark edited.  The
    dummy cell rains on the dam break's valley, less a loss, so it also
    drives the reference's rain and loss."""
    from portbench import harness

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.benchmark()
    bench["workloads"].append({
        "name": "malpasset-10m.drizzle", "config": "malpasset-10m",
        "traffic": "drizzle", "chips": 1, "why": "a test's dummy cell"})
    bench["per_layer"].append({
        "name": "segment_steps", "unit": "steps", "better": "lower",
        "source": "program_counter", "layer": "model step (host batch loop)",
        "moves": "sim_speed", "workloads": ["malpasset-10m.drizzle"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = {"description": "a drizzle less a loss on the dry valley",
               "initial": "dry", "segment_s": 8.0, "output_times_s": [],
               "outputs": [],
               "boundaries": [
                   {"kind": "rain", "series": [[0.0, 30.0], [3600.0, 0.0]]},
                   {"kind": "loss", "series": [[0.0, 6.0], [3600.0, 6.0]]}]}
    pb = tmp_path / "portbench"
    (pb / "traffic" / "drizzle.json").write_text(json.dumps(traffic))
    (pb / "cells" / "malpasset-10m.drizzle.json").write_text(
        json.dumps({"compared": {"time_gap_s": 0.0,
                                 "state_depth_gap_max_m": 1e-4}}))
    (pb / "metrics" / "segment_steps.py").write_text(
        "def read(ctx):\n    return float(ctx.steps)\n")
    res = harness.run_cell("malpasset-10m.drizzle", 5, 0.0, True,
                           device="cpu", root=tmp_path,
                           sizes={"rows": 24, "cols": 48})
    assert res["correct"], res["compared"]
    assert res["metrics"]["segment_steps"]["value"] > 0
    assert "scheme_roofline" not in res["metrics"]
