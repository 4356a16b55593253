"""Dummy cells that the tests add to a copy of the benchmark, as a later
PR would add a cell: a configuration, a traffic and a limits file, and
entries in BENCHMARK.json; no file of the benchmark edited.

The configuration is the dam break's valley cut to a tiny grid, run by
the first-order Godunov step (kernel K1 on the card) in float64, with an
optional ``layout``; the traffic rains radar frames of 100 m cells on
it, from the reservoir or from dry.
"""

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
TINY = {"rows": 32, "cols": 48}
LAYOUT_2X2 = {"ranks": 4, "mesh_shape": [2, 2], "sync": "timestep"}
RADAR = {"kind": "radar", "generator": "uniform_cells",
         "resolution_m": 100.0, "interval_s": 20.0,
         "rate_mm_h": [200.0, 2000.0]}
# Limits read on the CPU at this size, float64 program against float64
# reference.  Sound runs: the four-rank reservoir cell reads depth gaps of
# 1.8e-11 m and a volume gap of 2.9e-15; the one-device radar cell from
# dry, over seven seeds, depth gaps of 6.0e-9 to 2.0e-8 m and volume gaps
# of 2.6e-12 to 1.2e-9 with open edges (4.6e-8 m and 2.7e-12 closed); the
# rasters, float32, 9.5e-7 m at most.  Faults: the exchange left out 24 m
# and 2.5e-2; the frame index a record ahead 1.9e-2 m or more and 1.4e-2
# or more; rain on the ring 2.5e-2 m and 0.17 (three seeds each).
LIMITS = {"compared": {"time_gap_s": 0.0, "state_depth_gap_max_m": 1e-6,
                       "state_depth_volume_gap": 1e-7,
                       "raster_depth_gap_max_m": 1e-4}}


def add_cell(root, name, *, layout=None, initial="terrain", edges="closed",
             segment_s=60.0, output_times_s=(60.0,), boundaries=(RADAR,)):
    """Copy the benchmark under ``root`` and add the cell ``dummy.<name>``
    (configuration ``dummy-<name>``, traffic ``<name>``); returns the
    cell's name.  Open ``edges`` keep the bed on the ring that the
    forcing leaves out, where closed ones raise walls."""
    root = Path(root)
    if not (root / "portbench").exists():
        shutil.copytree(ROOT / "portbench", root / "portbench",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "BENCHMARK.json", root)
    pb = root / "portbench"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    config = json.loads((pb / "configs" / "malpasset-10m.json").read_text())
    config.update(TINY, scheme="godunov", edges=edges,
                  floatingPointPrecision="double-strict",
                  scheme_kernels=["godunov_kernel"])
    if layout:
        config["layout"] = layout
    (pb / "configs" / f"dummy-{name}.json").write_text(json.dumps(config))
    (pb / "traffic" / f"{name}.json").write_text(json.dumps({
        "description": f"a test's {name}", "initial": initial,
        "segment_s": segment_s, "output_times_s": list(output_times_s),
        "outputs": ["depth"], "boundaries": list(boundaries)}))
    workload = f"dummy.{name}"
    (pb / "cells" / f"{workload}.json").write_text(json.dumps(LIMITS))
    bench["configs"].append({
        "name": f"dummy-{name}", "source": "a test",
        "file": f"portbench/configs/dummy-{name}.json", "reduced": [],
        "why": "a test's dummy configuration"})
    bench["workloads"].append({
        "name": workload, "config": f"dummy-{name}", "traffic": name,
        "chips": layout["ranks"] if layout else 1,
        "why": "a test's dummy cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return workload
