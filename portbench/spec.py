"""Finds everything of a cell by name from BENCHMARK.json: its
configuration (the file the entry names), its traffic
(``traffic/<traffic>.json``), its limits (``cells/<workload>.json``)
and the reader of each per-layer metric (``metrics/<name>.py``), so a
later cell, configuration or metric is added as files and entries.
``root`` is the checkout's root; the benchmark's files are under
``root/portbench``."""

from __future__ import annotations

import json
from pathlib import Path

from .model_dir import load_module

ROOT = Path(__file__).resolve().parents[1]


def _here(root):
    return Path(root) / "portbench"


def benchmark(root=ROOT):
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def cell(spec, workload):
    for w in spec["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config(spec, name, root=ROOT):
    for c in spec["configs"]:
        if c["name"] == name:
            return dict(json.loads((Path(root) / c["file"]).read_text()),
                        name=name)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name, root=ROOT):
    return json.loads((_here(root) / "traffic" / f"{name}.json").read_text())


def limits(workload, root=ROOT):
    return json.loads((_here(root) / "cells" / f"{workload}.json")
                      .read_text())


def metrics(spec, workload, kind):
    """The ``kind`` ("end_to_end" or "per_layer") metrics a cell reports:
    those that list it, and those that list no cells."""
    return [m for m in spec[kind]
            if workload in m.get("workloads", [workload])]


def reader(name, root=ROOT):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = _here(root) / "metrics" / f"{name}.py"
    return load_module(path, "portbench_metric_" + name.replace(".", "_")
                       .replace("-", "_")).read
