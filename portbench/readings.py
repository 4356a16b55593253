#!/usr/bin/env python3
"""The readings that the limits of ``cells/<workload>.json`` were set
from, on the card, at the cell's own size, many seeds in one process:

    python3 portbench/readings.py --workload <name> --seeds 1,2,3
        [--control]              # and the control: plain float32
        [--faults godunov,flat,vanleer]

Each seed runs as the benchmark does (set-up, a warm segment, one timed
segment, the float64 reference) and prints one JSON line of every number
the check computes; the control and each fault follow on lines of their
own, judged against the same reference run.  The faults keep the water's
mass and are planted in the reference, which then stands in the
program's place: ``godunov`` (the first-order scheme in MUSCL-Hancock's
place), ``flat`` (every slope zero) and ``vanleer`` (van Leer's limiter
in minmod's place).  ``--device cpu --sizes '{"rows": 96, "cols": 168}'``
rehearses at a small size.  Not run by the benchmark's command.
"""

import argparse
import io
import json
import contextlib
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


@contextlib.contextmanager
def planted(fault):
    """The reference with ``fault`` planted: ``godunov`` (the first-order
    step in MUSCL-Hancock's place), ``flat`` (every slope zero) or
    ``vanleer`` (van Leer's limiter in minmod's place)."""
    import torch

    from portbench.reference import swe

    saved = swe.muscl_step, swe._slopes, swe._limited
    if fault == "godunov":
        swe.muscl_step = swe.godunov_step
    elif fault == "flat":
        swe._slopes = lambda lft, zbl, ctr, zbc, rgt, zbr, vs: tuple(
            torch.zeros_like(ctr[0]) for _ in range(4))
    elif fault == "vanleer":
        def vanleer(lft, ctr, rgt):
            rl, rr = ctr - lft, rgt - ctr
            r = torch.where(rl == 0.0, 0.0,
                            rr / torch.where(rl == 0.0, 1.0, rl))
            return (r + torch.abs(r)) / (1.0 + torch.abs(r)) * rl
        swe._limited = vanleer
    else:
        raise ValueError(f"no fault {fault!r} to plant in the reference")
    try:
        yield
    finally:
        swe.muscl_step, swe._slopes, swe._limited = saved


def planted_readings(workload, seed, fault, reference, device, sizes=None):
    """Every number of the check for the reference with ``fault``
    planted, in the program's place, against ``reference`` (the sound
    reference's outputs of the same seed)."""
    from portbench import check, harness, model_dir, spec
    from portbench.reference import model

    bench = spec.benchmark()
    cell = spec.cell(bench, workload)
    config = spec.config(bench, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    if sizes:
        config.update({k: v for k, v in sizes.items() if k in config})
        traffic.update({k: v for k, v in sizes.items() if k in traffic})
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        xml = model_dir.write(Path(tmp) / "model", config, traffic, seed)
        with planted(fault):
            outs = harness.reference_outputs(
                model.load(xml), traffic,
                harness.reference_devices(config, device))
    end = outs[float(traffic["segment_s"])]
    return check.readings(
        end, reference, lambda kind, t: check.field(kind, outs[t]["state"]),
        traffic, config["cell_size_m"])


def one_run(workload, seed, device, sizes, cache, precision=None):
    """One run as the benchmark makes it, its log kept apart."""
    from portbench import harness

    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        result = harness.run_cell(workload, seed, 0.0, False, device=device,
                                  precision=precision, sizes=sizes,
                                  reference_cache=cache)
    lines = log.getvalue().splitlines()
    readings = json.loads(next(line for line in lines
                               if line.startswith("readings: "))[10:])
    return result, readings, [ln for ln in lines
                              if not ln.startswith("readings: ")]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", default="")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--sizes", default=None)
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    sizes = json.loads(args.sizes) if args.sizes else {}
    faults = [f for f in args.faults.split(",") if f]
    for seed in seeds:
        cache = {}
        runs = [("program", None)]
        if args.control:
            runs.append(("control", "single"))
        for tag, precision in runs:
            t0 = time.perf_counter()
            result, readings, log = one_run(args.workload, seed, args.device,
                                            sizes, cache, precision)
            print(json.dumps({"seed": seed, "run": tag,
                              "precision": precision,
                              "correct": result["correct"],
                              "readings": readings,
                              "metrics": result["metrics"],
                              "run_s": time.perf_counter() - t0,
                              "log": log}), flush=True)
        for fault in faults:
            t0 = time.perf_counter()
            readings = planted_readings(args.workload, seed, fault,
                                        cache["outputs"], args.device, sizes)
            print(json.dumps({"seed": seed, "run": fault,
                              "readings": readings,
                              "run_s": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
