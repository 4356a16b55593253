"""Profile steady batches of a model on the card.

Runs the model to WARM_UP_S simulated seconds, then times BATCHES batches
of STEPS steps each (host clock around work that ends in a device
synchronisation), then runs one more batch under ``torch.profiler`` and
prints the device's busy share of that batch, the device time of the
TOP kernels per step, and the host reads and copies in that batch
(``aten::item``, ``cudaMemcpy*``, synchronisations: the batch loop
promises none but the final synchronise).  Output events are not
written.

    python -m hipims_tpu_torch.tools.profile_batch -c model.xml \
        [--muscl-variant split12|recompute]
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import torch

from ..io.xml_config import load_config

WARM_UP_S = 150.0
STEPS = 50
BATCHES = 3
TOP = 12


def _device_us(event):
    """Self device time of a profiler row in microseconds (the attribute
    was renamed across PyTorch versions)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("--muscl-variant", choices=("split12", "recompute"),
                    help="the MUSCL kernels (SimulationConfig.muscl_variant)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_batch: CUDA is not available", file=sys.stderr)
        return 2

    model = load_config(args.config)
    model.output_targets = []
    model.config.muscl_variant = args.muscl_variant
    sim = model.simulation(device=torch.device("cuda", 0))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(f"{smi}; {model.domain.rows}x{model.domain.cols} "
          f"{model.config.scheme} {model.config.dtype}")
    sim.run_to(WARM_UP_S)
    sync = torch.tensor(model.config.duration, dtype=sim.dtype,
                        device=sim.device)

    def batch():
        sim.state, sim.carry, sim.comp = sim._run_batch(
            sim.state, sim.carry, sim.static, sync, sim.comp, STEPS)
        torch.cuda.synchronize()

    for k in range(BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch()
        ms = (time.perf_counter() - t0) / STEPS * 1e3
        print(f"batch {k}: {ms:.4f} ms per step "
              f"(t = {sim._read_carry()[0]:.1f} s)")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        batch()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Device-side rows only: an operator row's self device time is its
    # kernels', which appear again as rows of their own.
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.count, _device_us(e)) for e in prof.key_averages()
            if getattr(e, "device_type", cuda) == cuda]
    rows = [r for r in rows if r[2] > 0.0]
    busy_us = sum(r[2] for r in rows)
    print(f"profiled batch: {wall_us / STEPS / 1e3:.4f} ms per step; "
          f"device busy {busy_us / wall_us:.1%} "
          f"({busy_us / STEPS / 1e3:.4f} ms per step); "
          f"{sum(r[1] for r in rows) / STEPS:.1f} device kernels per step")
    for key, count, us in sorted(rows, key=lambda r: -r[2])[:TOP]:
        print(f"  {us / STEPS / 1e3:.4f} ms/step  "
              f"{count / STEPS:5.1f}/step  {key[:90]}")
    reads = {e.key: e.count for e in prof.key_averages()
             if e.key in ("aten::item", "aten::_local_scalar_dense")
             or "Memcpy" in e.key or "Synchronize" in e.key}
    print(f"host reads and copies in the profiled batch of {STEPS} steps: "
          + (", ".join(f"{k} x{n}" for k, n in sorted(reads.items()))
             or "none"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
