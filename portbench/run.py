#!/usr/bin/env python3
"""The benchmark of hipims_tpu_torch, one run of one cell:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout on a machine with an NVIDIA card.  With
``--trace 0`` the last line of standard output is the result with the
cell's end-to-end metrics; with ``--trace 1`` one segment is profiled and
the line carries the per-layer metrics, the device's busy and window
seconds and a breakdown.  The numbers compared with the reference are
the last lines of standard error and the last key of the result.  A cell
on several chips runs one rank per card (``ranks.py``), and rank 0's
result is printed.  Without as many CUDA cards as the cell asks for, the
run fails and prints no result.  Build and kernel caches
stay inside the checkout (``.portbench_cache/``); model files go under
``$TMPDIR`` and are deleted at exit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".portbench_cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness, spec

    need = spec.cell(spec.benchmark(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: needs {need} CUDA device(s), "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 2
    if need > 1:
        from portbench import ranks
        return ranks.launch({"workload": args.workload, "seed": args.seed,
                             "seconds": args.seconds, "trace": args.trace,
                             "t_start": T_START}, need)
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), device="cuda:0",
                                  t_start=T_START)
    except harness.ForbiddenModules as exc:
        print(f"portbench: the run loaded what it may not: {exc}",
              file=sys.stderr)
        return 3
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"portbench: the run loaded what it may not: {loaded}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    harness.print_compared(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
