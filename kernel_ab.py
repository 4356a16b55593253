#!/usr/bin/env python3
"""Time this tree's scheme kernels against another tree's on one card.

Run from the root of a checkout, on a machine with one CUDA card and nvcc:

    python3 kernel_ab.py --other DIR [--profile] [--walls]

DIR holds another checkout of the repo (for example the parent commit,
unpacked by ``git archive`` into a directory that .gitignore lists).  The
script prints, for both trees, each kernel's registers, shared memory and
spills (``nvcc -Xptxas -v`` on its source) and its static count of SASS
instructions (``cuobjdump -sass``); then the per-step time of every
kernel wrapper on chip_smoke's random domain at 2944 x 3072 cells in f32,
f32c and f64, measured in turns (other, this, this, other), each turn a
process of its own; then K1's and K3's times over chunk heights, in each
tree that has the row-marching kernels.  With ``--profile`` it adds the
in-situ time of K1 and K3 per steady step
(``hipims_tpu_torch/tools/profile_batch.py``) on the pluvial model of
chip_smoke phases 4 and 4b, both trees; with ``--walls`` the wall of
chip_smoke phases 4 (the Godunov pluvial model) and 4e (the breach)
through the CLI, output events included, in turns (other, this, this,
other).  Each tree's turns import that tree's package and chip_smoke.py.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROWS, COLS = 2944, 3072
REPS = 50
MODES = ("f32", "f32c", "f64")
CHUNKS = (8, 12, 16, 24, 32, 64)
THIS = Path(__file__).resolve().parent
TURNS = ("other", "this", "this", "other")

# Wrapper name -> how to call it on (kernels module pair, state, static,
# comp, dt, params, predictor planes).
CALLS = {
    "godunov_fused": lambda st, ms, s, g, c, dt, p, pr: st.stencil_step(
        "godunov", s, g, dt, p, comp=c),
    "inertial_fused": lambda st, ms, s, g, c, dt, p, pr: st.stencil_step(
        "inertial", s, g, dt, p, comp=c, simplified_speed=True),
    "muscl_fused": lambda st, ms, s, g, c, dt, p, pr: st.stencil_step(
        "muscl-hancock", s, g, dt, p, comp=c),
    "muscl_predict": lambda st, ms, s, g, c, dt, p, pr: ms.muscl_predict(
        s, g, dt, p),
    "muscl_correct": lambda st, ms, s, g, c, dt, p, pr: ms.muscl_correct(
        s, g, pr[0], dt, p, comp=c),
    "muscl_predict_base": lambda st, ms, s, g, c, dt, p, pr:
        ms.muscl_predict_base(s, g, dt, p),
    "muscl_correct_recompute": lambda st, ms, s, g, c, dt, p, pr:
        ms.muscl_correct_recompute(s, g, pr[1], dt, p, comp=c),
}
# K1 and K3 launched at a given chunk height (row-marching trees only).
BY_CHUNK = {
    "godunov_fused": lambda st, ms, s, g, c, dt, p, pr, k: st._godunov_cuda(
        s, g, dt, p, c, False, chunk=k),
    "muscl_correct": lambda st, ms, s, g, c, dt, p, pr, k: ms._correct_cuda(
        s, g, pr[0], dt, p, c, chunk=k),
}


def _time_ms(torch, fn, reps=REPS):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def time_kernels(chunks=()):
    """In the tree on sys.path: {kernel: {mode: ms}} for every wrapper, and
    with ``chunks`` {chunk: {kernel: {mode: ms}}} for K1 and K3."""
    import numpy as np
    import torch

    from chip_smoke import random_domain
    from hipims_tpu_torch.ops.godunov import SchemeParams
    from hipims_tpu_torch.ops.kernels import muscl_split as ms
    from hipims_tpu_torch.ops.kernels import stencil as st
    from hipims_tpu_torch.state import DomainStatic, FlowState

    if not hasattr(st, "_godunov_cuda"):    # a tree before the row marching
        chunks = ()
    params = SchemeParams(dx=2.0, dy=2.0)
    arrs = random_domain(0, ROWS, COLS)
    out, by_chunk = {}, {}
    for mode in MODES:
        dtype = torch.float64 if mode == "f64" else torch.float32
        t = [torch.as_tensor(a, device="cuda").to(dtype) for a in arrs]
        comp = None
        if mode == "f32c":
            rng = np.random.default_rng(1)
            comp = torch.as_tensor(rng.uniform(-1e-7, 1e-7, (ROWS, COLS)),
                                   device="cuda").to(dtype)
        dt = torch.tensor(0.05, dtype=dtype, device="cuda")
        state, static = FlowState(*t[:4]), DomainStatic(*t[4:])
        pred = (ms.muscl_predict(state, static, dt, params),
                ms.muscl_predict_base(state, static, dt, params))
        for name, call in CALLS.items():
            out.setdefault(name, {})[mode] = _time_ms(torch, lambda: call(
                st, ms, state, static, comp, dt, params, pred))
        for chunk in chunks:
            for name, call in BY_CHUNK.items():
                by_chunk.setdefault(chunk, {}).setdefault(name, {})[mode] = (
                    _time_ms(torch, lambda: call(st, ms, state, static, comp,
                                                 dt, params, pred, chunk)))
        del state, static, comp, pred, t
        torch.cuda.empty_cache()
    return out, by_chunk


def time_walls():
    """In the tree on sys.path: chip_smoke phases 4 and 4e through the CLI
    at ROWS x COLS, with the kernels built first; {phase: {wall_s, run_s,
    steps, idle}}."""
    import chip_smoke
    from hipims_tpu_torch.ops.kernels import muscl_split, stencil

    stencil._lib()
    muscl_split._lib()
    out = {}
    with tempfile.TemporaryDirectory(prefix="kernel_ab_") as tmp:
        for phase, run in (("4", chip_smoke.run_main_path),
                           ("4e", chip_smoke.run_breach_path)):
            res = run(Path(tmp) / phase, "gpu", ROWS, COLS, 600.0, 300.0)
            out[phase] = {k: res[k] for k in ("wall_s", "run_s", "steps",
                                              "idle")}
    return out


def _run_in(tree, args, timeout=900):
    """Run this file on ``tree``'s package and chip_smoke.py (``-P``: the
    directory of this file stays off sys.path); returns its last line as
    JSON."""
    env = dict(os.environ, PYTHONPATH=str(tree))
    res = subprocess.run([sys.executable, "-P", str(Path(__file__).resolve()),
                          *args], cwd=tree, env=env, capture_output=True,
                         text=True, timeout=timeout)
    if res.returncode != 0:
        raise RuntimeError(f"{tree}: {' '.join(args)} failed:\n"
                           f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    return json.loads(res.stdout.splitlines()[-1])


def ptxas_report(tree):
    """Registers, shared memory and spills of each kernel of ``tree``'s
    two CUDA sources, from ``nvcc -Xptxas -v`` (this tree's flags), and
    each kernel's static count of SASS instructions and of MUFU (sqrt,
    reciprocal, exp, log) among them, from ``cuobjdump -sass``."""
    from hipims_tpu_torch.ops.kernels import build

    nvcc = build.find_nvcc()
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    lines = []
    with tempfile.TemporaryDirectory(prefix="kernel_ab_") as tmp:
        for src in ("stencil.cu", "muscl_split.cu"):
            cubin = Path(tmp) / f"{src}.cubin"
            res = subprocess.run(
                [nvcc, *flags, "-Xptxas", "-v", "-cubin", "-o", str(cubin),
                 str(Path(tree) / "hipims_tpu_torch" / "csrc" / src)],
                capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{res.stderr}")
            sass = _sass_counts(cuobjdump, cubin)
            name, spill = None, ""
            for ln in res.stderr.splitlines():
                m = re.search(r"Compiling entry function '(\w+)'", ln)
                if m:
                    name = m.group(1)
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", ln)
                if m:
                    spill = f"spill {m.group(1)}/{m.group(2)} B"
                m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem",
                              ln)
                if m and name:
                    n_all, n_mufu = sass.get(name, ("?", "?"))
                    lines.append(f"  {src}: {_demangle(name)}: {m.group(1)} "
                                 f"registers, {m.group(2)} B smem, {spill}, "
                                 f"{n_all} SASS instructions ({n_mufu} "
                                 "MUFU)")
                    name = None
    return lines


def _sass_counts(cuobjdump, cubin):
    """count_sass of a cubin's ``cuobjdump -sass``; empty when cuobjdump
    is missing."""
    if not cuobjdump.is_file():
        return {}
    return count_sass(subprocess.run([str(cuobjdump), "-sass", str(cubin)],
                                     capture_output=True, text=True).stdout)


def count_sass(dump):
    """{mangled kernel name: (instructions, MUFU instructions)} of a
    ``cuobjdump -sass`` listing."""
    counts, name = {}, None
    for ln in dump.splitlines():
        m = re.search(r"Function : (\w+)", ln)
        if m:
            name = m.group(1)
            counts[name] = [0, 0]
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s", ln):
            counts[name][0] += 1
            counts[name][1] += "MUFU" in ln
    return {k: tuple(v) for k, v in counts.items()}


def _demangle(name):
    try:
        return subprocess.run(["c++filt", name], capture_output=True,
                              text=True).stdout.strip() or name
    except OSError:
        return name


def profile_in_situ(tree, root):
    """``tools/profile_batch.py`` of ``tree`` on the Godunov and MUSCL
    pluvial models of chip_smoke phases 4 and 4b (written under
    ``root``); returns its lines."""
    import chip_smoke

    lines = []
    for scheme in ("godunov", "musclhancock"):
        xml = chip_smoke.write_glasgow_model(Path(root) / scheme, ROWS, COLS,
                                             600.0, 300.0, scheme=scheme)
        env = dict(os.environ, PYTHONPATH=str(tree))
        res = subprocess.run(
            [sys.executable, "-m", "hipims_tpu_torch.tools.profile_batch",
             "-c", str(xml)], cwd=tree, env=env, capture_output=True,
            text=True, timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"profile_batch failed in {tree}:\n"
                               f"{res.stderr[-3000:]}")
        lines += [f"  [{scheme}] {ln}" for ln in res.stdout.splitlines()]
    return lines


def _kernel_table(runs):
    table = [f"per-step ms at {ROWS}x{COLS}, turns {', '.join(TURNS)} "
             f"({REPS} launches each, CUDA events):"]
    for name in CALLS:
        for mode in MODES:
            o = [r["times"][name][mode] for lb, r in runs if lb == "other"]
            t = [r["times"][name][mode] for lb, r in runs if lb == "this"]
            table.append(f"  {name:24s} {mode:5s} other {o[0]:.4f} "
                         f"{o[1]:.4f}  this {t[0]:.4f} {t[1]:.4f}  "
                         f"this/other {sum(t) / sum(o):.3f}")
    for label, got in runs[:2]:
        if got["chunks"]:
            table.append(f"{label} tree, K1 and K3 by chunk height (rows "
                         "per block):")
        for chunk, by_name in got["chunks"].items():
            table.append(f"  chunk {chunk:>4}: " + "; ".join(
                f"{n} " + " ".join(f"{m} {v:.4f}" for m, v in by.items())
                for n, by in by_name.items()))
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="another checkout to compare with")
    ap.add_argument("--profile", action="store_true",
                    help="also profile K1 and K3 in situ, both trees")
    ap.add_argument("--walls", action="store_true",
                    help="also time chip_smoke phases 4 and 4e, in turns")
    ap.add_argument("--time", action="store_true",
                    help="(internal) time this process's tree and print "
                         "JSON")
    ap.add_argument("--chunks", action="store_true",
                    help="(internal) with --time, also over CHUNKS")
    ap.add_argument("--wall", action="store_true",
                    help="(internal) time phases 4 and 4e and print JSON")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    if args.time:
        out, by_chunk = time_kernels(CHUNKS if args.chunks else ())
        print(json.dumps({"times": out, "chunks": by_chunk}))
        return 0
    if args.wall:
        print(json.dumps(time_walls()))
        return 0
    if not args.other:
        ap.error("--other DIR is required")
    other = Path(args.other).resolve()
    trees = {"other": other, "this": THIS}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}\n"
          f"this tree {THIS}, other tree {other}", flush=True)
    for label, tree in trees.items():
        print("\n".join([f"ptxas, {label} tree:", *ptxas_report(tree)]),
              flush=True)

    # The chunk sweep runs in each tree's first turn.
    runs = [(label, _run_in(trees[label], ["--time"]
                            + (["--chunks"] if turn < 2 else [])))
            for turn, label in enumerate(TURNS)]
    print("\n".join(_kernel_table(runs)), flush=True)
    if args.profile:
        with tempfile.TemporaryDirectory(prefix="kernel_ab_") as tmp:
            for label, tree in trees.items():
                lines = [f"in situ, {label} tree:"] + profile_in_situ(
                    tree, tmp)
                print("\n".join(lines), flush=True)
    if args.walls:
        walls = [(label, _run_in(trees[label], ["--wall"], timeout=1200))
                 for label in TURNS]
        print(f"walls of chip_smoke phases 4 and 4e at {ROWS}x{COLS} through "
              f"the CLI, turns {', '.join(TURNS)}:")
        for label, got in walls:
            print("  " + label + ": " + "; ".join(
                f"phase {p} wall {r['wall_s']:.2f} s (run with outputs "
                f"{r['run_s']:.2f} s), {r['steps']} steps +{r['idle']} idle"
                for p, r in got.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
