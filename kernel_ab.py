#!/usr/bin/env python3
"""Time this tree's scheme kernels against another tree's on one card.

Run from the root of a checkout, on a machine with one CUDA card and nvcc:

    python3 kernel_ab.py --other DIR [--profile] [--walls]

DIR holds another checkout of the repo (for example the parent commit,
unpacked by ``git archive`` into a directory that .gitignore lists).  The
script prints, for both trees, each kernel's registers, shared memory and
spills (``nvcc -Xptxas -v`` on its source) and its static count of SASS
instructions (``cuobjdump -sass``); then the per-step time of every
kernel wrapper on chip_smoke's random domain at 2944 x 3072 and at 1408 x
1408 cells in f32, f32c and f64, measured in turns (other, this, this,
other), each turn a process of its own; K4 in the same turns on variants
of that domain (as drawn, with one Manning value, with one per land-use
patch of 5x7 or 10x10 cells, with no disabled cells) and on the phase-4d
inertial model's own state; the two MUSCL pairs (split12: K2 + K3,
recompute: K5a-P + K5a-C) as one step each, in the same turns; then this
tree's row-marching kernels (K1, K3, K4, K5a-C, K5b) over chunk heights.  With ``--profile`` it adds the
in-situ time per steady step of K1, K3, K4 and K5a-C
(``hipims_tpu_torch/tools/profile_batch.py``) on the pluvial models of
chip_smoke phases 4 (Godunov), 4b (MUSCL, split12), 4d (inertial) and 4c
(MUSCL, recompute), both trees; with ``--walls`` the wall of chip_smoke
phases 4 (the Godunov pluvial model) and 4e (the breach) through the CLI,
output events included, in turns (other, this, this, other).  Each tree's
turns import that tree's package; the inputs come from this checkout's
chip_smoke.py, so both trees time the same inputs.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROWS, COLS = 2944, 3072
SIZES = ((ROWS, COLS), (1408, 1408))
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
    # The two MUSCL pairs as a step takes them, to rank K5b against.
    "split12 (K2 + K3)": lambda st, ms, s, g, c, dt, p, pr:
        ms.muscl_step_split(s, g, dt, p, "split12", c),
    "recompute (K5a-P + K5a-C)": lambda st, ms, s, g, c, dt, p, pr:
        ms.muscl_step_split(s, g, dt, p, "recompute", c),
}
# This tree's row-marching kernels launched at a given chunk height.
BY_CHUNK = {
    "godunov_fused": lambda st, ms, s, g, c, dt, p, pr, k: st._godunov_cuda(
        s, g, dt, p, c, False, chunk=k),
    "inertial_fused": lambda st, ms, s, g, c, dt, p, pr, k:
        st._inertial_cuda(s, g, dt, p, c, True, chunk=k),
    "muscl_correct": lambda st, ms, s, g, c, dt, p, pr, k: ms._correct_cuda(
        s, g, pr[0], dt, p, c, chunk=k),
    "muscl_correct_recompute": lambda st, ms, s, g, c, dt, p, pr, k:
        ms._correct_cuda(s, g, pr[1], dt, p, c, slopes=ms.REBUILT, chunk=k),
    "muscl_fused": lambda st, ms, s, g, c, dt, p, pr, k: ms._fused_cuda(
        s, g, dt, p, c, chunk=k),
}
# K4's inputs, to find what sets its time on the random domain: the domain
# as drawn (n per cell), with one Manning value (the pluvial model's), with
# one value per land-use patch of 5x7 and of 10x10 cells, with no disabled
# cells, and the phase-4d model's own state after K4_WARM_S simulated
# seconds (timed alone, as the others).
K4_VARIANTS = ("random", "one_manning", "patches_5x7", "patches_10x10",
               "no_disabled", "model_state")
K4_WARM_S = 150.0


def _smoke():
    """This checkout's chip_smoke.py, which makes every input: both trees
    of an A/B time the same inputs, whichever tree's package runs them."""
    spec = importlib.util.spec_from_file_location(
        "kernel_ab_inputs", THIS / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
    """In the tree on sys.path: {"ROWSxCOLS": {kernel: {mode: ms}}} for
    every wrapper at each of SIZES, and with ``chunks`` {chunk: {kernel:
    {mode: ms}}} for the row-marching kernels at ROWS x COLS."""
    import torch

    from hipims_tpu_torch.ops.godunov import SchemeParams
    from hipims_tpu_torch.ops.kernels import muscl_split as ms
    from hipims_tpu_torch.ops.kernels import stencil as st

    params = SchemeParams(dx=2.0, dy=2.0)
    out, by_chunk = {}, {}
    for rows, cols in SIZES:
        arrs = _smoke().random_domain(0, rows, cols)
        size = out.setdefault(f"{rows}x{cols}", {})
        for mode in MODES:
            state, static, comp, dt = _on_card(torch, arrs, mode)
            pred = (ms.muscl_predict(state, static, dt, params),
                    ms.muscl_predict_base(state, static, dt, params))
            for name, call in CALLS.items():
                size.setdefault(name, {})[mode] = _time_ms(torch, lambda: call(
                    st, ms, state, static, comp, dt, params, pred))
            for chunk in chunks if (rows, cols) == (ROWS, COLS) else ():
                for name, call in BY_CHUNK.items():
                    by_chunk.setdefault(chunk, {}).setdefault(name, {})[
                        mode] = _time_ms(torch, lambda: call(
                            st, ms, state, static, comp, dt, params, pred,
                            chunk))
            del state, static, comp, pred
            torch.cuda.empty_cache()
    return out, by_chunk


def _on_card(torch, arrs, mode, comp=None):
    """(state, static, comp, dt) of numpy planes ``arrs`` in ``mode``; comp
    is a small residue plane in f32c unless given."""
    import numpy as np

    from hipims_tpu_torch.state import DomainStatic, FlowState

    dtype = torch.float64 if mode == "f64" else torch.float32
    t = [torch.as_tensor(a, device="cuda").to(dtype) for a in arrs]
    if mode == "f32c" and comp is None:
        rng = np.random.default_rng(1)
        comp = torch.as_tensor(rng.uniform(-1e-7, 1e-7, arrs[0].shape),
                               device="cuda").to(dtype)
    comp = comp if mode == "f32c" else None
    dt = torch.tensor(0.05, dtype=dtype, device="cuda")
    return FlowState(*t[:4]), DomainStatic(*t[4:]), comp, dt


def time_k4_variants():
    """In the tree on sys.path: {variant: {mode: ms}} of K4 on each of
    K4_VARIANTS."""
    import numpy as np
    import torch

    from hipims_tpu_torch.io.xml_config import load_config
    from hipims_tpu_torch.ops.godunov import SchemeParams
    from hipims_tpu_torch.ops.kernels import stencil as st

    smoke = _smoke()
    params = SchemeParams(dx=2.0, dy=2.0)
    drawn = smoke.random_domain(0, ROWS, COLS)
    inputs = {
        "random": (drawn, None),
        "one_manning": ((*drawn[:5], np.full((ROWS, COLS),
                                             smoke.ONE_MANNING)), None),
        "patches_5x7": ((*drawn[:5], smoke.patch_manning(ROWS, COLS, 5, 7)),
                        None),
        "patches_10x10": ((*drawn[:5],
                           smoke.patch_manning(ROWS, COLS, 10, 10)), None),
        "no_disabled": (smoke.random_domain(0, ROWS, COLS,
                                            disabled_fraction=0.0), None)}
    with tempfile.TemporaryDirectory(prefix="kernel_ab_") as tmp:
        model = load_config(smoke.write_glasgow_model(
            tmp, ROWS, COLS, 600.0, 300.0, scheme="inertial"))
        model.output_targets = []
        sim = model.simulation(device=torch.device("cuda", 0))
        sim.run_to(K4_WARM_S)
        inputs["model_state"] = (
            [a.double().cpu().numpy() for a in (*sim.state, *sim.static)],
            sim.comp)
        del sim
    out = {}
    for variant, (arrs, comp) in inputs.items():
        for mode in MODES:
            state, static, c, dt = _on_card(torch, arrs, mode, comp)
            out.setdefault(variant, {})[mode] = _time_ms(
                torch, lambda: st.stencil_step("inertial", state, static, dt,
                                               params, comp=c,
                                               simplified_speed=True))
            del state, static, c
            torch.cuda.empty_cache()
    return out


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
                # A kernel without shared memory prints no smem count.
                m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes "
                              r"smem)?", ln)
                if m and name:
                    n_all, n_mufu = sass.get(name, ("?", "?"))
                    lines.append(f"  {src}: {_demangle(name)}: {m.group(1)} "
                                 f"registers, {m.group(2) or 0} B smem, "
                                 f"{spill}, "
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


# (XML scheme name, MUSCL variant): the models of chip_smoke phases 4, 4b,
# 4d and 4c, whose steady steps launch K1, K2 + K3, K4 and K5a-P + K5a-C.
IN_SITU = (("godunov", None), ("musclhancock", None), ("inertial", None),
           ("musclhancock", "recompute"))


def profile_in_situ(tree, root):
    """``tools/profile_batch.py`` of ``tree`` on each model of IN_SITU
    (written under ``root``); returns its lines, or the end of its error
    where that tree's profile_batch cannot run a model."""
    lines = []
    for scheme, variant in IN_SITU:
        label = f"{scheme} {variant or ''}".strip()
        xml = _smoke().write_glasgow_model(
            Path(root) / label.replace(" ", "_"), ROWS, COLS, 600.0, 300.0,
            scheme=scheme)
        env = dict(os.environ, PYTHONPATH=str(tree))
        res = subprocess.run(
            [sys.executable, "-m", "hipims_tpu_torch.tools.profile_batch",
             "-c", str(xml), *(["--muscl-variant", variant] if variant
                               else [])],
            cwd=tree, env=env, capture_output=True, text=True, timeout=900)
        got = (res.stdout.splitlines() if res.returncode == 0 else
               [f"profile_batch failed: {res.stderr.strip()[-300:]}"])
        lines += [f"  [{label}] {ln}" for ln in got]
    return lines


def _ab_rows(runs, pick, names, label_width=26):
    """One line per (name, mode): both trees' turns and this/other."""
    rows = []
    for name in names:
        for mode in MODES:
            o = [pick(r)[name][mode] for lb, r in runs if lb == "other"]
            t = [pick(r)[name][mode] for lb, r in runs if lb == "this"]
            rows.append(f"  {name:{label_width}s} {mode:5s} other {o[0]:.4f} "
                        f"{o[1]:.4f}  this {t[0]:.4f} {t[1]:.4f}  "
                        f"this/other {sum(t) / sum(o):.3f}")
    return rows


def _kernel_table(runs):
    table = []
    for rows, cols in SIZES:
        size = f"{rows}x{cols}"
        table += [f"per-step ms at {size}, turns {', '.join(TURNS)} "
                  f"({REPS} launches each, CUDA events):",
                  *_ab_rows(runs, lambda r: r["times"][size], CALLS)]
    table += ["K4 (inertial_fused) on its input variants, same turns:",
              *_ab_rows(runs, lambda r: r["k4"], K4_VARIANTS)]
    chunks = next(r["chunks"] for lb, r in runs if lb == "this")
    table.append(f"this tree, the row-marching kernels at {ROWS}x{COLS} by "
                 "chunk height (rows per block):")
    for chunk, by_name in chunks.items():
        table.append(f"  chunk {chunk:>4}: " + "; ".join(
            f"{n} " + " ".join(f"{m} {v:.4f}" for m, v in by.items())
            for n, by in by_name.items()))
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="another checkout to compare with")
    ap.add_argument("--profile", action="store_true",
                    help="also profile K1, K3, K4 and K5a-C in situ, both "
                         "trees")
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
        print(json.dumps({"times": out, "chunks": by_chunk,
                          "k4": time_k4_variants()}))
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

    # The chunk sweep runs in this tree's first turn.
    runs = [(label, _run_in(trees[label], ["--time"]
                            + (["--chunks"] if turn == 1 else [])))
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
