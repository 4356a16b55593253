#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (hipims_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):

1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build both kernel libraries from the checkout's sources with nvcc, in
   parallel: K1 (csrc/stencil.cu) and the MUSCL kernels K2, K3, K5a-P and
   K5a-C (csrc/muscl_split.cu);
3. K1 against its plain PyTorch version on the card, f64 / f32 / f32c, at
   a 32x128 random case, 1408x1408 and 2944x3072 (9.04 M cells), with
   per-step times of both;
3b. the same for the four MUSCL kernels (all 12 predictor planes, then the
   corrector's fields), and the split12 chain (K2 -> K3) against the
   recompute chain (K5a-P -> K5a-C);
4. the main path: a Glasgow-class pluvial model (Godunov, 38.4 mm/h rain
   for the first hour plus a 6 mm/h loss, closed edges, XML precision
   "double" = compensated f32) at Thamesmead-class extent, 2944x3072 cells
   at 2 m, 600 s simulated with depth and maxdepth rasters every 300 s,
   run through ``hipims_tpu_torch.cli.main``; checks the rasters, the mass
   balance against rain minus loss, and that every step launched K1;
4b. the same model with <scheme name="musclhancock">, 300 s simulated with
   rasters every 150 s: every step launches K2 and K3 (the default
   variant, split12);
4c. the MUSCL model with ``muscl_variant="recompute"`` through the
   embedding API (load_config -> Simulation.run), 150 s: every step
   launches K5a-P and K5a-C; final depth finite, mass balance;
5. the whole slice: the same model at 128x128 and 120 s, in float64
   ("double-strict"), on the card and on the CPU (plain versions); the
   final fields must agree within the f32c bounds; 5b: the same for MUSCL.
   (In single precision the 1 mm rain films make any two f32
   implementations drift apart by ~1e-4 m within 120 s, because their
   exp/log differ by an ulp and implicit friction at h^-7/3 amplifies it:
   tests/test_torch_cli.py.)

The line before the last is a JSON record of the kernels; the last line
is ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
package beside this file, it prints no result and exits with status 2.
Weights are random terrain made from fixed seeds; nothing is downloaded.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# Tolerances (the CPU tests' bars): f64 to round-off, f32/f32c to a few
# ulps of O(1) fields, and the true surface z + comp in f32c to 1e-6.
TOL = {"f64": (1e-12, 1e-12), "f32": (1e-5, 1e-6), "f32c": (1e-5, 1e-6)}
TRUE_SURFACE_TOL = 1e-6
MASS_BALANCE_REL = 0.01

XML = """<?xml version="1.0"?>
<configuration>
  <metadata><name>glasgow-class</name>
    <description>Synthetic Glasgow-class pluvial model</description>
  </metadata>
  <simulation>
    <parameter name="duration" value="{duration}" />
    <parameter name="outputFrequency" value="{outfreq}" />
    <parameter name="floatingPointPrecision" value="{precision}" />
    <domainSet>
      <domain type="cartesian">
        <data sourceDir="topography/" targetDir="output/">
          <dataSource type="raster" value="structure,dem" source="dem.tif" />
          <dataSource type="constant" value="manningCoefficient"
                      source="0.04" />
          <dataTarget type="raster" value="depth" format="GTiff"
                      target="depth_%t.tif" />
          <dataTarget type="raster" value="maxdepth" format="GTiff"
                      target="maxdepth_%t.tif" />
        </data>
        <scheme name="{scheme}">
          <parameter name="courantNumber" value="0.5" />
          <parameter name="frictionEffects" value="yes" />
        </scheme>
        <boundaryConditions sourceDir="boundaries/">
          <domainEdge edge="north" treatment="closed" />
          <domainEdge edge="south" treatment="closed" />
          <domainEdge edge="east" treatment="closed" />
          <domainEdge edge="west" treatment="closed" />
          <timeseries type="atmospheric" name="Rain"
                      value="rain-intensity" source="rain.csv" />
          <timeseries type="atmospheric" name="Drain"
                      value="loss-rate" source="drain.csv" />
        </boundaryConditions>
      </domain>
    </domainSet>
  </simulation>
</configuration>
"""
RAIN_MM_H, LOSS_MM_H = 38.4, 6.0


def write_glasgow_model(root, rows, cols, duration, outfreq,
                        precision="double", dx=2.0, scheme="godunov"):
    """Write the Glasgow-class model (the terrain and rain/drain of
    tools/bench_e2e.py build_glasgow_class) at any extent, with the XML's
    ``scheme`` name; returns the XML path.  Uses the port's own raster
    writer."""
    from hipims_tpu_torch.io.raster import Raster, write_raster

    root = Path(root)
    (root / "topography").mkdir(parents=True, exist_ok=True)
    (root / "boundaries").mkdir(parents=True, exist_ok=True)
    yy, xx = np.mgrid[0:rows, 0:cols]
    bed = (30.0 - xx * dx * 0.01
           + 1.5 * np.sin(yy / 12.0) * np.sin(xx / 17.0)
           + 0.5 * np.sin(yy / 3.1) * np.cos(xx / 4.3))
    write_raster(root / "topography" / "dem.tif",
                 Raster(data=np.asarray(bed[::-1, :], np.float32),
                        xll=0.0, yll=0.0, cell_size=dx, nodata=-9999.0))
    (root / "boundaries" / "rain.csv").write_text(
        f"Time,Rate\n0,{RAIN_MM_H}\n3600,0\n7200,0\n")
    (root / "boundaries" / "drain.csv").write_text(
        f"Time,Rate\n0,{LOSS_MM_H}\n7200,{LOSS_MM_H}\n")
    xml = root / "model.xml"
    xml.write_text(XML.format(duration=duration, outfreq=outfreq,
                              precision=precision, scheme=scheme))
    return xml


def random_domain(seed, rows, cols, dry_fraction=0.4,
                  disabled_fraction=0.1):
    """Adversarial wet/dry state (tests/test_godunov_oracle.random_domain)."""
    rng = np.random.default_rng(seed)
    zb = rng.uniform(0.0, 3.0, (rows, cols))
    depth = rng.uniform(0.0, 2.0, (rows, cols))
    depth[rng.random((rows, cols)) < dry_fraction] = 0.0
    z = zb + depth
    qx = rng.uniform(-1.5, 1.5, (rows, cols)) * (depth > 0)
    qy = rng.uniform(-1.5, 1.5, (rows, cols)) * (depth > 0)
    zmax = z + rng.uniform(0.0, 0.5, (rows, cols))
    disabled = rng.random((rows, cols)) < disabled_fraction
    z[disabled] = -9999.0
    zmax[disabled] = -9999.0
    qx[disabled] = 0.0
    qy[disabled] = 0.0
    manning = rng.uniform(0.01, 0.06, (rows, cols))
    return z, zmax, qx, qy, zb, manning


def _excess(got, want, rtol, atol):
    """max(|got - want| - (atol + rtol |want|)) and max |got - want|, in
    float64; the first is <= 0 when every element is within tolerance."""
    g, w = got.double(), want.double()
    diff = (g - w).abs()
    both_nan = g.isnan() & w.isnan()
    diff = diff.masked_fill(both_nan, 0.0)
    excess = (diff - (atol + rtol * w.abs())).masked_fill(both_nan, -1.0)
    return float(excess.max()), float(diff.max())


def _time_ms(torch, fn, reps):
    for _ in range(2):
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


def _card_inputs(torch, device, arrs, mode):
    """The random domain on the card in ``mode``'s dtype: (state, static,
    comp, dt); comp is a non-zero residue plane in f32c, so the Neumaier
    path is exercised, and None otherwise."""
    from hipims_tpu_torch.state import DomainStatic, FlowState

    dtype = torch.float64 if mode == "f64" else torch.float32
    t = [torch.as_tensor(a, device=device).to(dtype) for a in arrs]
    comp = None
    if mode == "f32c":
        rng = np.random.default_rng(1)
        comp = torch.as_tensor(rng.uniform(-1e-7, 1e-7, arrs[0].shape),
                               device=device).to(dtype)
    dt = torch.tensor(0.05, dtype=dtype, device=device)
    return FlowState(*t[:4]), DomainStatic(*t[4:]), comp, dt


def _step_pairs(got, want):
    """(name, got, want) for two step results (new_state, speed[, comp]):
    the four fields, the speed, and with comp the true surface z + comp,
    which is the invariant of the compensated plane."""
    pairs = list(zip(("z", "zmax", "qx", "qy"), got[0], want[0]))
    pairs.append(("speed", got[1], want[1]))
    if len(got) == 3:
        pairs.append(("z+comp", got[2].double() + got[0].z.double(),
                      want[2].double() + want[0].z.double()))
    return pairs


def _agree(who, mode, pairs, bars=None):
    """Raise unless every (name, got, want) pair agrees within ``bars``
    ((rtol, atol); by default ``mode``'s, and TRUE_SURFACE_TOL for
    z + comp); returns the largest |got - want|."""
    worst = 0.0
    for name, g, w in pairs:
        rtol, atol = bars or ((0.0, TRUE_SURFACE_TOL) if name == "z+comp"
                              else TOL[mode])
        excess, diff = _excess(g, w, rtol, atol)
        worst = max(worst, diff)
        if excess > 0.0:
            raise RuntimeError(f"{who} {mode} {name}: max|diff|={diff:.3e} "
                               f"(rtol={rtol}, atol={atol})")
    return worst


def phase_kernel_vs_plain(torch, device):
    """Phase 3: K1 against its plain version on the card."""
    from hipims_tpu_torch.ops.godunov import SchemeParams
    from hipims_tpu_torch.ops.kernels.stencil import (stencil_step,
                                                      stencil_step_plain)

    params = SchemeParams(dx=2.0, dy=2.0)
    worst = 0.0
    times = {}
    for rows, cols, reps in ((32, 128, 20), (1408, 1408, 20),
                             (2944, 3072, 10)):
        arrs = random_domain(0, rows, cols)
        for mode in ("f64", "f32", "f32c"):
            state, static, comp, dt = _card_inputs(torch, device, arrs, mode)
            got = stencil_step("godunov", state, static, dt, params,
                               comp=comp)
            want = stencil_step_plain(state, static, dt, params, comp=comp)
            torch.cuda.synchronize()
            worst = max(worst, _agree(
                f"K1 disagrees with the plain version: {rows}x{cols}", mode,
                _step_pairs(got, want)))
            k_ms = _time_ms(torch, lambda: stencil_step(
                "godunov", state, static, dt, params, comp=comp), reps)
            p_ms = _time_ms(torch, lambda: stencil_step_plain(
                state, static, dt, params, comp=comp), reps)
            times[(rows, cols, mode)] = (k_ms, p_ms)
            print(f"phase 3: K1 vs plain {rows}x{cols} {mode}: agree "
                  f"(max|diff| over fields so far {worst:.3e}); per step "
                  f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms", flush=True)
    return worst, times


def phase_muscl_vs_plain(torch, device):
    """Phase 3b: K2, K3, K5a-P and K5a-C against their plain versions on
    the card and on the same inputs: every predictor plane; then each
    corrector's fields, speed and true surface, both fed the plain
    predictor's planes.  Then the two kernel chains (split12: K2 -> K3,
    recompute: K5a-P -> K5a-C) against each other at the JAX package's
    bar for the two variants (rel 1e-13); bit-equal is expected."""
    from hipims_tpu_torch.ops.godunov import SchemeParams
    from hipims_tpu_torch.ops.kernels import muscl_split as ms

    params = SchemeParams(dx=2.0, dy=2.0)
    chains = {"split12": (ms.muscl_predict, ms.muscl_correct),
              "recompute": (ms.muscl_predict_base,
                            ms.muscl_correct_recompute)}
    worst = {k.__name__: 0.0 for k in ms.KERNELS}
    times = {}
    for rows, cols, reps, plain_reps in ((32, 128, 20, 5),
                                         (1408, 1408, 20, 3),
                                         (2944, 3072, 10, 2)):
        arrs = random_domain(0, rows, cols)
        for mode in ("f64", "f32", "f32c"):
            state, static, comp, dt = _card_inputs(torch, device, arrs, mode)
            ends = {}
            for variant, (pred_k, corr_k) in chains.items():
                store = variant == "split12"
                pname, cname = pred_k.__name__, corr_k.__name__
                pred = pred_k(state, static, dt, params)
                want_pred = ms.muscl_predict_plain(state, static, dt, params,
                                                   store_slopes=store)
                torch.cuda.synchronize()
                worst[pname] = max(worst[pname], _agree(
                    f"{pname} {rows}x{cols}", mode,
                    [("planes", pred, want_pred)]))
                got = corr_k(state, static, want_pred, dt, params, comp=comp)
                want = ms.muscl_correct_plain(state, static, want_pred, dt,
                                              params, comp=comp)
                torch.cuda.synchronize()
                worst[cname] = max(worst[cname], _agree(
                    f"{cname} {rows}x{cols}", mode, _step_pairs(got, want)))
                ends[variant] = corr_k(state, static, pred, dt, params,
                                       comp=comp)
                times[(pname, rows, cols, mode)] = (
                    _time_ms(torch, lambda: pred_k(state, static, dt, params),
                             reps),
                    _time_ms(torch, lambda: ms.muscl_predict_plain(
                        state, static, dt, params, store_slopes=store),
                        plain_reps))
                times[(cname, rows, cols, mode)] = (
                    _time_ms(torch, lambda: corr_k(
                        state, static, pred, dt, params, comp=comp), reps),
                    _time_ms(torch, lambda: ms.muscl_correct_plain(
                        state, static, want_pred, dt, params, comp=comp),
                        plain_reps))
            torch.cuda.synchronize()
            split_diff = _agree(
                f"split12 and recompute differ at {rows}x{cols}", mode,
                _step_pairs(ends["split12"], ends["recompute"]),
                bars=(1e-13, 1e-15))
            per_step = ", ".join(
                f"{k.__name__} {times[(k.__name__, rows, cols, mode)][0]:.4f}"
                f" / {times[(k.__name__, rows, cols, mode)][1]:.4f}"
                for k in ms.KERNELS)
            print(f"phase 3b: MUSCL kernels vs plain {rows}x{cols} {mode}: "
                  f"agree (max|diff| so far "
                  + ", ".join(f"{n} {e:.3e}" for n, e in worst.items())
                  + f"); split12 vs recompute max|diff| {split_diff:.3e}; "
                  f"per step kernel / plain ms: {per_step}", flush=True)
    return worst, times


def kernel_wrappers():
    """Every kernel wrapper of the port by name; each counts its launches
    in ``.launches``."""
    from hipims_tpu_torch.ops.kernels import muscl_split, stencil
    return {k.__name__: k for k in (stencil.stencil_step,
                                    *muscl_split.KERNELS)}


def _reset_launches():
    for k in kernel_wrappers().values():
        k.launches = 0


def _read_launches():
    return {name: k.launches for name, k in kernel_wrappers().items()}


def _forced_volume(rows, cols, ring, duration):
    """Rain minus loss on the forced cells: the grid minus the scheme's
    static ring, which the closed-edge walls occupy."""
    forced = (rows - 2 * ring) * (cols - 2 * ring) * 2.0 * 2.0
    return (RAIN_MM_H - LOSS_MM_H) / 3.6e6 * duration * forced


def run_main_path(root, device, rows, cols, duration, outfreq,
                  mass_tol=MASS_BALANCE_REL, scheme="godunov"):
    """Phase 4: write the model with the XML's ``scheme`` name, run it
    through the CLI on ``device`` ("gpu" or "cpu"), check outputs and mass
    balance.  Returns a dict of what it measured, with the launches of
    every kernel wrapper during the run.

    Rain and loss apply in hydrological chunks of >= 1 s, so the last
    partial chunk (< 1 s of forcing) is missing at the end of a run:
    0.17% of 600 s, but several percent of a very short run, which then
    needs a looser ``mass_tol``."""
    from hipims_tpu_torch.cli import main as cli_main
    from hipims_tpu_torch.io.raster import read_raster
    from hipims_tpu_torch.models import get_scheme

    xml = write_glasgow_model(root, rows, cols, duration, outfreq,
                              scheme=scheme)
    buf = io.StringIO()
    _reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["-c", str(xml), "-n", "--mass-balance",
                       "--platform", device])
    wall = time.perf_counter() - t0
    launches = _read_launches()
    out = buf.getvalue()
    if rc != 0:
        raise RuntimeError(f"CLI run failed with status {rc}:\n{out}")
    m = re.search(r"Iterations:\s+(\d+) \(\+(\d+) idle\)", out)
    if m is None:
        raise RuntimeError(f"no iteration count in the CLI output:\n{out}")
    steps, idle = int(m.group(1)), int(m.group(2))
    # The CLI times Simulation.run (steps + output writes); the rest of
    # the wall is set-up: model load, Domain.build, transfer to device.
    run_s = float(re.search(r"Simulated:.* in ([0-9.]+) s wall",
                            out).group(1))

    n_out = int(round(duration / outfreq))
    for k in range(1, n_out + 1):
        label = f"{k * outfreq:g}"
        for value in ("depth", "maxdepth"):
            path = Path(root) / "output" / f"{value}_{label}.tif"
            r = read_raster(path)
            if r.data.shape != (rows, cols) or not np.isfinite(r.data).all():
                raise RuntimeError(f"{path.name}: bad raster "
                                   f"{r.data.shape}, finite="
                                   f"{bool(np.isfinite(r.data).all())}")

    vols = [float(v) for v in re.findall(r"volume=([0-9.eE+-]+) m3", out)]
    if len(vols) != n_out:
        raise RuntimeError(f"expected {n_out} mass-balance lines:\n{out}")
    ring = get_scheme(re.search(r"Scheme:\s+(\S+)", out).group(1)).radius
    expected = _forced_volume(rows, cols, ring, duration)
    rel = (vols[-1] - expected) / expected
    if abs(rel) > mass_tol:
        raise RuntimeError(f"mass balance off by {rel:+.4%}: volume "
                           f"{vols[-1]:.3f} m3, rain - loss {expected:.3f}")
    return dict(wall_s=wall, run_s=run_s, steps=steps, idle=idle,
                launches=launches,
                volume=vols[-1], expected=expected, rel=rel,
                cells=rows * cols, log=out)


def run_api_path(root, device, rows, cols, duration, variant,
                 mass_tol=MASS_BALANCE_REL):
    """Phase 4c: the MUSCL model through the embedding API
    (``load_config`` -> ``Simulation.run``) on ``device`` with
    ``SimulationConfig.muscl_variant = variant``; checks the final depth
    and the mass balance.  Returns what it measured."""
    from hipims_tpu_torch.io.xml_config import load_config
    from hipims_tpu_torch.models import get_scheme

    xml = write_glasgow_model(root, rows, cols, duration, duration,
                              scheme="musclhancock")
    model = load_config(xml)
    model.output_targets = []              # the volume is read in memory
    model.config.muscl_variant = variant
    sim = model.simulation(device=device)
    _reset_launches()
    t0 = time.perf_counter()
    sim.run()                  # ends on a host read of the clock
    wall = time.perf_counter() - t0
    launches = _read_launches()
    depth = sim.depth()
    if not np.isfinite(depth).all():
        raise RuntimeError("API run: non-finite depth")
    ring = get_scheme(model.config.scheme).radius
    expected = _forced_volume(rows, cols, ring, duration)
    rel = (sim.volume() - expected) / expected
    if abs(rel) > mass_tol:
        raise RuntimeError(f"API run: mass balance off by {rel:+.4%}")
    return dict(wall_s=wall, steps=sim.total_steps, idle=sim.total_skipped,
                launches=launches, rel=rel)


def phase_slice_gpu_vs_cpu(torch, root, scheme="godunov"):
    """Phase 5: the same model at 128x128 and 120 s, float64, on the card
    and on the CPU; final fields within the f32c bounds."""
    from hipims_tpu_torch.io.xml_config import load_config

    xml = write_glasgow_model(root, 128, 128, 120.0, 120.0,
                              precision="double-strict", scheme=scheme)
    sims = {}
    for dev in ("cuda", "cpu"):
        model = load_config(xml)
        model.output_targets = []          # fields compared in memory
        sim = model.simulation(device=dev)
        sim.run()
        sims[dev] = sim
    g, c = sims["cuda"], sims["cpu"]
    if g.total_steps != c.total_steps:
        raise RuntimeError(f"step counts differ: card {g.total_steps}, cpu "
                           f"{c.total_steps}")
    rtol, atol = TOL["f32c"]
    worst = 0.0
    for name, a, b in zip(("z", "zmax", "qx", "qy"), g.state, c.state):
        excess, diff = _excess(a.cpu(), b, rtol, atol)
        worst = max(worst, diff)
        if excess > 0.0:
            raise RuntimeError(f"card and CPU runs differ in {name}: "
                               f"max|diff|={diff:.3e}")
    return g.total_steps, worst


def _expect_launches(label, launches, want):
    """Raise unless the wrappers named in ``want`` launched that many
    times (at least once) and every other wrapper not at all."""
    for name, n in launches.items():
        if n != want.get(name, 0) or (name in want and n == 0):
            raise RuntimeError(f"{label}: {name} launched {n} times, "
                               f"expected {want.get(name, 0)}; all: "
                               f"{launches}")


def _main_path_line(label, rows, cols, duration, res, smi):
    rate = res["cells"] * res["steps"] / res["wall_s"]
    setup_s = res["wall_s"] - res["run_s"]
    counts = ", ".join(f"{n} {c}" for n, c in res["launches"].items() if c)
    return (f"{label} {rows}x{cols} f32c, {duration:g} s simulated: "
            f"{res['steps']} steps (+{res['idle']} idle), wall "
            f"{res['wall_s']:.2f} s (set-up {setup_s:.1f} s, run with "
            f"outputs {res['run_s']:.1f} s), {rate:.4e} cell-steps/s on "
            f"{smi}; mass balance {res['rel']:+.4%} of rain - loss; "
            f"launches: {counts}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "hipims_tpu_torch" / "csrc" / "stencil.cu").is_file():
        print(f"chip_smoke: no hipims_tpu_torch package beside {__file__}; "
              "run it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    device = torch.device("cuda", 0)

    # Phase 1: the card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"phase 1: card {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()}), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}",
          flush=True)

    # Phase 2: build both kernel libraries from the checkout's sources,
    # one nvcc each, started together.
    from hipims_tpu_torch.ops.kernels import muscl_split, stencil
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda m: m._lib(), (stencil, muscl_split)))
    print(f"phase 2: built K1 (csrc/stencil.cu) and the MUSCL kernels "
          f"(csrc/muscl_split.cu) in {time.perf_counter() - t0:.2f} s",
          flush=True)

    # Phase 3: K1 against the plain version; 3b: the MUSCL kernels.
    max_err, times = phase_kernel_vs_plain(torch, device)
    muscl_err, muscl_times = phase_muscl_vs_plain(torch, device)

    rows, cols = 2944, 3072
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # Phase 4: the Godunov main path at 9.04 M cells.
        res = run_main_path(Path(tmp) / "main", "gpu", rows, cols,
                            600.0, 300.0)
        _expect_launches("phase 4", res["launches"], {
            "stencil_step": res["steps"] + res["idle"]})
        print(_main_path_line("phase 4: main path", rows, cols, 600.0, res,
                              smi), flush=True)

        # Phase 4b: the MUSCL main path (default variant split12).
        res_b = run_main_path(Path(tmp) / "muscl", "gpu", rows, cols,
                              300.0, 150.0, scheme="musclhancock")
        total = res_b["steps"] + res_b["idle"]
        _expect_launches("phase 4b", res_b["launches"], {
            "muscl_predict": total, "muscl_correct": total})
        print(_main_path_line("phase 4b: MUSCL main path", rows, cols, 300.0,
                              res_b, smi), flush=True)

        # Phase 4c: the recompute variant through the embedding API.
        res_c = run_api_path(Path(tmp) / "recompute", "cuda", rows, cols,
                             150.0, "recompute")
        total = res_c["steps"] + res_c["idle"]
        _expect_launches("phase 4c", res_c["launches"], {
            "muscl_predict_base": total, "muscl_correct_recompute": total})
        print(f"phase 4c: MUSCL recompute variant through load_config -> "
              f"Simulation.run, {rows}x{cols} f32c, 150 s simulated: "
              f"{res_c['steps']} steps (+{res_c['idle']} idle) in "
              f"{res_c['wall_s']:.2f} s; mass balance {res_c['rel']:+.4%}; "
              f"launches {total} each", flush=True)

        # Phase 5: the whole slice, card against CPU; 5b: MUSCL.
        for label, scheme in (("5", "godunov"), ("5b", "musclhancock")):
            steps5, err5 = phase_slice_gpu_vs_cpu(
                torch, Path(tmp) / f"slice_{scheme}", scheme)
            print(f"phase {label}: 128x128 120 s f64 {scheme} slice, card vs "
                  f"CPU: {steps5} steps, fields agree (max|diff| "
                  f"{err5:.3e})", flush=True)

    src = "hipims_tpu_torch/csrc/muscl_split.cu"
    tpu = "hipims_tpu/ops/pallas/muscl_split.py"
    kernels = [("godunov_step", "hipims_tpu_torch/csrc/stencil.cu",
                "hipims_tpu/ops/pallas/stencil.py:226",
                res["launches"]["stencil_step"], max_err,
                times[(rows, cols, "f32c")]),
               *((name, src, f"{tpu}:{line}", run["launches"][name],
                  muscl_err[name], muscl_times[(name, rows, cols, "f32c")])
                 for name, line, run in (
                     ("muscl_predict", 68, res_b),
                     ("muscl_correct", 112, res_b),
                     ("muscl_predict_base", 202, res_c),
                     ("muscl_correct_recompute", 237, res_c)))]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": rep,
         "launches": n, "max_abs_err": err, "ms": t[0], "plain_ms": t[1]}
        for name, source, rep, n, err, t in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
