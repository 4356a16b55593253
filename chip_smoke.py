#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (hipims_tpu_torch) on the GPU.

Run from the root of a checkout, on a machine with one CUDA card (or
several: phases 4k and 5i run only where two or more are visible, and
print that they did not run otherwise):

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):

1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build both kernel libraries from the checkout's sources with nvcc, in
   parallel: K1 and K4 (csrc/stencil.cu), and the MUSCL kernels K2, K3,
   K5a-P, K5a-C and K5b (csrc/muscl_split.cu);
3. K1 against its plain PyTorch version on the card, f64 / f32 / f32c, at
   a 32x128 random case, 1408x1408, the ragged 1297x1681 (one row past a
   chunk and one column past a strip of the row-marching kernels, at
   either halo width) and 2944x3072 (9.04 M cells), with per-step times of
   both;
3b. the same for the four split MUSCL kernels (all 12 predictor planes,
   then the corrector's fields), and the split12 chain (K2 -> K3) against
   the recompute chain (K5a-P -> K5a-C);
3c. the same for K4 (partial-inertial) and K5b (the whole MUSCL step:
   the row-marching corrector with slopes and base predicted in it),
   K4 also with one Manning value over the domain (where neighbours share
   a face's drag) and with one per 5x7 patch, and K5b against the split12
   chain;
4. the main path of the first slice: a Glasgow-class pluvial model
   (Godunov, 38.4 mm/h rain for the first hour plus a 6 mm/h loss, closed
   edges, XML precision "double" = compensated f32) at Thamesmead-class
   extent, 2944x3072 cells at 2 m, 600 s simulated with depth and maxdepth
   rasters every 300 s, run through ``hipims_tpu_torch.cli.main``; checks
   the rasters, the mass balance against rain minus loss, and that every
   step launched K1;
4b. the same model with <scheme name="musclhancock">, 150 s simulated with
   one raster event: every step launches K2 and K3 (the default variant,
   split12);
4c. the MUSCL model with ``muscl_variant="recompute"`` through the
   embedding API (``hipims_tpu_torch.api.simulation_load(xml)
   .launch(blocking=False)``, polled to its end), 150 s: every step
   launches K5a-P and K5a-C; no error on the run's thread; the depth read
   by ``field("depth")`` in an ``on_output`` callback is finite and holds
   the mass balance;
4d. this slice's main path: the phase-4 model with <scheme
   name="inertial">, 300 s with one raster event, through the CLI:
   every step launches K4 and no other scheme kernel; rasters, mass
   balance;
4e. the Thamesmead-class breach (tools/bench_e2e.py's terrain and
   hydrograph: Godunov, Manning 0.035, 400 m3/s through 50 west-edge
   cells, a <timeseries type="cell"> boundary) at 2944x3072, 600 s with
   rasters every 300 s, through the CLI: every step launches K1; finite
   rasters; the volume positive and not falling from the first output
   event to the second; its ratio to 400 m3/s x t is printed;
3d. K1, K4, K3, K5a-C and K5b in mesh mode (a halo-extended block: its
   origin, the logical grid and its owned cells) against their plain
   versions, f64 / f32 / f32c, on the four blocks of a 2x2 split of the
   2944x3072 random domain extended by window-8 pads (9 cells for K1 and
   K4, 17 for the MUSCL kernels) into a zero frame, and on a ragged
   1297x1681 south-east block; each block's owned cells must equal the
   whole-grid kernel's bit for bit; each kernel is timed at its default
   options on the whole grid (beside phase 3's time in the same run) and
   in mesh mode over the four blocks, K5b's plain version too (the
   kernels line's "muscl_fused_mesh");
4f. a real model directory at 2944x3072 (write_radar_model): the
   phase-4 terrain as two overlapping ``<domain>`` row bands whose DEMs
   are HFA (.img) files, radar rain as ``<timeseries type="gridded">``
   (1 km frames every 300 s, mean 38.4 mm/h, none below 6) with the 6
   mm/h loss, a depth raster and a gauge CSV of 8 points; run A, 300 s
   through the CLI with ``--checkpoint`` and outputs every 150 s; run B,
   ``--resume`` from the 150 s checkpoint to 300 s.  Checks: every step
   of both launches K1 and no other kernel; B writes no 150 s raster;
   B's 300 s raster and gauge row are bit-equal to A's; A's mass balance
   within 1% of the frames' rain minus the loss; the band DEMs read back
   and stitched equal the loader's bed.  Prints walls, steps, the seconds
   of each output event (host copy, raster, gauge, checkpoint) and the
   checkpoint's size;
4i. phase 4f's model directory at 4096x4096 (16.78 M cells) with the
   default io_mode, "auto", which streams output events from 16 M cells
   (runtime/sharded_io.py: bounded row chunks, no host copy of the grid):
   run A 120 s with --checkpoint (events at 60 and 120 s), run B resumed
   from A's streamed 60 s checkpoint, run G the same model with --io-mode
   gather.  Checks: every step of the three launches K1; A's and B's
   events streamed, G's gathered; A's depth rasters and gauge CSV the
   bytes of G's; B's 120 s raster and gauge row bit-equal to A's; A's
   mass balance within 1% of the frames' rain minus the loss; no chunk
   set over io_chunk_mb.  Prints walls, steps and each event by part
   (the chunk copies summed, derive and write of the raster, gauge,
   device volume, checkpoint) and its largest chunk set;
4g. the phase-4 model through the CLI with ``--mesh-shape 2x2`` (four
   blocks on the first card, however many are visible, lock-step:
   ``syncMethod="timestep"``), 300 s: its
   300 s rasters bit-equal to phase 4's, the mass balance, 4 K1 launches
   per step; then the phase-4b MUSCL model so, 150 s, its rasters
   bit-equal to 4b's at 150 s;
4h. phase 4f's model directory through the CLI with ``--mesh-shape
   2x1``, 300 s: two row blocks, the forecast window from the two
   ``<domain>``s' overlap, the frozen-speed dt with its re-runs; the
   mass balance within 1% of the frames' rain minus the loss, and the
   mean and max |depth - 4f run A's 300 s depth| within the JAX package's
   window-mode bars (mean 0.03 m, max 0.3 m: tests/test_sharding.py);
3e. K1 and the split12 pair K2 + K3 in float64 at 256x256 against the
   port's numpy oracles (ops/oracle.py, ops/oracle_muscl.py: per-cell
   transcriptions of the reference, a second reference beside the plain
   versions), to 1e-12; prints the max difference;
4j. the multi-process slice: the phase-4 model for 300 s (output at 300
   s, ``syncMethod="timestep"``) through the CLI as two ranks of one
   torch.distributed cluster (gloo), each a process of this script
   (``--rank-worker``) sharing the first card, ``--mesh-shape 2x1`` (one
   block a rank, strips and maxima staged through the host) with
   ``--checkpoint``: the depth and maxdepth rasters at 300 s byte-equal
   to phase 4's, exactly one set of files and one whole checkpoint (t =
   300, no ``.part``), both ranks at the same t, steps and idle steps,
   their K1 launches summing to 2 x (steps + idle), the mass balance
   within phase 4's bar; prints the run time per step beside 4's and
   4g's, and the host reads in the steps (count_host_reads);
4k. with two or more cards: the phase-4 model for 300 s, lock-step, as a
   2x2 mesh over the cards with ``--checkpoint`` and fixed batches of 64
   steps, (a) in one process (the four blocks dealt round-robin over the
   cards: strips as peer copies) and (b) as one rank per card (four, or
   two with two or three cards) under ``--distributed``, whose device
   group must be NCCL (strips and maxima card to card).  Each: rasters
   at 300 s byte-equal to phase 4's, a whole checkpoint, the mass
   balance, K1 launches 4 x (steps + idle) summed over the ranks, the
   same steps and idle steps, and no host read in the steps; prints
   both per-step times beside 4's, 4g's and 4j's;
5. the first slice whole: the phase-4 model at 128x128 and 120 s, in
   float64 ("double-strict"), on the card and on the CPU (plain
   versions); the final fields must agree within the f32c bounds; 5b: the
   same for MUSCL; 5c: for the inertial model; 5d: for the breach; 5e:
   for phase 4f's model (50 m rain cells, frames every 60 s), whose gauge
   rows must agree too; 5f: Godunov, MUSCL (split12 and recompute) and
   inertial at 128x128 as a 2x2 mesh in forecast windows of 4 steps with
   the frozen-speed dt, card against CPU (MUSCL for 60 s: MESH_SLICES);
   5g: phase 4f's model at 128x128 as a 2x2 mesh on the card, io_mode
   "stream", each event also written from a gathered snapshot of the same
   state: rasters, gauge CSV and checkpoint members equal, 4 K1 launches
   per step and re-run step; 5h: 5g's model (f32c, streamed) as a 2x2
   mesh in forecast windows over two ranks (two blocks each) through the
   CLI, against the same command in one process: rasters, gauge CSV,
   every checkpoint member and the re-run counts equal; 5i, with two or
   more cards: the same on one rank per card (the NCCL device group).
   Both take fixed batches of 8 windows (the scheme's queueSize), since
   each batch seeds its first frozen-speed window afresh (ROADMAP.md
   section 3) and two runs sized by their own clocks cannot be compared
   bit for bit.
   (In single precision the 1 mm rain films make any two f32
   implementations drift apart by ~1e-4 m within 120 s, because their
   exp/log differ by an ulp and implicit friction at h^-7/3 amplifies it:
   tests/test_torch_cli.py.)

The line before the last is a JSON record of the seven kernels and K5b's
mesh mode (with each kernel's launches in the mesh phases 4g, 4h, 4j, 4k,
5f, 5g, 5h and 5i); the last line is ``{"ok": true, "device": {...}}``.
Without CUDA, or without the package beside this file, it prints no
result and exits with status 2.  ``chip_smoke.py --rank-worker RANK RANKS
ADDR:PORT CLI-ARGS...`` is one rank of phases 4j, 4k, 5h and 5i
(``run_ranks``).
Terrain and inputs are made from fixed seeds; nothing is downloaded.
"""

from __future__ import annotations

import contextlib
import datetime as _dt
import io
import json
import os
import re
import shutil
import socket
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

# The card's peaks for ``bound_ms`` (NVIDIA's H100 SXM data sheet: HBM
# 3.35 TB/s, 67 TFLOP/s float32 outside the tensor cores; float64 34
# TFLOP/s).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "f32c": 67e12, "f64": 34e12}

XML = """<?xml version="1.0"?>
<configuration>
  <metadata><name>{name}</name>
    <description>{desc}</description>
  </metadata>
  <simulation>
    <parameter name="duration" value="{duration}" />
    <parameter name="outputFrequency" value="{outfreq}" />
    <parameter name="floatingPointPrecision" value="{precision}" />
    <domainSet{sync}>
      <domain type="cartesian">
        <data sourceDir="topography/" targetDir="output/">
          <dataSource type="raster" value="structure,dem" source="dem.tif" />
          <dataSource type="constant" value="manningCoefficient"
                      source="{manning}" />
          <dataTarget type="raster" value="depth" format="GTiff"
                      target="depth_%t.tif" />
          <dataTarget type="raster" value="maxdepth" format="GTiff"
                      target="maxdepth_%t.tif" />
        </data>
        <scheme name="{scheme}">
          <parameter name="courantNumber" value="0.5" />
          <parameter name="frictionEffects" value="yes" />{queue}
        </scheme>
        <boundaryConditions sourceDir="boundaries/">
          <domainEdge edge="north" treatment="closed" />
          <domainEdge edge="south" treatment="closed" />
          <domainEdge edge="east" treatment="closed" />
          <domainEdge edge="west" treatment="closed" />
          {boundaries}
        </boundaryConditions>
      </domain>
    </domainSet>
  </simulation>
</configuration>
"""
RAIN_BOUNDARIES = """<timeseries type="atmospheric" name="Rain"
                      value="rain-intensity" source="rain.csv" />
          <timeseries type="atmospheric" name="Drain"
                      value="loss-rate" source="drain.csv" />"""
BREACH_BOUNDARY = """<timeseries type="cell" name="Breach" value="discharge"
                      source="hydrograph.csv" mapFile="breach.csv"
                      depthValue="ignore" dischargeValue="total" />"""
RAIN_MM_H, LOSS_MM_H = 38.4, 6.0
_REAL_START = _dt.datetime(2020, 6, 1, 12, 0, 0)
# The one Manning value of phase 3c's second K4 case (the pluvial model's).
ONE_MANNING = 0.04
BREACH_M3_S = 400.0

# Kernel against plain cases: (rows, cols, kernel reps, plain reps); the
# ragged 1297x1681 ends one row past a chunk and one column past a strip of
# the row-marching kernels of either halo width: K1, K3 and K4 (120
# columns) and K5a-C (112) (tests/test_torch_geometry.py); the last is the
# main paths' grid, Thamesmead-class 9.04 M cells.
CASES = ((32, 128, 20, 5), (1408, 1408, 20, 3), (1297, 1681, 10, 2),
         (2944, 3072, 10, 2))
# Phase 4i's grid: 16.78 M cells, past the 16 M at which io_mode "auto"
# streams output events.
STREAM_GRID = (4096, 4096)


def _write_dem(root, bed, dx):
    from hipims_tpu_torch.io.raster import Raster, write_raster

    root = Path(root)
    (root / "topography").mkdir(parents=True, exist_ok=True)
    (root / "boundaries").mkdir(parents=True, exist_ok=True)
    write_raster(root / "topography" / "dem.tif",
                 Raster(data=np.asarray(bed[::-1, :], np.float32),
                        xll=0.0, yll=0.0, cell_size=dx, nodata=-9999.0))


def write_glasgow_model(root, rows, cols, duration, outfreq,
                        precision="double", dx=2.0, scheme="godunov",
                        sync=None, queue_size=None):
    """Write the Glasgow-class model (the terrain and rain/drain of
    tools/bench_e2e.py build_glasgow_class) at any extent, with the XML's
    ``scheme`` name and, given ``sync``, ``<domainSet syncMethod>`` (a
    mesh's exchange: none is the reference's default, "forecast"), and,
    given ``queue_size``, the scheme's ``queueSize``: fixed batches of
    that many steps (windows under a mesh) instead of batches sized by the
    wall clock, so two runs end on the same idle steps; returns the XML
    path.  Uses the port's own raster writer."""
    root = Path(root)
    _write_dem(root, glasgow_bed(rows, cols, dx), dx)
    (root / "boundaries" / "rain.csv").write_text(
        f"Time,Rate\n0,{RAIN_MM_H}\n3600,0\n7200,0\n")
    (root / "boundaries" / "drain.csv").write_text(
        f"Time,Rate\n0,{LOSS_MM_H}\n7200,{LOSS_MM_H}\n")
    xml = root / "model.xml"
    xml.write_text(XML.format(
        name="glasgow-class", desc="Synthetic Glasgow-class pluvial model",
        duration=duration, outfreq=outfreq, precision=precision,
        manning=0.04, scheme=scheme, boundaries=RAIN_BOUNDARIES,
        sync=f' syncMethod="{sync}"' if sync else "",
        queue="" if queue_size is None else
        f'\n          <parameter name="queueSize" value="{queue_size}" />'))
    return xml


def glasgow_bed(rows, cols, dx):
    """The Glasgow-class terrain (domain orientation, row 0 south)."""
    yy, xx = np.mgrid[0:rows, 0:cols]
    return (30.0 - xx * dx * 0.01
            + 1.5 * np.sin(yy / 12.0) * np.sin(xx / 17.0)
            + 0.5 * np.sin(yy / 3.1) * np.cos(xx / 4.3))


RADAR_XML = """<?xml version="1.0"?>
<configuration>
  <metadata><name>radar-glasgow-class</name>
    <description>Synthetic Glasgow-class model under radar rain, in two
    row bands</description>
  </metadata>
  <simulation>
    <parameter name="duration" value="{duration}" />
    <parameter name="outputFrequency" value="{outfreq}" />
    <parameter name="floatingPointPrecision" value="{precision}" />
    <parameter name="realStart" value="2020-06-01 12:00:00"
               format="%Y-%m-%d %H:%M:%S" />
    <domainSet syncMethod="forecast">
{domains}
    </domainSet>
  </simulation>
</configuration>
"""
RADAR_DOMAIN = """      <domain type="cartesian" deviceNumber="{part}">
        <data sourceDir="topography/" targetDir="output/">
          <dataSource type="raster" value="structure,dem"
                      source="dem_part{part}.img" />
          <dataSource type="constant" value="manningCoefficient"
                      source="0.04" />
          <dataTarget type="raster" value="depth" format="GTiff"
                      target="depth_%t.tif" />
          <dataTarget type="timeseries" value="depth"
                      source="boundaries/gauges.csv"
                      target="gauge_depth.csv" />
        </data>
        <scheme name="godunov">
          <parameter name="courantNumber" value="0.5" />
          <parameter name="frictionEffects" value="yes" />
        </scheme>
        <boundaryConditions sourceDir="boundaries/">
          <domainEdge edge="north" treatment="closed" />
          <domainEdge edge="south" treatment="closed" />
          <domainEdge edge="east" treatment="closed" />
          <domainEdge edge="west" treatment="closed" />
          <timeseries type="gridded" name="Radar" value="rain-intensity"
                      mask="radar_%Y%m%d_%H%M%S.asc" interval="{interval}" />
          <timeseries type="atmospheric" name="Drain"
                      value="loss-rate" source="drain.csv" />
        </boundaryConditions>
      </domain>"""


def write_radar_model(root, rows, cols, duration, outfreq,
                      precision="double", dx=2.0, interval=300.0,
                      rain_cell=1000.0, overlap=4, seed=5):
    """Write phase 4f's model directory: the Glasgow-class terrain as two
    ``<domain>`` row bands overlapping by ``overlap`` rows on each side of
    the seam (model_builder --decompose 2), their DEMs as HFA (.img)
    files; radar frames every ``interval`` s (realStart + t names them) on
    a grid of ``rain_cell`` m cells, rates uniform in [6, 70.8] mm/h
    (mean 38.4) from ``seed``; the 6 mm/h loss; a depth raster and a
    depth gauge CSV of 8 points.  Returns the XML path; the same XML with
    targetDir "output_b/" is ``model_b.xml`` beside it."""
    from hipims_tpu_torch.io.raster import Raster, write_raster

    root = Path(root)
    (root / "topography").mkdir(parents=True, exist_ok=True)
    (root / "boundaries").mkdir(parents=True, exist_ok=True)
    bed = glasgow_bed(rows, cols, dx).astype(np.float32)
    seam = rows // 2
    for part, (lo, hi) in enumerate(((0, seam + overlap),
                                     (seam - overlap, rows))):
        write_raster(root / "topography" / f"dem_part{part}.img",
                     Raster.from_domain_array(bed[lo:hi], xll=0.0,
                                              yll=lo * dx, cell_size=dx))
    grows = -(-int(rows * dx) // int(rain_cell))
    gcols = -(-int(cols * dx) // int(rain_cell))
    frames = np.random.default_rng(seed).uniform(
        LOSS_MM_H, 2 * RAIN_MM_H - LOSS_MM_H,
        (int(duration // interval) + 1, grows, gcols))
    start = _REAL_START
    for k, frame in enumerate(frames):
        name = (start + _dt.timedelta(seconds=k * interval)).strftime(
            "radar_%Y%m%d_%H%M%S.asc")
        write_raster(root / "boundaries" / name, Raster.from_domain_array(
            frame, xll=0.0, yll=0.0, cell_size=rain_cell))
    (root / "boundaries" / "drain.csv").write_text(
        f"Time,Rate\n0,{LOSS_MM_H}\n{duration},{LOSS_MM_H}\n")
    (root / "boundaries" / "gauges.csv").write_text("x,y,name\n" + "".join(
        f"{(0.1 + 0.8 * fx) * cols * dx:.3f},"
        f"{(0.1 + 0.8 * fy) * rows * dx:.3f},G{k + 1}\n"
        for k, (fx, fy) in enumerate(
            [(0.0, 0.0), (1.0, 0.0), (0.0, 1.0), (1.0, 1.0), (0.5, 0.5),
             (0.25, 0.75), (0.75, 0.25), (0.5, 0.95)])))
    xml = root / "model.xml"
    xml.write_text(RADAR_XML.format(
        duration=duration, outfreq=outfreq, precision=precision,
        domains="\n".join(RADAR_DOMAIN.format(part=part, interval=interval)
                          for part in (0, 1))))
    (root / "model_b.xml").write_text(xml.read_text().replace(
        'targetDir="output/"', 'targetDir="output_b/"'))
    return xml


def radar_volume(root, rows, cols, duration, interval, ring, dx=2.0):
    """Rain minus loss over ``duration`` on the forced cells (the grid
    minus the scheme's static ring), from the radar frames in ``root``:
    each frame over its ``interval``, each cell under its rain cell."""
    from hipims_tpu_torch.io.raster import read_raster

    paths = sorted((Path(root) / "boundaries").glob("radar_*.asc"))
    total = 0.0
    for k, path in enumerate(paths):
        seconds = min((k + 1) * interval, duration) - k * interval
        if seconds <= 0.0:
            continue
        r = read_raster(path)
        frame = r.to_domain_array()
        ri = np.minimum(np.arange(ring, rows - ring) * dx // r.cell_size,
                        frame.shape[0] - 1).astype(int)
        ci = np.minimum(np.arange(ring, cols - ring) * dx // r.cell_size,
                        frame.shape[1] - 1).astype(int)
        total += frame[np.ix_(ri, ci)].sum() / 3.6e6 * seconds
    forced = (rows - 2 * ring) * (cols - 2 * ring)
    return (total - LOSS_MM_H / 3.6e6 * duration * forced) * dx * dx


def write_thamesmead_model(root, rows, cols, duration, outfreq,
                           precision="double", dx=2.0):
    """Write the Thamesmead-class breach (tools/bench_e2e.py
    build_thamesmead_class: a dry floodplain rising 0.2% away from the
    river edge, 400 m3/s for the first 2 h through 50 cells of the second
    column, a <timeseries type="cell"> boundary; Godunov, Manning 0.035)
    at any extent; returns the XML path."""
    root = Path(root)
    yy, xx = np.mgrid[0:rows, 0:cols]
    _write_dem(root, 2.0 + xx * dx * 0.002
               + 0.2 * np.sin(yy / 40.0) * np.sin(xx / 60.0), dx)
    nb = min(25, rows // 4)
    (root / "boundaries" / "breach.csv").write_text("\n".join(
        f"{1.0 * dx + 0.01},{(rows // 2 + i) * dx + 0.01}"
        for i in range(-nb, nb)) + "\n")
    hydro = ["Time,Depth,Qx,Qy"] + [
        f"{t},0,{BREACH_M3_S if t < 7200 else 0.0},0"
        for t in range(0, max(int(duration), 7200) + 1, 3600)]
    (root / "boundaries" / "hydrograph.csv").write_text(
        "\n".join(hydro) + "\n")
    xml = root / "model.xml"
    xml.write_text(XML.format(
        name="thamesmead-class", desc="Synthetic Thamesmead-class breach",
        duration=duration, outfreq=outfreq, precision=precision,
        manning=0.035, scheme="godunov", boundaries=BREACH_BOUNDARY,
        sync="", queue=""))
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


def patch_manning(rows, cols, patch_rows, patch_cols, seed=2):
    """A Manning plane with one value per patch of patch_rows x patch_cols
    cells (land-use patches), drawn from random_domain's range."""
    patch = np.random.default_rng(seed).uniform(
        0.01, 0.06, (rows // patch_rows + 1, cols // patch_cols + 1))
    return np.ascontiguousarray(np.repeat(np.repeat(
        patch, patch_rows, 0), patch_cols, 1)[:rows, :cols])

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


def phase_fused_vs_plain(torch, device, schemes, label):
    """Phases 3 and 3c: the fused step kernel of each scheme in
    ``schemes`` (K1 "godunov", K4 "inertial", K5b "muscl-hancock")
    against its plain version on the card and on the same inputs, with
    per-step times of both.  With "inertial", K4 is also held to its plain
    version with one Manning value over the domain (ONE_MANNING), where
    each face's drag is shared by its two cells, and with one value per
    5x7 patch (patch_manning).  With
    "muscl-hancock", K5b is also held against the split12 chain (K2 -> K3)
    at the JAX package's bar for two MUSCL paths (rel 1e-13); bit-equal is
    expected.  Returns the largest
    |diff| per kernel, the times per (kernel, rows, cols, mode) and the
    largest K5b-split12 |diff|."""
    from hipims_tpu_torch.ops.godunov import SchemeParams
    from hipims_tpu_torch.ops.kernels import muscl_split as ms
    from hipims_tpu_torch.ops.kernels import stencil as st
    from hipims_tpu_torch.state import DomainStatic

    params = SchemeParams(dx=2.0, dy=2.0)
    kernels = {s: dict(zip(("godunov", "inertial", "muscl-hancock"),
                           st.KERNELS))[s].__name__ for s in schemes}
    worst = {k: 0.0 for k in kernels.values()}
    times = {}
    split_diff = layout_diff = 0.0
    for rows, cols, reps, plain_reps in CASES:
        arrs = random_domain(0, rows, cols)
        for mode in ("f64", "f32", "f32c"):
            state, static, comp, dt = _card_inputs(torch, device, arrs, mode)
            for scheme, name in kernels.items():
                simple = scheme == "inertial"

                def kernel():
                    return st.stencil_step(scheme, state, static, dt, params,
                                           comp=comp, simplified_speed=simple)

                def plain():
                    return st.PLAIN[scheme](state, static, dt, params,
                                            comp=comp,
                                            simplified_speed=simple)

                got, want = kernel(), plain()
                torch.cuda.synchronize()
                worst[name] = max(worst[name], _agree(
                    f"{name} disagrees with the plain version: "
                    f"{rows}x{cols}", mode, _step_pairs(got, want)))
                if scheme == "inertial":
                    # One Manning value, where neighbours share each face's
                    # drag, and one per 5x7 patch, where only cells of one
                    # patch do: both branches of K4 in one warp.
                    for manning in (np.full((rows, cols), ONE_MANNING),
                                    patch_manning(rows, cols, 5, 7)):
                        layout = DomainStatic(static.zb, torch.as_tensor(
                            manning, device=device).to(static.zb.dtype))
                        got = st.stencil_step(scheme, state, layout, dt,
                                              params, comp=comp,
                                              simplified_speed=True)
                        want = st.PLAIN[scheme](state, layout, dt, params,
                                                comp=comp,
                                                simplified_speed=True)
                        torch.cuda.synchronize()
                        layout_diff = max(layout_diff, _agree(
                            f"{name} with shared Manning values disagrees "
                            f"with the plain version: {rows}x{cols}", mode,
                            _step_pairs(got, want)))
                    worst[name] = max(worst[name], layout_diff)
                if scheme == "muscl-hancock":
                    split = ms.muscl_step_split(state, static, dt, params,
                                                "split12", comp)
                    torch.cuda.synchronize()
                    split_diff = max(split_diff, _agree(
                        f"K5b and split12 differ at {rows}x{cols}", mode,
                        _step_pairs(got, split), bars=(1e-13, 1e-15)))
                times[(name, rows, cols, mode)] = (
                    _time_ms(torch, kernel, reps),
                    _time_ms(torch, plain, plain_reps))
            per_step = ", ".join(
                f"{n} {times[(n, rows, cols, mode)][0]:.4f} / "
                f"{times[(n, rows, cols, mode)][1]:.4f}"
                for n in kernels.values())
            print(f"phase {label}: fused steps vs plain {rows}x{cols} {mode}: "
                  "agree (max|diff| so far "
                  + ", ".join(f"{n} {e:.3e}" for n, e in worst.items())
                  + (f"; K4 with one Manning value and 5x7 patches "
                     f"{layout_diff:.3e}"
                     if "inertial" in kernels else "")
                  + (f"; K5b vs split12 {split_diff:.3e}"
                     if "muscl-hancock" in kernels else "")
                  + f"); per step kernel / plain ms: {per_step}", flush=True)
    return worst, times, split_diff


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
    for rows, cols, reps, plain_reps in CASES:
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
    return {k.__name__: k for k in (*stencil.KERNELS, *muscl_split.KERNELS)}


def _reset_launches():
    for k in kernel_wrappers().values():
        k.launches = 0


def _read_launches():
    return {name: k.launches for name, k in kernel_wrappers().items()}


# The calls that read a tensor back to the host, or wait for the card.
HOST_READS = ("item", "cpu", "tolist", "numpy", "__bool__", "__float__",
              "__int__")


@contextlib.contextmanager
def count_host_reads():
    """Count, while the block runs, the host reads made inside a mesh
    run's batches (``HaloDeepBlocks.run_batch``: the steps, their
    exchanges and maxima, and the batch's NaN probe): every call of the
    HOST_READS methods of a tensor and of ``torch.cuda.synchronize``.
    Yields a dict whose "reads" and "batches" grow as they happen; the
    batch's own carry read (``Simulation._read_carry``) lies outside."""
    import torch
    from hipims_tpu_torch.parallel.halo_deep import HaloDeepBlocks

    counts = dict(reads=0, batches=0, inside=False)
    saved = {name: getattr(torch.Tensor, name) for name in HOST_READS}
    own = {name: name in vars(torch.Tensor) for name in HOST_READS}
    sync, run_batch = torch.cuda.synchronize, HaloDeepBlocks.run_batch

    def counted(fn):
        def call(*args, **kwargs):
            if counts["inside"]:
                counts["reads"] += 1
            return fn(*args, **kwargs)
        return call

    def batch(self, *args, **kwargs):
        counts["batches"] += 1
        counts["inside"] = True
        try:
            return run_batch(self, *args, **kwargs)
        finally:
            counts["inside"] = False

    try:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, counted(fn))
        torch.cuda.synchronize = counted(sync)
        HaloDeepBlocks.run_batch = batch
        yield counts
    finally:
        for name, fn in saved.items():
            if own[name]:
                setattr(torch.Tensor, name, fn)
            else:
                delattr(torch.Tensor, name)
        torch.cuda.synchronize = sync
        HaloDeepBlocks.run_batch = run_batch


def _forced_volume(rows, cols, ring, duration):
    """Rain minus loss on the forced cells: the grid minus the scheme's
    static ring, which the closed-edge walls occupy."""
    forced = (rows - 2 * ring) * (cols - 2 * ring) * 2.0 * 2.0
    return (RAIN_MM_H - LOSS_MM_H) / 3.6e6 * duration * forced


def _run_cli(xml, device, *extra):
    """Run ``xml`` through the CLI with --mass-balance (and ``extra``
    arguments) on ``device`` ("gpu" or "cpu").  Returns what it measured:
    wall and run seconds, steps (+ idle), the volume at each output event,
    the launches of every kernel wrapper during the run and the log."""
    from hipims_tpu_torch.cli import main as cli_main

    buf = io.StringIO()
    _reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["-c", str(xml), "-n", "--mass-balance",
                       "--platform", device, *extra])
    wall = time.perf_counter() - t0
    launches = _read_launches()
    out = buf.getvalue()
    if rc != 0:
        raise RuntimeError(f"CLI run failed with status {rc}:\n{out}")
    m = re.search(r"Iterations:\s+(\d+) \(\+(\d+) idle\)", out)
    if m is None:
        raise RuntimeError(f"no iteration count in the CLI output:\n{out}")
    # The CLI times Simulation.run (steps + output writes); the rest of
    # the wall is set-up: model load, Domain.build, transfer to device.
    run_s = float(re.search(r"Simulated:.* in ([0-9.]+) s wall",
                            out).group(1))
    vols = [float(v) for v in re.findall(r"volume=([0-9.eE+-]+) m3", out)]
    return dict(wall_s=wall, run_s=run_s, steps=int(m.group(1)),
                idle=int(m.group(2)), launches=launches, volumes=vols,
                log=out)


def _check_rasters(root, rows, cols, duration, outfreq):
    """Every output event wrote finite depth and maxdepth rasters of the
    full shape."""
    from hipims_tpu_torch.io.raster import read_raster

    for k in range(1, int(round(duration / outfreq)) + 1):
        label = f"{k * outfreq:g}"
        for value in ("depth", "maxdepth"):
            path = Path(root) / "output" / f"{value}_{label}.tif"
            r = read_raster(path)
            if r.data.shape != (rows, cols) or not np.isfinite(r.data).all():
                raise RuntimeError(f"{path.name}: bad raster "
                                   f"{r.data.shape}, finite="
                                   f"{bool(np.isfinite(r.data).all())}")


def run_main_path(root, device, rows, cols, duration, outfreq,
                  mass_tol=MASS_BALANCE_REL, scheme="godunov", sync=None,
                  extra=(), queue_size=None):
    """Phases 4, 4b, 4d and 4g: write the pluvial model with the XML's
    ``scheme`` name (and ``sync`` and ``queue_size``, see
    write_glasgow_model), run it through
    the CLI on ``device`` ("gpu" or "cpu") with the ``extra`` arguments,
    check outputs and mass balance.  Returns a dict of what it measured,
    with the launches of every kernel wrapper during the run.

    Rain and loss apply in hydrological chunks of >= 1 s, so the last
    partial chunk (< 1 s of forcing) is missing at the end of a run:
    0.17% of 600 s, but several percent of a very short run, which then
    needs a looser ``mass_tol``."""
    from hipims_tpu_torch.models import get_scheme

    xml = write_glasgow_model(root, rows, cols, duration, outfreq,
                              scheme=scheme, sync=sync,
                              queue_size=queue_size)
    res = _run_cli(xml, device, *extra)
    _check_rasters(root, rows, cols, duration, outfreq)
    vols, n_out = res["volumes"], int(round(duration / outfreq))
    if len(vols) != n_out:
        raise RuntimeError(f"expected {n_out} mass-balance lines:\n"
                           f"{res['log']}")
    ring = get_scheme(re.search(r"Scheme:\s+(\S+)",
                                res["log"]).group(1)).radius
    expected = _forced_volume(rows, cols, ring, duration)
    rel = (vols[-1] - expected) / expected
    if abs(rel) > mass_tol:
        raise RuntimeError(f"mass balance off by {rel:+.4%}: volume "
                           f"{vols[-1]:.3f} m3, rain - loss {expected:.3f}")
    return dict(res, volume=vols[-1], expected=expected, rel=rel,
                cells=rows * cols)


def run_breach_path(root, device, rows, cols, duration, outfreq):
    """Phase 4e: write the Thamesmead-class breach, run it through the CLI
    on ``device``, check the rasters and that the volume is positive and
    never falls between output events (a closed domain that only gains
    water).  Returns what it measured, with the volume's ratio to
    400 m3/s x t: the reference's cell forcing raises a cell by q dt / dy
    for its share q of the discharge, which is not Q t by construction."""
    xml = write_thamesmead_model(root, rows, cols, duration, outfreq)
    res = _run_cli(xml, device)
    _check_rasters(root, rows, cols, duration, outfreq)
    vols = res["volumes"]
    if (len(vols) != int(round(duration / outfreq)) or vols[0] <= 0.0
            or any(b < a for a, b in zip(vols, vols[1:]))):
        raise RuntimeError(f"breach volumes {vols}: expected one positive, "
                           f"non-decreasing value per output event")
    return dict(res, volume=vols[-1], cells=rows * cols,
                ratio=vols[-1] / (BREACH_M3_S * duration))


def run_api_path(root, device, rows, cols, duration, variant,
                 mass_tol=MASS_BALANCE_REL):
    """Phase 4c: the MUSCL model through the embedding API on ``device``
    with ``SimulationConfig.muscl_variant = variant``: launched on a
    background thread and polled to its end; ``field("depth")`` read in
    an ``on_output`` callback (no rasters are written) must be finite and
    hold the mass balance.  Returns what it measured."""
    from hipims_tpu_torch.api import simulation_load
    from hipims_tpu_torch.models import get_scheme
    from hipims_tpu_torch.runtime.output import NODATA

    xml = write_glasgow_model(root, rows, cols, duration, duration,
                              scheme="musclhancock")
    handle = simulation_load(xml, device=device)
    sim = handle.simulation
    sim.output_writer = None               # the depth is read in memory
    sim.config.muscl_variant = variant
    depths = []
    handle.on_output(lambda h, t: depths.append((t, h.field("depth"))))
    _reset_launches()
    t0 = time.perf_counter()
    handle.launch(blocking=False)
    while handle.running:
        time.sleep(0.02)
    wall = time.perf_counter() - t0
    launches = _read_launches()
    if handle.error is not None:
        raise RuntimeError(f"API run failed: {handle.error!r}") \
            from handle.error
    (t, depth), = depths
    if t != duration or not np.isfinite(depth).all():
        raise RuntimeError(f"API run: one finite depth at {duration} s "
                           f"expected, got t={t}")
    volume = float(np.where(depth != NODATA, depth, 0.0).sum()
                   * sim.domain.dx * sim.domain.dy)
    ring = get_scheme(sim.config.scheme).radius
    expected = _forced_volume(rows, cols, ring, duration)
    rel = (volume - expected) / expected
    if abs(rel) > mass_tol:
        raise RuntimeError(f"API run: mass balance off by {rel:+.4%}")
    return dict(wall_s=wall, steps=sim.total_steps, idle=sim.total_skipped,
                launches=launches, rel=rel)


# The timed parts of an output event (seconds); an event's dict may also
# hold "chunk_set_bytes", the largest chunk set a streamed event copied.
EVENT_PARTS = ("copy", "snapshot", "chunks", "raster", "gauge", "volume",
               "checkpoint")


@contextlib.contextmanager
def output_events():
    """Time every output event's parts while the block runs, one dict per
    event in the list it yields: the gathered event's host copy of the
    state ("copy"), or the streamed event's snapshot and its row-chunk
    copies off the device, summed ("chunks"), and its largest chunk set
    ("chunk_set_bytes"); then the rasters (derive and write, all
    targets), the gauges, the streamed event's volume (a device sum) and
    the checkpoint, each without the chunk copies made inside it.  Keeps
    a copy of each checkpoint written as <stem>_<t>.npz beside it."""
    from hipims_tpu_torch.runtime import (checkpoint, output, sharded_io,
                                          simulation)
    from hipims_tpu_torch.utils import time_label

    events = []
    streamed = [False]      # whether the open event streams

    def timed(fn, part):
        def wrapper(*args, **kw):
            if part in ("copy", "snapshot"):
                events.append({})
                streamed[0] = part == "snapshot"
            elif part in ("chunks", "volume") and not streamed[0]:
                # A gathered event's chunk is its host copy, and the
                # start volume is read before any event.
                return fn(*args, **kw)
            chunks0 = events[-1].get("chunks", 0.0)
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            spent = time.perf_counter() - t0
            if part != "chunks":
                spent -= events[-1].get("chunks", 0.0) - chunks0
            events[-1][part] = events[-1].get(part, 0.0) + spent
            return out
        return wrapper

    def chunk_sets(fn):
        def wrapper(self, *args, **kw):
            for r0, st, sc in fn(self, *args, **kw):
                if streamed[0]:
                    size = sum(a.nbytes for a in (*st, *sc))
                    events[-1]["chunk_set_bytes"] = max(
                        size, events[-1].get("chunk_set_bytes", 0))
                yield r0, st, sc
        return wrapper

    def save(path, sim, snapshot=None):
        save_timed(path, sim, snapshot=snapshot)
        path = Path(path)
        shutil.copy(path, path.with_name(
            f"{path.stem}_{time_label(sim.t)}{path.suffix}"))

    timed_parts = [(simulation._OutputSnapshot, "__init__", "copy"),
                   (simulation._StreamingSnapshot, "__init__", "snapshot"),
                   (sharded_io, "host_rows", "chunks"),
                   (output.RasterOutputWriter, "__call__", "raster"),
                   (output.GaugeOutputWriter, "__call__", "gauge"),
                   (simulation.Simulation, "volume", "volume")]
    saved = [(obj, name) for obj, name, _ in timed_parts] + [
        (simulation._Snapshot, "stream_chunks"),
        (checkpoint, "save_checkpoint")]
    originals = [getattr(obj, name) for obj, name in saved]
    for obj, name, part in timed_parts:
        setattr(obj, name, timed(getattr(obj, name), part))
    simulation._Snapshot.stream_chunks = chunk_sets(originals[-2])
    save_timed = timed(originals[-1], "checkpoint")
    checkpoint.save_checkpoint = save
    try:
        yield events
    finally:
        for (obj, name), fn in zip(saved, originals):
            setattr(obj, name, fn)


def format_events(events):
    """One output event per "; "-separated item: its parts in seconds,
    and its largest chunk set in MiB where it streamed."""
    return "; ".join(", ".join(
        [f"{k} {e[k]:.2f}" for k in EVENT_PARTS if k in e]
        + ([f"largest chunk set {e['chunk_set_bytes'] / 2 ** 20:.2f} MiB"]
           if "chunk_set_bytes" in e else [])) for e in events)


def run_radar_path(root, device, rows, cols, duration, outfreq,
                   interval=300.0, rain_cell=1000.0,
                   mass_tol=MASS_BALANCE_REL, io_mode=None, gather_run=False):
    """Phases 4f and 4i: write the radar model, run A through the CLI on
    ``device`` with --checkpoint (an output event every ``outfreq`` s),
    run B with --resume from A's first checkpoint, and check B against A
    bit for bit (raster and gauge row at ``duration``), A's mass balance
    against the frames' rain minus the loss, and the band DEMs against
    the loader's bed.  A and B run with ``--io-mode io_mode`` where it is
    given.  With ``gather_run``, run G is the same model with --io-mode
    gather, whose depth rasters and gauge CSV must be A's bytes.  Returns
    what it measured."""
    from hipims_tpu_torch.io.raster import read_raster
    from hipims_tpu_torch.io.xml_config import load_config
    from hipims_tpu_torch.models import get_scheme
    from hipims_tpu_torch.utils import time_label

    root = Path(root)
    xml = write_radar_model(root, rows, cols, duration, outfreq,
                            interval=interval, rain_cell=rain_cell)
    ck = root / "run.npz"
    mode = ("--io-mode", io_mode) if io_mode else ()
    with output_events() as events_a:
        res_a = _run_cli(xml, device, "--checkpoint", str(ck), *mode)
    first = root / f"run_{time_label(outfreq)}.npz"
    with output_events() as events_b:
        res_b = _run_cli(root / "model_b.xml", device, "--resume",
                         str(first), *mode)
    # The step counters resume with the checkpoint: run B's own steps are
    # those past it.
    with np.load(first) as data:
        res_b["steps"] -= int(data["batch_successful"])
        res_b["idle"] -= int(data["batch_skipped"])

    end, half = time_label(duration), time_label(outfreq)
    if (root / "output_b" / f"depth_{half}.tif").exists():
        raise RuntimeError(f"resumed run wrote the {half} s raster again")
    a, b = (read_raster(root / d / f"depth_{end}.tif").data
            for d in ("output", "output_b"))
    if not np.array_equal(a, b):
        raise RuntimeError(f"resumed {end} s raster differs from run A's: "
                           f"max|diff| {np.abs(a - b).max():.3e}")
    rows_a, rows_b = ((root / d / "gauge_depth.csv").read_text().splitlines()
                      for d in ("output", "output_b"))
    n_out = int(round(duration / outfreq))
    if (len(rows_a) != n_out + 1 or rows_b[1:] != rows_a[-1:]
            or rows_b[0] != rows_a[0] or len(rows_a[0].split(",")) != 9):
        raise RuntimeError(f"gauge rows: run A {rows_a}, run B {rows_b}")

    res_g, events_g = None, None
    if gather_run:
        (root / "model_g.xml").write_text(xml.read_text().replace(
            'targetDir="output/"', 'targetDir="output_g/"'))
        with output_events() as events_g:
            res_g = _run_cli(root / "model_g.xml", device, "--io-mode",
                             "gather")
        a, g = ({p.name: p.read_bytes() for p in (root / d).iterdir()}
                for d in ("output", "output_g"))
        if len(a) != n_out + 1 or a != g:
            raise RuntimeError(f"streamed run A's outputs {sorted(a)} are "
                               f"not the gathered run's bytes {sorted(g)}")

    ring = get_scheme("godunov").radius
    expected = radar_volume(root, rows, cols, duration, interval, ring)
    rel = (res_a["volumes"][-1] - expected) / expected
    if len(res_a["volumes"]) != n_out or abs(rel) > mass_tol:
        raise RuntimeError(f"radar mass balance off by {rel:+.4%}: "
                           f"volumes {res_a['volumes']}, rain - loss "
                           f"{expected:.3f}")

    bands = [read_raster(root / "topography" / f"dem_part{k}.img")
             for k in (0, 1)]
    stitched = np.full((rows, cols), np.nan)
    for band in bands:
        lo = int(round(band.yll / band.cell_size))
        stitched[lo:lo + band.rows] = band.to_domain_array()
    if not np.array_equal(stitched, load_config(xml).domain.zb):
        raise RuntimeError("the stitched .img DEM differs from the "
                           "loader's bed")
    return dict(a=res_a, b=res_b, g=res_g, events_a=events_a,
                events_b=events_b, events_g=events_g,
                rel=rel, expected=expected, gauges=rows_a,
                checkpoint_mb=first.stat().st_size / 2 ** 20,
                cells=rows * cols)


def phase_radar_slice(torch, root):
    """Phase 5e: phase 4f's model at 128x128, 120 s, float64, with 50 m
    rain cells and frames every 60 s, on the card and on the CPU through
    load_config -> Simulation.run; the final fields and every gauge row
    must agree within the f32c bounds."""
    from hipims_tpu_torch.io.xml_config import load_config

    xml = write_radar_model(root, 128, 128, 120.0, 60.0,
                            precision="double-strict", interval=60.0,
                            rain_cell=50.0)
    sims, gauges = {}, {}
    for dev in ("cuda", "cpu"):
        model = load_config(xml)
        model.target_dir = str(Path(root) / f"out_{dev}")
        sim = model.simulation(device=dev)
        sim.run()
        sims[dev] = sim
        gauges[dev] = np.loadtxt(Path(model.target_dir) / "gauge_depth.csv",
                                 delimiter=",", skiprows=1)
    g, c = sims["cuda"], sims["cpu"]
    if g.total_steps != c.total_steps:
        raise RuntimeError(f"step counts differ: card {g.total_steps}, cpu "
                           f"{c.total_steps}")
    rtol, atol = TOL["f32c"]
    pairs = [(name, a.cpu(), b) for name, a, b in
             zip(("z", "zmax", "qx", "qy"), g.state, c.state)]
    pairs.append(("gauges", torch.as_tensor(gauges["cuda"]),
                   torch.as_tensor(gauges["cpu"])))
    worst = 0.0
    for name, a, b in pairs:
        excess, diff = _excess(a, b, rtol, atol)
        worst = max(worst, diff)
        if excess > 0.0:
            raise RuntimeError(f"card and CPU runs differ in {name}: "
                               f"max|diff|={diff:.3e}")
    if gauges["cuda"].shape != (2, 9) or not (gauges["cuda"][:, 1:] > 0).any():
        raise RuntimeError(f"gauge rows {gauges['cuda']}")
    return g.total_steps, worst


def phase_slice_gpu_vs_cpu(torch, xml):
    """Phase 5: the model ``xml`` (128x128, 120 s, float64) on the card
    and on the CPU; final fields within the f32c bounds."""
    from hipims_tpu_torch.io.xml_config import load_config

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


# Phase 3d: the five mesh-mode kernels, each as a step takes it (K3 and
# K5a-C behind their predictor, whose planes the plain corrector is also
# fed), with the mesh options ``mesh`` (none: the one-device defaults).
MESH_KERNELS = ("godunov_fused", "inertial_fused", "muscl_correct",
                "muscl_correct_recompute", "muscl_fused")


def _mesh_step(name, state, static, comp, dt, params, plain=False, pred=None,
               **mesh):
    """Kernel ``name`` (or, with ``plain``, its plain version) of
    MESH_KERNELS on the inputs; K3 and K5a-C take ``pred`` (their
    predictor's planes).  Returns the step's result."""
    from hipims_tpu_torch.ops.kernels import muscl_split as ms
    from hipims_tpu_torch.ops.kernels import stencil as st

    if name in ("godunov_fused", "inertial_fused", "muscl_fused"):
        scheme = {"godunov_fused": "godunov", "inertial_fused": "inertial",
                  "muscl_fused": "muscl-hancock"}[name]
        fn = st.PLAIN[scheme] if plain else getattr(st, name)
        return fn(state, static, dt, params, comp=comp,
                  simplified_speed=scheme == "inertial", **mesh)
    fn = ms.muscl_correct_plain if plain else getattr(ms, name)
    return fn(state, static, pred, dt, params, comp=comp, **mesh)


def _mesh_pred(name, state, static, dt, params):
    """The predictor planes kernel ``name`` takes (K2's for K3, K5a-P's
    for K5a-C), from the predictor kernel; None for K1, K4 and K5b."""
    from hipims_tpu_torch.ops.kernels import muscl_split as ms

    if name == "muscl_correct":
        return ms.muscl_predict(state, static, dt, params)
    if name == "muscl_correct_recompute":
        return ms.muscl_predict_base(state, static, dt, params)
    return None


def mesh_blocks(rows, cols, ragged=(1297, 1681)):
    """Phase 3d's blocks of a rows x cols grid: the four of a 2x2 split,
    then a ``ragged`` block at the south-east corner (1297x1681: one row
    past a chunk and one column past a strip of either halo, as in CASES),
    each as (r0, nr, c0, nc)."""
    from hipims_tpu_torch.parallel.mesh import block_geometry

    owns = [own for _, own in sorted(block_geometry(rows, cols,
                                                    (2, 2)).items())]
    return owns + [(rows - ragged[0], ragged[0], cols - ragged[1],
                    ragged[1])]


def phase_mesh_vs_plain(torch, device, times):
    """Phase 3d: K1, K4, K3, K5a-C and K5b in mesh mode on the blocks of
    mesh_blocks, each extended by its window-8 pads into a zero frame
    (parallel/halo_deep.py), against their plain versions with the same
    options; each block's owned cells and max speed must equal the
    whole-grid kernel's, bit for bit.  Times each kernel at its default
    options on the whole grid, beside phase 3's time (``times``) of the
    same run, and in mesh mode over the four even blocks (K5b's plain
    version too, in f32c: the kernels line's entry for its mesh mode).
    Returns the largest |diff| per kernel, the times per (kernel, mode)
    and, for the four blocks, K5b's plain f32c ms and their cells."""
    from hipims_tpu_torch.ops.godunov import SchemeParams
    from hipims_tpu_torch.ops.timestep import max_wave_speed
    from hipims_tpu_torch.parallel.halo_deep import extend, halo_pads
    from hipims_tpu_torch.state import DomainStatic, FlowState

    params = SchemeParams(dx=2.0, dy=2.0)
    rows, cols, reps, _ = CASES[-1]
    arrs = random_domain(0, rows, cols)
    owns = mesh_blocks(rows, cols)
    worst = {n: 0.0 for n in MESH_KERNELS}
    mesh_times = {}
    for mode in ("f64", "f32", "f32c"):
        state, static, comp, dt = _card_inputs(torch, device, arrs, mode)
        for name in MESH_KERNELS:
            radius = 2 if name.startswith("muscl") else 1
            pads = halo_pads(8, radius)
            pred = _mesh_pred(name, state, static, dt, params)
            whole = _mesh_step(name, state, static, comp, dt, params,
                               pred=pred)
            runs = []
            for own in owns:
                r0, nr, c0, nc = own

                def ext(a):
                    return (None if a is None
                            else extend(a, own, pads, a.device))

                b_state = FlowState(*map(ext, state))
                b_static = DomainStatic(*map(ext, static))
                b_comp = ext(comp)
                b_pred = _mesh_pred(name, b_state, b_static, dt, params)
                mesh = dict(origin=(r0 - pads[0], c0 - pads[1]),
                            logical=(rows, cols),
                            speed_window=(pads[0], nr, pads[1], nc))
                got = _mesh_step(name, b_state, b_static, b_comp, dt, params,
                                 pred=b_pred, **mesh)
                want = _mesh_step(name, b_state, b_static, b_comp, dt,
                                  params, plain=True, pred=b_pred, **mesh)
                torch.cuda.synchronize()
                worst[name] = max(worst[name], _agree(
                    f"{name} in mesh mode disagrees with the plain version "
                    f"on block {own}", mode, _step_pairs(got, want)))
                mine = (slice(pads[0], pads[0] + nr),
                        slice(pads[1], pads[1] + nc))
                theirs = (slice(r0, r0 + nr), slice(c0, c0 + nc))
                planes = [*zip(got[0], whole[0])]
                if comp is not None:
                    planes.append((got[2], whole[2]))
                owned_speed = max_wave_speed(
                    *(a[theirs] for a in whole[0]), static.zb[theirs],
                    params.quite_small, name == "inertial_fused")
                if not (all(torch.equal(g[mine], w[theirs])
                            for g, w in planes)
                        and torch.equal(got[1], owned_speed)):
                    raise RuntimeError(
                        f"{name} {mode}: block {own}'s owned cells differ "
                        "from the whole-grid kernel's")
                runs.append((b_state, b_static, b_comp, b_pred, mesh))
            default_ms = _time_ms(torch, lambda: _mesh_step(
                name, state, static, comp, dt, params, pred=pred), reps)
            mesh_ms = _time_ms(torch, lambda: [
                _mesh_step(name, bs, bt, bc, dt, params, pred=bp, **m)
                for bs, bt, bc, bp, m in runs[:4]], reps)
            mesh_times[(name, mode)] = (default_ms, mesh_ms)
            if name == "muscl_fused" and mode == "f32c":
                k5b_plain_ms = _time_ms(torch, lambda: [
                    _mesh_step(name, bs, bt, bc, dt, params, plain=True,
                               **m) for bs, bt, bc, _, m in runs[:4]],
                    CASES[-1][3])
                block_cells = sum(bs.z.numel() for bs, *_ in runs[:4])
        print(f"phase 3d: mesh-mode kernels vs plain, 2x2 blocks of "
              f"{rows}x{cols} + a ragged {owns[-1][1]}x{owns[-1][3]} block, "
              f"{mode}: agree "
              f"(max|diff| so far "
              + ", ".join(f"{n} {e:.3e}" for n, e in worst.items())
              + "), owned cells equal the whole-grid kernel's; ms default "
              "options / phase 3 / mesh mode over 4 blocks: "
              + ", ".join(f"{n} {mesh_times[(n, mode)][0]:.4f} / "
                          f"{times[(n, rows, cols, mode)][0]:.4f} / "
                          f"{mesh_times[(n, mode)][1]:.4f}"
                          for n in MESH_KERNELS), flush=True)
    return worst, mesh_times, (k5b_plain_ms, block_cells)


def _same_rasters(label, root, ref_root, t):
    """Raise unless the depth and maxdepth rasters at ``t`` under ``root``
    equal those under ``ref_root`` bit for bit."""
    from hipims_tpu_torch.io.raster import read_raster

    for value in ("depth", "maxdepth"):
        a, b = (read_raster(Path(r) / "output" / f"{value}_{t:g}.tif").data
                for r in (root, ref_root))
        if not np.array_equal(a, b):
            raise RuntimeError(f"{label}: {value} at {t:g} s differs from "
                               f"the one-device run's: max|diff| "
                               f"{np.abs(a - b).max():.3e}")


# Phase 4h's bars on |depth - the one-device depth| (m): the JAX package's
# bars between window-mode and lock-step runs (tests/test_sharding.py
# test_forecast_window_dt_deterministic_across_mesh), given before the run.
WINDOW_DEPTH_BARS = (0.03, 0.3)


def run_mesh_radar_path(root, device, rows, cols, duration, outfreq,
                        ref_root, interval=300.0, rain_cell=1000.0,
                        mass_tol=MASS_BALANCE_REL):
    """Phase 4h: phase 4f's model through the CLI on ``device`` with
    ``--mesh-shape 2x1``; reads the window and the re-runs from the log,
    checks the mass balance against the frames' rain minus the loss and
    the depth at ``duration`` against ``ref_root``'s (phase 4f run A)
    within WINDOW_DEPTH_BARS.  Returns what it measured."""
    from hipims_tpu_torch.io.raster import read_raster
    from hipims_tpu_torch.models import get_scheme
    from hipims_tpu_torch.runtime.output import NODATA
    from hipims_tpu_torch.utils import time_label

    root = Path(root)
    xml = write_radar_model(root, rows, cols, duration, outfreq,
                            interval=interval, rain_cell=rain_cell)
    res = _run_cli(xml, device, "--mesh-shape", "2x1")
    window = int(re.search(r"Window:\s+(\d+) step", res["log"]).group(1))
    reruns = int(re.search(r"Windows re-run:\s+(\d+)",
                           res["log"]).group(1))
    expected = radar_volume(root, rows, cols, duration, interval,
                            get_scheme("godunov").radius)
    rel = (res["volumes"][-1] - expected) / expected
    if abs(rel) > mass_tol:
        raise RuntimeError(f"mesh radar mass balance off by {rel:+.4%}")
    t = time_label(duration)
    a, b = (read_raster(Path(r) / "output" / f"depth_{t}.tif").data
            for r in (root, ref_root))
    both = (a != NODATA) & (b != NODATA)
    diff = np.abs(a - b)[both]
    mean, top = float(diff.mean()), float(diff.max())
    if mean > WINDOW_DEPTH_BARS[0] or top > WINDOW_DEPTH_BARS[1]:
        raise RuntimeError(f"mesh radar depth differs from the one-device "
                           f"run's by mean {mean:.3e}, max {top:.3e} m")
    return dict(res, window=window, reruns=reruns, rel=rel,
                expected=expected, mean_diff=mean, max_diff=top)


# Phase 5f's slices: (label, the XML's scheme name, muscl_variant,
# seconds simulated).  The MUSCL slices stop at 60 s, where the early dt
# limit ends: past it the frozen-speed windows fall into a cycle on this
# model's rain films in both packages (a window at the stale speed
# diverges, its re-run at the diverged speed takes a dt of microseconds
# and re-seeds the stale speed), and the JAX package's mesh run took 29664
# steps without passing t = 60 s (ROADMAP.md section 3).
MESH_SLICES = (("godunov", "godunov", None, 120.0),
               ("MUSCL split12", "musclhancock", "split12", 60.0),
               ("MUSCL recompute", "musclhancock", "recompute", 60.0),
               ("inertial", "inertial", None, 120.0))


def phase_mesh_slices(torch, root):
    """Phase 5f: the 128x128 float64 slices of MESH_SLICES as a 2x2
    mesh (four blocks on the card; four on the CPU), in forecast windows
    of 4 steps with the frozen-speed dt, through load_config ->
    Simulation.run; the final fields within the f32c bounds and the same
    step counts.  Returns per slice (steps, window, re-runs, max|diff|)
    and the kernels' launches in the card's runs."""
    from hipims_tpu_torch.io.xml_config import load_config
    from hipims_tpu_torch.parallel import make_mesh

    out, launches = {}, {n: 0 for n in kernel_wrappers()}
    for label, scheme, variant, duration in MESH_SLICES:
        xml = write_glasgow_model(Path(root) / label.replace(" ", "_"), 128,
                                  128, duration, duration,
                                  precision="double-strict", scheme=scheme)
        sims = {}
        for dev in ("cuda", "cpu"):
            model = load_config(xml)
            model.output_targets = []          # fields compared in memory
            cfg = model.config
            cfg.sync_method, cfg.forecast_window = "forecast", 4
            cfg.forecast_dt, cfg.muscl_variant = "window", variant
            mesh = make_mesh(4, shape=(2, 2), devices=None if dev == "cuda"
                             else [torch.device("cpu")] * 4)
            sim = model.simulation(mesh=mesh)
            _reset_launches()
            sim.run()
            if dev == "cuda":
                for n, c in _read_launches().items():
                    launches[n] += c
            sims[dev] = sim
        g, c = sims["cuda"], sims["cpu"]
        if (g.total_steps, g.window_reruns) != (c.total_steps,
                                                c.window_reruns):
            raise RuntimeError(f"5f {label}: steps / re-runs differ: card "
                               f"{g.total_steps} / {g.window_reruns}, cpu "
                               f"{c.total_steps} / {c.window_reruns}")
        rtol, atol = TOL["f32c"]
        worst = 0.0
        for name, a, b in zip(("z", "zmax", "qx", "qy"), g.state, c.state):
            excess, diff = _excess(a.cpu(), b, rtol, atol)
            worst = max(worst, diff)
            if excess > 0.0:
                raise RuntimeError(f"5f {label}: card and CPU mesh runs "
                                   f"differ in {name}: max|diff|={diff:.3e}")
        out[label] = (g.total_steps, g.window, g.window_reruns, worst)
    return out, launches


def run_mesh_stream_path(root, device, rows, cols, duration, outfreq,
                         interval=60.0, rain_cell=50.0):
    """Phase 5g: phase 4f's model as a 2x2 mesh (forecast windows) on
    ``device`` ("cuda" or "cpu") through load_config -> Simulation.run
    with io_mode "stream" and its default batches, writing a checkpoint
    at every event.  Each event is also written from a gathered snapshot
    of the same state, the blocks assembled, by the model's writers into
    its other output directory: the streamed rasters and gauge CSV must
    be the gathered ones' bytes, and at every event the streamed
    checkpoint's members the gathered checkpoint's, or the error names
    the members that differ.  Returns what it measured."""
    import torch

    from hipims_tpu_torch.io.xml_config import load_config
    from hipims_tpu_torch.parallel import make_mesh
    from hipims_tpu_torch.runtime import checkpoint, simulation

    root = Path(root)
    xml = write_radar_model(root, rows, cols, duration, outfreq,
                            interval=interval, rain_cell=rain_cell)
    gather_writer = load_config(xml).output_writer()
    model = load_config(root / "model_b.xml")
    model.config.io_mode = "stream"
    sim = model.simulation(mesh=make_mesh(
        4, shape=(2, 2), devices=None if device == "cuda"
        else [torch.device("cpu")] * 4))
    sim.checkpoint_path = root / "stream.npz"
    emit_streamed = sim.emit_output

    def emit_both(t):
        emit_streamed(t)
        snap = simulation._OutputSnapshot(sim)
        checkpoint.save_checkpoint(root / "gather.npz", sim, snapshot=snap)
        gather_writer(snap, t)
        with np.load(root / "gather.npz") as g, \
                np.load(root / "stream.npz") as s:
            differ = {k: _max_diff(g[k], s[k]) for k in g.files
                      if k not in s.files or not np.array_equal(g[k], s[k])}
            if g.files != s.files or differ:
                raise RuntimeError(
                    f"5g: at t={t} the streamed mesh checkpoint's members "
                    f"{s.files} differ from the gathered one's {g.files}: "
                    f"max|diff| {differ}")

    sim.emit_output = emit_both
    _reset_launches()
    sim.run()
    res = dict(steps=sim.total_steps, idle=sim.total_skipped,
               reruns=sim.window_reruns, window=sim.window,
               launches=_read_launches())
    g, s = ({p.name: p.read_bytes() for p in (root / d).iterdir()}
            for d in ("output", "output_b"))
    if len(g) != int(round(duration / outfreq)) + 1 or g != s:
        raise RuntimeError(f"5g: streamed mesh outputs {sorted(s)} are not "
                           f"the gathered snapshots' bytes {sorted(g)}")
    return res


def phase_oracle(torch, device, rows=256, cols=256):
    """Phase 3e: K1 and K2 + K3 (split12) in float64 on the card against
    the port's numpy oracles on the random domain; returns the max
    |difference| of each, held to TOL["f64"]."""
    from hipims_tpu_torch.ops.godunov import SchemeParams
    from hipims_tpu_torch.ops.kernels import muscl_split, stencil
    from hipims_tpu_torch.ops.oracle import godunov_step_oracle
    from hipims_tpu_torch.ops.oracle_muscl import muscl_step_oracle
    from hipims_tpu_torch.state import DomainStatic, FlowState

    arrs = random_domain(3, rows, cols)
    t = [torch.as_tensor(a, device=device) for a in arrs]
    state, static = FlowState(*t[:4]), DomainStatic(*t[4:])
    dt = torch.tensor(0.05, dtype=torch.float64, device=device)
    params = SchemeParams(2.0, 2.0)
    out = {}
    for name, got, oracle in (
            ("K1", stencil.stencil_step("godunov", state, static, dt,
                                        params)[0], godunov_step_oracle),
            ("K2 + K3", muscl_split.muscl_step_split(
                state, static, dt, params, "split12")[0],
             muscl_step_oracle)):
        want = oracle(*arrs, 0.05, 2.0, 2.0)
        excess, diff = _excess(torch.stack(list(got)).cpu(),
                               torch.as_tensor(np.stack(want)),
                               *TOL["f64"])
        if excess > 0.0:
            raise RuntimeError(f"3e: {name} differs from the numpy oracle "
                               f"by {diff:.3e}")
        out[name] = diff
    return out


def rank_worker(argv):
    """One rank of phases 4j, 4k, 5h and 5i: ``chip_smoke.py --rank-worker
    RANK RANKS ADDR:PORT CLI-ARGS...`` runs the CLI in this process with
    ``--distributed ADDR:PORT,RANKS,RANK`` and prints its output, then one
    line ``RANK_RESULT {json}``: this rank's kernel launches during the
    CLI's run, its final carry (t, steps, idle steps), its windows re-run,
    the CLI's wall seconds, the process groups during the run
    (``distributed.groups``) and the host reads inside its batches
    (``count_host_reads``).  Returns the CLI's status."""
    from hipims_tpu_torch.cli import main as cli_main
    from hipims_tpu_torch.parallel import distributed
    from hipims_tpu_torch.runtime import simulation

    rank, ranks, coord, *args = argv
    sims, groups = [], {}
    run = simulation.Simulation.run

    def recorded_run(self, progress=None):
        sims.append(self)
        groups.update(distributed.groups())
        return run(self, progress)

    simulation.Simulation.run = recorded_run
    _reset_launches()
    t0 = time.perf_counter()
    with count_host_reads() as reads:
        rc = cli_main([*args, "--distributed", f"{coord},{ranks},{rank}"])
    wall = time.perf_counter() - t0
    res = dict(rank=int(rank), rc=rc, wall_s=wall,
               launches=_read_launches(), groups=groups,
               reads=reads["reads"], batches=reads["batches"])
    if sims:
        sim = sims[-1]
        res.update(t=sim.t, steps=sim.total_steps, idle=sim.total_skipped,
                   reruns=sim.window_reruns, window=sim.window)
    print("RANK_RESULT " + json.dumps(res), flush=True)
    return rc


@contextlib.contextmanager
def first_card_only(torch):
    """While the block runs, ``torch.cuda.device_count()`` answers at most
    1, so ``make_mesh`` deals every block to the first card: a phase that
    measures a mesh on one card (4g) keeps its meaning where several are
    visible."""
    count = torch.cuda.device_count
    torch.cuda.device_count = lambda: min(count(), 1)
    try:
        yield
    finally:
        torch.cuda.device_count = count


def _first_card():
    """The first visible CUDA card as CUDA_VISIBLE_DEVICES names it."""
    return os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]


def run_ranks(label, args, timeout, ranks=2, share_card=True):
    """Run the CLI with ``args`` as the ``ranks`` ranks of one cluster, each
    a process of this script (``rank_worker``), the rendezvous on a free
    port of this host.  With ``share_card`` every rank sees only the first
    card, so they share it (and the strips go through the host); without,
    rank r takes card r.  Raises if a rank fails or outlives ``timeout``
    seconds (every rank is killed then).  Returns [(result, output)] by
    rank."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if share_card:
        env["CUDA_VISIBLE_DEVICES"] = _first_card()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--rank-worker",
         str(r), str(ranks), f"127.0.0.1:{port}", *map(str, args)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT) for r in range(ranks)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    res = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines()
                 if ln.startswith("RANK_RESULT ")]
        if p.returncode != 0 or not lines:
            raise RuntimeError(f"{label}: rank {r} exited {p.returncode}:\n"
                               f"{out[-4000:]}")
        res.append((json.loads(lines[-1][len("RANK_RESULT "):]), out))
    return res


def _check_main_path_run(label, root, rows, cols, duration, ref_root,
                         log, mass_tol):
    """The checks a lock-step mesh run of the phase-4 model shares (4j,
    4k): its depth and maxdepth rasters at ``duration``, the only files,
    are ``ref_root``'s (phase 4) bytes; its checkpoint ``run.npz`` is
    whole (one file, t = duration, the full grid); the mass balance in
    ``log`` holds.  Returns (mass balance, run seconds, checkpoint
    members, checkpoint MiB)."""
    from hipims_tpu_torch.models import get_scheme

    root = Path(root)
    files = sorted(p.name for p in (root / "output").iterdir())
    want = [f"depth_{duration:g}.tif", f"maxdepth_{duration:g}.tif"]
    if files != want:
        raise RuntimeError(f"{label}: output files {files}")
    for name in files:
        a = (root / "output" / name).read_bytes()
        if a != (Path(ref_root) / "output" / name).read_bytes():
            raise RuntimeError(f"{label}: {name} is not phase 4's bytes")
    ck = root / "run.npz"
    if sorted(p.name for p in root.glob("run.npz*")) != ["run.npz"]:
        raise RuntimeError(f"{label}: checkpoint files "
                           f"{sorted(root.glob('run.npz*'))}")
    with np.load(ck) as data:
        members = {k: data[k] for k in data.files}
    if float(members["t"]) != duration or members["z"].shape != (rows, cols):
        raise RuntimeError(f"{label}: checkpoint t={members['t']}, z "
                           f"{members['z'].shape}")
    vols = [float(v) for v in re.findall(r"volume=([0-9.eE+-]+) m3", log)]
    run_s = float(re.search(r"Simulated:.* in ([0-9.]+) s wall",
                            log).group(1))
    expected = _forced_volume(rows, cols, get_scheme("godunov").radius,
                              duration)
    rel = (vols[-1] - expected) / expected
    if abs(rel) > mass_tol:
        raise RuntimeError(f"{label}: mass balance off by {rel:+.4%}")
    return rel, run_s, sorted(members), ck.stat().st_size / 2 ** 20


def run_ranks_main_path(root, rows, cols, duration, ref_root,
                        device="gpu", mass_tol=MASS_BALANCE_REL,
                        label="4j", shape="2x1", ranks=2, share_card=True,
                        queue_size=None):
    """Phases 4j and 4k (b): the phase-4 model, lock-step, through the CLI
    on ``ranks`` ranks with ``--mesh-shape shape`` and ``--checkpoint`` on
    ``device`` ("gpu" or "cpu"), sharing the first card (4j) or one card a
    rank (4k); checks the run (``_check_main_path_run``) and the ranks'
    agreement.  Returns what it measured, with each rank's result under
    "ranks"."""
    root = Path(root)
    xml = write_glasgow_model(root, rows, cols, duration, duration,
                              sync="timestep", queue_size=queue_size)
    t0 = time.perf_counter()
    out = run_ranks(f"phase {label}", [
        "-c", xml, "-n", "--mass-balance", "--platform", device,
        "--mesh-shape", shape, "--checkpoint", root / "run.npz"],
        600, ranks=ranks, share_card=share_card)
    wall = time.perf_counter() - t0
    res = [r for r, _ in out]
    r0, log = out[0]
    for r in res[1:]:
        if (r["t"], r["steps"], r["idle"]) != (r0["t"], r0["steps"],
                                              r0["idle"]):
            raise RuntimeError(f"{label}: the ranks disagree: {r0} / {r}")
    rel, run_s, members, ck_mb = _check_main_path_run(
        label, root, rows, cols, duration, ref_root, log, mass_tol)
    return dict(steps=r0["steps"], idle=r0["idle"], rel=rel, run_s=run_s,
                wall_s=wall, rank_walls=[r["wall_s"] for r in res],
                ranks=res, groups=r0["groups"],
                reads=sum(r["reads"] for r in res),
                launches={n: sum(r["launches"][n] for r in res)
                          for n in r0["launches"]},
                members=members, checkpoint_mb=ck_mb)


def not_run(label, cards):
    """The line a phase that needs several cards (4k, 5i) prints in their
    place where fewer than two are visible, or None where it runs."""
    if cards >= 2:
        return None
    return f"phase {label}: not run: needs 2+ CUDA devices, {cards} visible"


def run_cards_main_path(root, rows, cols, duration, ref_root, cards,
                        device="gpu", mass_tol=MASS_BALANCE_REL,
                        queue_size=64):
    """Phase 4k: the phase-4 model, lock-step, as a 2x2 mesh over
    ``cards`` cards (2 or more), with ``--checkpoint``: (a) in one
    process, the CLI here, its four blocks dealt round-robin over the
    visible cards; (b) on one rank per card under ``--distributed``
    (four ranks, or two with fewer than four cards), whose device group
    must be NCCL on the card.  Both take fixed batches of ``queue_size``
    steps, so they end on the same idle steps.  Each run's rasters must be
    ``ref_root``'s (phase 4) bytes, its checkpoint whole, its mass balance
    within ``mass_tol``, its K1 launches 4 x (steps + idle) summed over
    the ranks, its steps and idle steps the other's, and its steps make
    no host read (``count_host_reads``).  Returns {"a": ..., "b": ...}."""
    root = Path(root)
    xml = write_glasgow_model(root / "a", rows, cols, duration, duration,
                              sync="timestep", queue_size=queue_size)
    with count_host_reads() as reads:
        a = _run_cli(xml, device, "--mesh-shape", "2x2", "--checkpoint",
                     str(root / "a" / "run.npz"))
    a["rel"], a["run_s"], a["members"], a["checkpoint_mb"] = \
        _check_main_path_run("4k (a)", root / "a", rows, cols, duration,
                             ref_root, a["log"], mass_tol)
    a.update(reads=reads["reads"], devices=sorted(set(re.findall(
        r"\s(cuda:\d+|cpu)\s+\(\d+,\d+\)\s", a["log"]))))
    b = run_ranks_main_path(root / "b", rows, cols, duration, ref_root,
                            device=device, mass_tol=mass_tol, label="4k (b)",
                            shape="2x2", ranks=4 if cards >= 4 else 2,
                            share_card=False, queue_size=queue_size)
    # On the CPU (a rehearsal) nothing launches, and the ranks have no
    # device group: their maxima go through the host.
    on_card = device == "gpu"
    want_group = "nccl" if on_card else None
    for label, r in (("(a)", a), ("(b)", b)):
        total = r["steps"] + r["idle"]
        if on_card:
            _expect_launches(f"phase 4k {label}", r["launches"],
                             {"godunov_fused": 4 * total})
        if r["reads"] and (on_card or r is a):
            raise RuntimeError(f"phase 4k {label}: {r['reads']} host reads "
                               f"in {total} lock-step steps")
    if device == "gpu" and len(a["devices"]) != min(cards, 4):
        raise RuntimeError(f"phase 4k (a): blocks on {a['devices']}")
    for r in b["ranks"]:
        if r["groups"].get("device") != want_group:
            raise RuntimeError(f"phase 4k (b): rank {r['rank']}'s groups "
                               f"{r['groups']}, expected the device group "
                               f"{want_group}")
    if (b["steps"], b["idle"]) != (a["steps"], a["idle"]):
        raise RuntimeError(f"phase 4k: (b) took {b['steps']} (+{b['idle']}) "
                           f"steps, (a) {a['steps']} (+{a['idle']})")
    return dict(a=a, b=b)


def run_ranks_stream_path(root, rows, cols, duration, outfreq,
                          interval=60.0, rain_cell=50.0, device="gpu",
                          label="5h", ranks=2, share_card=True):
    """Phases 5h and 5i: phase 5g's model (streamed, a 2x2 mesh in
    forecast windows, fixed batches of 8 windows) through the CLI on
    ``ranks`` ranks (sharing the first card, 5h, or one card a rank, 5i)
    into output/, and in one process into output_b/, each with a
    checkpoint; rasters, gauge CSV, checkpoint members and re-runs must
    be equal.  Returns what it measured."""
    root = Path(root)
    xml = write_radar_model(root, rows, cols, duration, outfreq,
                            interval=interval, rain_cell=rain_cell)
    for x in (xml, root / "model_b.xml"):
        x.write_text(x.read_text().replace(
            '<parameter name="courantNumber" value="0.5" />',
            '<parameter name="courantNumber" value="0.5" />\n'
            '          <parameter name="queueSize" value="8" />'))
    args = ["--platform", device, "--mesh-shape", "2x2", "--io-mode",
            "stream"]
    one = _run_cli(root / "model_b.xml", device, "--mesh-shape", "2x2",
                   "--io-mode", "stream", "--checkpoint",
                   str(root / "one.npz"))
    one_reruns = int(re.search(r"Windows re-run: (\d+)", one["log"])
                     .group(1))
    out = run_ranks(f"phase {label}", ["-c", xml, "-n", *args,
                                       "--checkpoint", root / "two.npz"],
                    300, ranks=ranks, share_card=share_card)
    res = [r for r, _ in out]
    if not all(r["reruns"] == one_reruns and r["steps"] == one["steps"]
               and r["idle"] == one["idle"] for r in res):
        raise RuntimeError(f"{label}: ranks {res} against one process: "
                           f"{one['steps']} steps, {one['idle']} idle, "
                           f"{one_reruns} re-runs")
    g, s = ({p.name: p.read_bytes() for p in (root / d).iterdir()}
            for d in ("output", "output_b"))
    if len(g) != int(round(duration / outfreq)) + 1 or g != s:
        raise RuntimeError(f"{label}: the ranks' outputs {sorted(g)} are not "
                           f"the one process's bytes {sorted(s)}")
    with np.load(root / "two.npz") as a, np.load(root / "one.npz") as b:
        differ = {k: _max_diff(a[k], b[k]) for k in b.files
                  if k not in a.files or not np.array_equal(a[k], b[k])}
        if a.files != b.files or differ:
            raise RuntimeError(f"{label}: checkpoint members differ: "
                               f"{differ}")
        members = a.files
    r0 = res[0]
    return dict(steps=r0["steps"], idle=r0["idle"], reruns=one_reruns,
                window=r0["window"], members=members, groups=r0["groups"],
                ranks=res, reads=sum(r["reads"] for r in res),
                batches=r0["batches"],
                launches={n: sum(r["launches"][n] for r in res)
                          for n in r0["launches"]},
                one_launches=one["launches"])


def _max_diff(a, b):
    """max|a - b| of two checkpoint members, or their values where they
    are not numbers."""
    if a.dtype.kind in "fiu" and b.dtype.kind in "fiu" and \
            a.shape == b.shape:
        return float(np.max(np.abs(a.astype(np.float64)
                                   - b.astype(np.float64)), initial=0.0))
    return f"{a!r} vs {b!r}"


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


# The least work of each kernel for ``bound_ms``.  Bytes: each input plane
# read once and each output plane written once (PERF.md section 3), the
# comp plane read and written in f32c where the kernel takes it.
# Operations: estimates, counted by hand from the CUDA sources (not from
# the SASS), one per add, subtract, multiply, divide, min/max, compare,
# sqrt, exp or log, rounded to tens: ``fixed`` for every cell (K1, K3,
# K5a-C and K5b at two face solves per cell, ~120 operations each, the
# work the step needs, whatever implements it; their first designs solved
# four), and ``second`` for each second-order predictor evaluation
# (predict_cell, one per second-order cell in K2, K5a-P and K5b; or a
# rebuilt slope vector in K5a-C: the cell's own sx and sy), of which a
# cell makes ``evals``; first-order cells skip that work.  Over
# PEAK_OPS_PER_S, which counts an FMA as two operations, the time is a
# loose lower bound: the kernels are built with --fmad=false, so each add
# and multiply issues alone, and a divide, sqrt, exp or log takes several
# instructions.  At these counts every kernel is bound by its bytes.
# name: (planes in, planes out, takes comp, fixed, second, evals)
KERNEL_COST = {
    "godunov_fused": (6, 4, True, 380, 0, 0),
    "inertial_fused": (6, 4, True, 160, 0, 0),
    "muscl_fused": (6, 4, True, 420, 180, 1),
    "muscl_predict": (5, 12, False, 10, 180, 1),
    "muscl_predict_base": (5, 4, False, 10, 180, 1),
    "muscl_correct": (18, 4, True, 420, 0, 0),
    "muscl_correct_recompute": (10, 4, True, 420, 30, 2),
}


def kernel_bound(name, mode, cells, second_share):
    """(bound_ms, bound_by): the larger of the bytes ``name`` must move
    over the HBM rate and its operations over the card's peak for
    ``mode``'s type, for ``cells`` cells of which ``second_share`` take
    the second-order predictor."""
    p_in, p_out, takes_comp, fixed, second, evals = KERNEL_COST[name]
    planes = p_in + p_out + (2 if takes_comp and mode == "f32c" else 0)
    nbytes = planes * (8 if mode == "f64" else 4) * cells
    ops = cells * (fixed + evals * second_share * second)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[mode] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def second_order_share(torch, device, arrs):
    """The share of cells that take the second-order MUSCL predictor on
    the random domain ``arrs`` (the rest fall back to first order)."""
    from hipims_tpu_torch.ops.muscl import interior_slopes

    z, zmax, qx, qy, zb, _ = (torch.as_tensor(a, device=device) for a in arrs)
    first_order = interior_slopes(z, zmax, qx, qy, zb, 1e-10)[0]
    return 1.0 - float(first_order.double().mean())


KERNEL_SOURCES = {
    # name: (source under hipims_tpu_torch/csrc, the TPU kernel it replaces)
    "godunov_fused": ("stencil.cu", "stencil.py:226"),
    "inertial_fused": ("stencil.cu", "stencil.py:226"),
    "muscl_fused": ("muscl_split.cu", "stencil.py:226"),
    "muscl_predict": ("muscl_split.cu", "muscl_split.py:68"),
    "muscl_correct": ("muscl_split.cu", "muscl_split.py:112"),
    "muscl_predict_base": ("muscl_split.cu", "muscl_split.py:202"),
    "muscl_correct_recompute": ("muscl_split.cu", "muscl_split.py:237"),
}


def kernels_record(times, err, launches, cells, share, mesh_launches,
                   k5b_mesh=None):
    """The kernels line's entries: for each kernel its f32c kernel and
    plain times at ``cells`` cells (``times`` by (name, rows, cols,
    mode)), its largest |diff| against the plain version, its launches on
    its main path and in the mesh phases (``mesh_launches``), and its
    bound computed for these inputs.  ``k5b_mesh`` (phase 3d: ms,
    plain_ms, cells, err, launches) adds K5b's mesh mode as an entry of
    its own, "muscl_fused_mesh": its f32c times over the four blocks of a
    2x2 split, its bound for their cells and its launches in 3d (it runs
    at op level only, as in the JAX package)."""
    record = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        (k_ms, p_ms), = [t for (n, r, c, m), t in times.items()
                         if n == name and r * c == cells and m == "f32c"]
        bound, bound_by = kernel_bound(name, "f32c", cells, share)
        record.append(dict(
            name=name, route="cuda",
            source=f"hipims_tpu_torch/csrc/{source}",
            replaces=f"hipims_tpu/ops/pallas/{replaces}",
            launches=launches[name], max_abs_err=err[name], ms=k_ms,
            plain_ms=p_ms, bound_ms=bound, bound_by=bound_by,
            library_ms=None, mesh_launches=mesh_launches[name]))
    if k5b_mesh is not None:
        bound, bound_by = kernel_bound("muscl_fused", "f32c",
                                       k5b_mesh["cells"], share)
        source, replaces = KERNEL_SOURCES["muscl_fused"]
        record.append(dict(
            name="muscl_fused_mesh", route="cuda",
            source=f"hipims_tpu_torch/csrc/{source}",
            replaces=f"hipims_tpu/ops/pallas/{replaces}",
            launches=k5b_mesh["launches"], max_abs_err=k5b_mesh["err"],
            ms=k5b_mesh["ms"], plain_ms=k5b_mesh["plain_ms"],
            bound_ms=bound, bound_by=bound_by, library_ms=None,
            mesh_launches=k5b_mesh["launches"]))
    return record


def main() -> int:
    import torch

    if len(sys.argv) > 1 and sys.argv[1] == "--rank-worker":
        # One rank of phases 4j and 5h; its CLI arguments name the
        # platform (the CPU tests rehearse it there).
        sys.path.insert(0, str(ROOT))
        return rank_worker(sys.argv[2:])
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
    t_start = time.perf_counter()

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
    print(f"phase 2: built K1 and K4 (csrc/stencil.cu) and the MUSCL kernels "
          f"K2, K3, K5a-P, K5a-C and K5b (csrc/muscl_split.cu) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # Phase 3: K1 against the plain version; 3b: the split MUSCL kernels;
    # 3c: K4 and K5b (K5b's launches are the ones counted here: no
    # Simulation path takes it, as in the JAX package).
    err, times, _ = phase_fused_vs_plain(torch, device, ["godunov"], "3")
    muscl_err, muscl_times = phase_muscl_vs_plain(torch, device)
    _reset_launches()
    err_c, times_c, split_diff = phase_fused_vs_plain(
        torch, device, ["inertial", "muscl-hancock"], "3c")
    k5b_launches = _read_launches()["muscl_fused"]
    err.update(muscl_err)
    err.update(err_c)
    times.update(times_c)
    times.update(muscl_times)
    # Phase 3d: K1, K4, K3, K5a-C and K5b in mesh mode (its launches are
    # not a main path's; K5b's are its mesh mode's, op level only).
    _reset_launches()
    mesh_err, mesh_times, (k5b_plain_ms, block_cells) = \
        phase_mesh_vs_plain(torch, device, times)
    k5b_mesh = dict(ms=mesh_times[("muscl_fused", "f32c")][1],
                    plain_ms=k5b_plain_ms, cells=block_cells,
                    err=mesh_err["muscl_fused"],
                    launches=_read_launches()["muscl_fused"])
    print(f"phase 3d: K5b in mesh mode bit-equal to its plain version in "
          f"f64, f32 and f32c; f32c over the four 2x2 blocks "
          f"{k5b_mesh['ms']:.4f} ms (plain {k5b_plain_ms:.4f}), whole grid "
          f"{mesh_times[('muscl_fused', 'f32c')][0]:.4f}; "
          f"{k5b_mesh['launches']} launches", flush=True)
    for name, e in mesh_err.items():
        err[name] = max(err[name], e)
    # Phase 3e: K1 and K2 + K3 against the numpy oracles (comparisons, not
    # a main path's launches).
    t0 = time.perf_counter()
    oracle_diff = phase_oracle(torch, device)
    print("phase 3e: float64 256x256 against the port's numpy oracles: "
          + ", ".join(f"{k} max|diff| {v:.3e}" for k, v in
                      oracle_diff.items())
          + f" (bar {TOL['f64'][1]:g}); {time.perf_counter() - t0:.1f} s",
          flush=True)

    rows, cols = CASES[-1][:2]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # Phase 4: the Godunov main path at 9.04 M cells.
        res = run_main_path(Path(tmp) / "main", "gpu", rows, cols,
                            600.0, 300.0)
        _expect_launches("phase 4", res["launches"], {
            "godunov_fused": res["steps"] + res["idle"]})
        print(_main_path_line("phase 4: main path", rows, cols, 600.0, res,
                              smi), flush=True)

        # Phase 4b: the MUSCL main path (default variant split12).
        res_b = run_main_path(Path(tmp) / "muscl", "gpu", rows, cols,
                              150.0, 150.0, scheme="musclhancock")
        total = res_b["steps"] + res_b["idle"]
        _expect_launches("phase 4b", res_b["launches"], {
            "muscl_predict": total, "muscl_correct": total})
        print(_main_path_line("phase 4b: MUSCL main path", rows, cols, 150.0,
                              res_b, smi), flush=True)

        # Phase 4c: the recompute variant through the embedding API.
        res_c = run_api_path(Path(tmp) / "recompute", "cuda", rows, cols,
                             150.0, "recompute")
        total = res_c["steps"] + res_c["idle"]
        _expect_launches("phase 4c", res_c["launches"], {
            "muscl_predict_base": total, "muscl_correct_recompute": total})
        print(f"phase 4c: MUSCL recompute variant through simulation_load"
              f"(xml).launch(blocking=False), {rows}x{cols} f32c, 150 s "
              f"simulated: "
              f"{res_c['steps']} steps (+{res_c['idle']} idle) in "
              f"{res_c['wall_s']:.2f} s; mass balance {res_c['rel']:+.4%}; "
              f"launches {total} each", flush=True)

        # Phase 4d: this slice's main path, the partial-inertial scheme.
        res_d = run_main_path(Path(tmp) / "inertial", "gpu", rows, cols,
                              300.0, 300.0, scheme="inertial")
        _expect_launches("phase 4d", res_d["launches"], {
            "inertial_fused": res_d["steps"] + res_d["idle"]})
        print(_main_path_line("phase 4d: inertial main path", rows, cols,
                              300.0, res_d, smi), flush=True)

        # Phase 4e: the breach, a per-cell boundary, on the Godunov kernel.
        res_e = run_breach_path(Path(tmp) / "breach", "gpu", rows, cols,
                                600.0, 300.0)
        _expect_launches("phase 4e", res_e["launches"], {
            "godunov_fused": res_e["steps"] + res_e["idle"]})
        setup_e = res_e["wall_s"] - res_e["run_s"]
        print(f"phase 4e: Thamesmead-class breach {rows}x{cols} f32c, 600 s "
              f"simulated: {res_e['steps']} steps (+{res_e['idle']} idle), "
              f"wall {res_e['wall_s']:.2f} s (set-up {setup_e:.1f} s, run "
              f"with outputs {res_e['run_s']:.1f} s) on {smi}; volumes "
              + ", ".join(f"{v:.1f}" for v in res_e["volumes"])
              + f" m3; the last against {BREACH_M3_S:g} m3/s x "
              f"600 s = {BREACH_M3_S * 600.0:.1f} m3 (ratio "
              f"{res_e['ratio']:.4f}); launches: godunov_fused "
              f"{res_e['launches']['godunov_fused']}", flush=True)

        # Phase 4f: a real model directory (two HFA row bands, radar rain,
        # gauges), run A with --checkpoint, run B resumed half way.
        res_f = run_radar_path(Path(tmp) / "radar", "gpu", rows, cols,
                               300.0, 150.0)
        for run in ("a", "b"):
            r = res_f[run]
            _expect_launches(f"phase 4f run {run.upper()}", r["launches"], {
                "godunov_fused": r["steps"] + r["idle"]})
            events = format_events(res_f[f"events_{run}"])
            print(f"phase 4f: radar model run {run.upper()} {rows}x{cols} "
                  f"f32c, two HFA row bands, "
                  + ("0-300 s with --checkpoint" if run == "a" else
                     "--resume 150-300 s")
                  + f": {r['steps']} steps (+{r['idle']} idle), wall "
                  f"{r['wall_s']:.2f} s (set-up "
                  f"{r['wall_s'] - r['run_s']:.1f} s, run with outputs "
                  f"{r['run_s']:.1f} s) on {smi}; output events (s): "
                  f"{events}; launches: godunov_fused "
                  f"{r['launches']['godunov_fused']}", flush=True)
        print(f"phase 4f: resumed raster and gauge row bit-equal to run A's; "
              f"mass balance {res_f['rel']:+.4%} of the frames' rain - loss "
              f"({res_f['expected']:.1f} m3); checkpoint "
              f"{res_f['checkpoint_mb']:.1f} MiB; the stitched .img DEM "
              f"equals the loader's bed; last gauge row "
              f"{res_f['gauges'][-1]}", flush=True)

        # Phase 4g: phases 4 and 4b as a 2x2 mesh of blocks on the card,
        # lock-step, their rasters bit-equal to the one-device runs'.
        mesh_launches = {n: 0 for n in kernel_wrappers()}
        with first_card_only(torch):
            res_g = run_main_path(Path(tmp) / "mesh", "gpu", rows, cols,
                                  300.0, 300.0, sync="timestep",
                                  extra=("--mesh-shape", "2x2"))
        _expect_launches("phase 4g", res_g["launches"], {
            "godunov_fused": 4 * (res_g["steps"] + res_g["idle"])})
        _same_rasters("phase 4g", Path(tmp) / "mesh", Path(tmp) / "main",
                      300.0)
        with first_card_only(torch):
            res_gb = run_main_path(Path(tmp) / "mesh_muscl", "gpu", rows,
                                   cols, 150.0, 150.0, scheme="musclhancock",
                                   sync="timestep",
                                   extra=("--mesh-shape", "2x2"))
        total = 4 * (res_gb["steps"] + res_gb["idle"])
        _expect_launches("phase 4g MUSCL", res_gb["launches"], {
            "muscl_predict": total, "muscl_correct": total})
        _same_rasters("phase 4g MUSCL", Path(tmp) / "mesh_muscl",
                      Path(tmp) / "muscl", 150.0)
        for label, r, one, dur, one_dur in (
                ("Godunov", res_g, res, 300.0, 600.0),
                ("MUSCL", res_gb, res_b, 150.0, 150.0)):
            for n, c in r["launches"].items():
                mesh_launches[n] += c
            print(_main_path_line(f"phase 4g: {label} as a 2x2 mesh "
                                  "(lock-step)", rows, cols, dur, r, smi)
                  + f"; rasters bit-equal to the one-device run's; wall per "
                  f"simulated s {r['wall_s'] / dur:.4f} (one device "
                  f"{one['wall_s'] / one_dur:.4f}), run per step "
                  f"{r['run_s'] / (r['steps'] + r['idle']) * 1e3:.3f} ms "
                  f"(one device {one['run_s'] / (one['steps'] + one['idle']) * 1e3:.3f})",
                  flush=True)

        # Phase 4h: phase 4f's model as two row blocks in forecast windows.
        res_h = run_mesh_radar_path(Path(tmp) / "mesh_radar", "gpu", rows,
                                    cols, 300.0, 150.0,
                                    ref_root=Path(tmp) / "radar")
        _expect_launches("phase 4h", res_h["launches"], {
            "godunov_fused": 2 * (res_h["steps"] + res_h["idle"]
                                  + res_h["window"] * res_h["reruns"])})
        for n, c in res_h["launches"].items():
            mesh_launches[n] += c
        print(f"phase 4h: radar model as a 2x1 mesh {rows}x{cols} f32c, "
              f"300 s: window {res_h['window']} steps, {res_h['reruns']} "
              f"windows re-run, {res_h['steps']} steps "
              f"(+{res_h['idle']} idle), wall {res_h['wall_s']:.2f} s "
              f"(set-up {res_h['wall_s'] - res_h['run_s']:.1f} s, run with "
              f"outputs {res_h['run_s']:.1f} s) on {smi}; mass balance "
              f"{res_h['rel']:+.4%} of the frames' rain - loss; |depth - "
              f"4f run A's| mean {res_h['mean_diff']:.4e} m, max "
              f"{res_h['max_diff']:.4e} m (bars {WINDOW_DEPTH_BARS[0]:g}, "
              f"{WINDOW_DEPTH_BARS[1]:g}); launches: godunov_fused "
              f"{res_h['launches']['godunov_fused']}", flush=True)

        # Phase 4i: phase 4f's model at 16.78 M cells with the default
        # io_mode ("auto" streams from 16 M cells), and run G gathered.
        srows, scols = STREAM_GRID
        t_4i = time.perf_counter()
        res_i = run_radar_path(Path(tmp) / "stream", "gpu", srows, scols,
                               120.0, 60.0, gather_run=True)
        from hipims_tpu_torch.runtime import SimulationConfig
        budget = SimulationConfig().io_chunk_mb << 20
        for run in ("a", "b", "g"):
            r = res_i[run]
            _expect_launches(f"phase 4i run {run.upper()}", r["launches"], {
                "godunov_fused": r["steps"] + r["idle"]})
            events = res_i[f"events_{run}"]
            streamed = all("snapshot" in e and "copy" not in e
                           for e in events)
            if streamed != (run != "g"):
                raise RuntimeError(f"phase 4i run {run.upper()}: streamed "
                                   f"events expected: {events}")
            if any(e.get("chunk_set_bytes", 0) > budget for e in events):
                raise RuntimeError(f"phase 4i: a chunk set over {budget} "
                                   f"bytes: {events}")
            print(f"phase 4i: radar model run {run.upper()} {srows}x{scols} "
                  f"f32c, " + {"a": "0-120 s streamed with --checkpoint",
                               "b": "--resume 60-120 s streamed",
                               "g": "0-120 s --io-mode gather"}[run]
                  + f": {r['steps']} steps (+{r['idle']} idle), wall "
                  f"{r['wall_s']:.2f} s (set-up "
                  f"{r['wall_s'] - r['run_s']:.1f} s, run with outputs "
                  f"{r['run_s']:.1f} s) on {smi}; output events (s): "
                  f"{format_events(events)}; launches: godunov_fused "
                  f"{r['launches']['godunov_fused']}", flush=True)
        print(f"phase 4i: streamed rasters and gauge CSV byte-equal to the "
              f"gathered run's; resumed raster and gauge row bit-equal to "
              f"run A's; mass balance {res_i['rel']:+.4%} of the frames' "
              f"rain - loss ({res_i['expected']:.1f} m3); streamed "
              f"checkpoint {res_i['checkpoint_mb']:.1f} MiB (budget per "
              f"chunk set {budget / 2 ** 20:g} MiB); phase 4i wall "
              f"{time.perf_counter() - t_4i:.1f} s", flush=True)

        # Phase 4j: phase 4's model on two ranks, one 2x1 block each.
        res_j = run_ranks_main_path(Path(tmp) / "ranks", rows, cols, 300.0,
                                    ref_root=Path(tmp) / "main")
        for r in res_j["ranks"]:
            _expect_launches(f"phase 4j rank {r['rank']}", r["launches"], {
                "godunov_fused": res_j["steps"] + res_j["idle"]})
        for n, c in res_j["launches"].items():
            mesh_launches[n] += c
        per_step = {label: r["run_s"] / (r["steps"] + r["idle"]) * 1e3
                    for label, r in (("4j", res_j), ("4", res),
                                     ("4g", res_g))}
        print(f"phase 4j: main path on two ranks (gloo, --mesh-shape 2x1, "
              f"one card) {rows}x{cols} f32c, 300 s simulated: "
              f"{res_j['steps']} steps (+{res_j['idle']} idle) on both "
              f"ranks, rasters at 300 s byte-equal to phase 4's, one "
              f"checkpoint ({res_j['checkpoint_mb']:.1f} MiB, t=300, "
              f"{len(res_j['members'])} members); mass balance "
              f"{res_j['rel']:+.4%}; run with outputs {res_j['run_s']:.1f} "
              f"s, ranks' CLI walls "
              + " / ".join(f"{w:.1f}" for w in res_j["rank_walls"])
              + f" s, phase wall {res_j['wall_s']:.1f} s; run per step "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in per_step.items())
              + f"; launches: godunov_fused "
              f"{res_j['launches']['godunov_fused']}; host reads in the "
              f"steps {res_j['reads']} (both ranks, "
              f"{res_j['reads'] / (res_j['steps'] + res_j['idle']):.3f} per "
              f"step); on {smi}", flush=True)

        # Phase 4k: phase 4's model as a 2x2 mesh over the cards, in one
        # process and on one rank per card (the NCCL device group).
        cards = torch.cuda.device_count()
        if not_run("4k", cards):
            print(not_run("4k", cards), flush=True)
        else:
            res_k = run_cards_main_path(Path(tmp) / "cards", rows, cols,
                                        300.0, Path(tmp) / "main", cards)
            for r in (res_k["a"], res_k["b"]):
                for n, c in r["launches"].items():
                    mesh_launches[n] += c
            per_step.update({
                label: r["run_s"] / (r["steps"] + r["idle"]) * 1e3
                for label, r in (("4k (a)", res_k["a"]),
                                 ("4k (b)", res_k["b"]))})
            a, b = res_k["a"], res_k["b"]
            print(f"phase 4k: main path as a 2x2 mesh over {cards} cards "
                  f"{rows}x{cols} f32c, 300 s simulated, lock-step: (a) one "
                  f"process, blocks on {', '.join(a['devices'])}; (b) "
                  f"{len(b['ranks'])} ranks, one card each, device group "
                  f"{b['groups']['device']}; both {a['steps']} steps "
                  f"(+{a['idle']} idle), rasters at 300 s byte-equal to "
                  f"phase 4's, checkpoints whole ({len(b['members'])} "
                  f"members), mass balance (a) {a['rel']:+.4%} (b) "
                  f"{b['rel']:+.4%}; host reads in the steps: (a) "
                  f"{a['reads']}, (b) {b['reads']} over "
                  f"{b['steps'] + b['idle']} steps; K1 launches (a) "
                  f"{a['launches']['godunov_fused']} (b) "
                  f"{b['launches']['godunov_fused']}; run with outputs (a) "
                  f"{a['run_s']:.1f} s (b) {b['run_s']:.1f} s; run per "
                  "step "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in per_step.items())
                  + f"; on {smi}", flush=True)

        # Phase 5: the slices whole, card against CPU at 128x128, 120 s,
        # float64: 5 Godunov, 5b MUSCL, 5c inertial, 5d the breach.
        slices = [(label, scheme, write_glasgow_model(
                       Path(tmp) / f"slice_{scheme}", 128, 128, 120.0,
                       120.0, precision="double-strict", scheme=scheme))
                  for label, scheme in (("5", "godunov"),
                                        ("5b", "musclhancock"),
                                        ("5c", "inertial"))]
        slices.append(("5d", "breach", write_thamesmead_model(
            Path(tmp) / "slice_breach", 128, 128, 120.0, 120.0,
            precision="double-strict")))
        for label, what, xml in slices:
            steps5, err5 = phase_slice_gpu_vs_cpu(torch, xml)
            print(f"phase {label}: 128x128 120 s f64 {what} slice, card vs "
                  f"CPU: {steps5} steps, fields agree (max|diff| "
                  f"{err5:.3e})", flush=True)
        steps5, err5 = phase_radar_slice(torch, Path(tmp) / "slice_radar")
        print(f"phase 5e: 128x128 120 s f64 radar slice, card vs CPU: "
              f"{steps5} steps, fields and gauge rows agree (max|diff| "
              f"{err5:.3e})", flush=True)
        slices, slice_launches = phase_mesh_slices(torch,
                                                   Path(tmp) / "slice_mesh")
        for n, c in slice_launches.items():
            mesh_launches[n] += c
        print("phase 5f: 128x128 f64 slices (MUSCL 60 s, the others 120 s) "
              "as a 2x2 mesh in forecast windows (frozen-speed dt), card vs "
              "CPU: "
              + "; ".join(f"{label} {st5} steps, window {w}, {rr} re-runs, "
                          f"max|diff| {e5:.3e}"
                          for label, (st5, w, rr, e5) in slices.items()),
              flush=True)
        res_5g = run_mesh_stream_path(Path(tmp) / "mesh_stream", "cuda",
                                      128, 128, 120.0, 60.0)
        for n, c in res_5g["launches"].items():
            mesh_launches[n] += c
        _expect_launches("phase 5g", res_5g["launches"], {
            "godunov_fused": 4 * (res_5g["steps"] + res_5g["idle"]
                                  + res_5g["window"] * res_5g["reruns"])})
        print(f"phase 5g: radar model 128x128 f32c as a 2x2 mesh, io_mode "
              f"stream on the card, each event against a gathered snapshot "
              f"of the same state: rasters, gauge CSV and every checkpoint "
              f"member equal; {res_5g['steps']} steps "
              f"(+{res_5g['idle']} idle), window {res_5g['window']}, "
              f"{res_5g['reruns']} re-runs, launches: godunov_fused "
              f"{res_5g['launches']['godunov_fused']}", flush=True)
        res_5h = run_ranks_stream_path(Path(tmp) / "ranks_stream", 128, 128,
                                       120.0, 60.0)
        if not_run("5i", cards):
            print(not_run("5i", cards), flush=True)
        else:
            res_5i = run_ranks_stream_path(
                Path(tmp) / "cards_stream", 128, 128, 120.0, 60.0,
                label="5i", ranks=4 if cards >= 4 else 2, share_card=False)
            if any(r["groups"].get("device") != "nccl"
                   for r in res_5i["ranks"]):
                raise RuntimeError(f"5i: the ranks' groups "
                                   f"{[r['groups'] for r in res_5i['ranks']]}")
            for n, c in res_5i["launches"].items():
                mesh_launches[n] += c
            _expect_launches("phase 5i", res_5i["launches"], {
                "godunov_fused": 4 * (res_5i["steps"] + res_5i["idle"]
                                      + res_5i["window"]
                                      * res_5i["reruns"])})
            print(f"phase 5i: radar model 128x128 f32c streamed as a 2x2 mesh "
                  f"on {len(res_5i['ranks'])} ranks, one card each (device "
                  f"group nccl), against one process: rasters, gauge CSV "
                  f"and all {len(res_5i['members'])} checkpoint members "
                  f"equal; {res_5i['steps']} steps (+{res_5i['idle']} "
                  f"idle), window {res_5i['window']}, {res_5i['reruns']} "
                  f"re-runs on every rank; host reads in the batches "
                  f"{res_5i['reads']} over the ranks ({res_5i['batches']} "
                  f"batches a rank); launches: godunov_fused "
                  f"{res_5i['launches']['godunov_fused']}", flush=True)
        for n, c in res_5h["launches"].items():
            mesh_launches[n] += c
        for label, launches in (("5h ranks", res_5h["launches"]),
                                ("5h one process", res_5h["one_launches"])):
            _expect_launches(f"phase {label}", launches, {
                "godunov_fused": 4 * (res_5h["steps"] + res_5h["idle"]
                                      + res_5h["window"]
                                      * res_5h["reruns"])})
        print(f"phase 5h: radar model 128x128 f32c streamed as a 2x2 mesh on "
              f"two ranks (two blocks each) against one process, fixed "
              f"batches of 8 windows: rasters, gauge CSV and all "
              f"{len(res_5h['members'])} checkpoint members equal; "
              f"{res_5h['steps']} steps (+{res_5h['idle']} idle), window "
              f"{res_5h['window']}, {res_5h['reruns']} re-runs on both; "
              f"launches: godunov_fused "
              f"{res_5h['launches']['godunov_fused']}", flush=True)

    # The kernels line: launches on each kernel's main path, times and
    # bounds of one f32c step at 9.04 M cells on the random domain.
    share = second_order_share(torch, device, random_domain(0, rows, cols))
    launches = {**res["launches"], **{k: res_b["launches"][k] for k in (
        "muscl_predict", "muscl_correct")}, **{k: res_c["launches"][k] for
        k in ("muscl_predict_base", "muscl_correct_recompute")},
        "inertial_fused": res_d["launches"]["inertial_fused"],
        "muscl_fused": k5b_launches}
    record = kernels_record(times, err, launches, rows * cols, share,
                            mesh_launches, k5b_mesh)
    print(f"K5b vs split12 max|diff| {split_diff:.3e}; second-order share "
          f"of the random domain {share:.4f}; chip_smoke wall "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
