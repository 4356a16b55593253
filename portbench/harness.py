"""One run of one cell: set-up, the measured window (or, traced, one
profiled segment), the check against the reference, the result line.

A segment is the traffic's simulated interval [0, S]: the start state
restored with the program's ``load_checkpoint`` (harness work, timed
apart and left out), then ``Simulation.run_to`` and
``Simulation.emit_output`` at each output time and ``run_to(S)``, the
calls ``Simulation.run`` makes.  Every segment does the same work, so a
faster program completes more of them.  Set-up is everything from the
process's start to the first timed segment: the model directory written
from the seed, loaded and built through the program's own XML path, the
start checkpoint written, and one untimed segment that loads every
kernel.

A configuration with a ``layout`` (``{"ranks": n, "mesh_shape": [py,
px], "sync": "timestep" | "forecast"}``) runs on a mesh of blocks: with
``ranks`` over 1, this function runs in each of the ranks that
``ranks.py`` starts, one per card, joined in the program's process group;
the model directory and the start checkpoint lie in one directory that
all of them share.  Rank 0 writes the model, decides after each segment
whether the window goes on and tells the others, takes the segments'
times, judges the outputs and returns the result; the others return None.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from . import check, model_dir, spec, trace
from .reference import model as reference

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "hipims_tpu")
PRECISION = {"double": "float32c", "float32c": "float32c",
             "compensated": "float32c", "single": "float32",
             "float": "float32", "double-strict": "float64"}


def say(*parts):
    print(*parts, flush=True)


def card_info():
    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.split("\n")[0].strip()
    except (OSError, subprocess.SubprocessError):
        limit = "unknown"
    return name, limit


def forbidden_loaded():
    """Top-level names in sys.modules that the benchmark may not load,
    compared whole (hipims_tpu_torch is not hipims_tpu)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


class ForbiddenModules(RuntimeError):
    def __init__(self, names):
        super().__init__("loaded: " + ", ".join(names))
        self.names = names


def world():
    """(ranks, this rank) of the process group the run is in, (1, 0)
    without one."""
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def everyone(value):
    """``value`` of every rank, in rank order, over the world group."""
    n, _ = world()
    if n == 1:
        return [value]
    out = [None] * n
    dist.all_gather_object(out, value)
    return out


def from_rank0(value):
    """Rank 0's ``value`` on every rank."""
    if world()[0] == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier():
    if world()[0] > 1:
        dist.barrier()


def mesh_of(layout, device):
    """The program's mesh for a configuration's ``layout`` (None without
    one): its blocks dealt out to the ranks, one card each, or, in one
    process, all on ``device``."""
    if not layout:
        return None
    from hipims_tpu_torch.parallel import make_mesh

    shape = tuple(int(k) for k in layout["mesh_shape"])
    n = shape[0] * shape[1]
    on_cpu = torch.device(device).type == "cpu"
    return make_mesh(n, shape=shape, devices=[device] * n
                     if world()[0] == 1 or on_cpu else None)


class Segments:
    """The program's simulation of one model directory and its restore
    point."""

    def __init__(self, xml, device, workdir, traffic, layout=None):
        from hipims_tpu_torch.io.xml_config import load_config
        from hipims_tpu_torch.runtime import checkpoint

        self._ckpt = checkpoint
        self.sim = load_config(xml).simulation(device=device,
                                               mesh=mesh_of(layout, device))
        # Every rank reads the output events' chunks; rank 0 writes.
        self.sim.write_outputs = world()[1] == 0
        self.start = Path(workdir) / "start.npz"
        checkpoint.save_checkpoint(self.start, self.sim)
        self.times = [float(t) for t in traffic["output_times_s"]]
        self.end = float(traffic["segment_s"])

    def run(self):
        """One segment; returns its record: wall, host CPU and
        garbage-collection seconds, restore seconds, successful and idle
        steps, the event spans."""
        from torch.profiler import record_function

        sim = self.sim
        r0 = time.perf_counter()
        self._ckpt.load_checkpoint(self.start, sim)
        restored = time.perf_counter() - r0
        # Under ranks every rank has restored before rank 0's clock starts.
        barrier()
        spans = []
        gc0 = dict(GC_CLOCK)
        c0 = time.process_time()
        t0 = time.perf_counter()
        for t in self.times + ([self.end] if self.end not in self.times
                               else []):
            s0 = time.perf_counter()
            with record_function("portbench.run_to"):
                sim.run_to(t)
            s1 = time.perf_counter()
            spans.append(("portbench.run_to", s0, s1))
            if t in self.times:
                with record_function("portbench.emit_output"):
                    sim.emit_output(t)
                spans.append(("portbench.emit_output", s1,
                              time.perf_counter()))
        wall = time.perf_counter() - t0
        cpu = time.process_time() - c0
        return types.SimpleNamespace(
            wall=wall, cpu=cpu, restore=restored, steps=sim.total_steps,
            idle=sim.total_skipped, spans=spans,
            gc_n=GC_CLOCK["n"] - gc0["n"], gc_s=GC_CLOCK["s"] - gc0["s"],
            events=[e - s for n, s, e in spans
                    if n == "portbench.emit_output"])

    def outputs(self):
        """What the check reads of the program: its clock and its state
        at the segment's end, as float64 host arrays, read through the
        snapshot that its output events and checkpoints read (under ranks
        a collective read, whose planes rank 0 keeps; None elsewhere)."""
        from hipims_tpu_torch.runtime.sharded_io import stream_rows

        sim = self.sim
        snap = sim.output_view()
        keep = world()[1] == 0
        planes = []
        for name in ("z", "zmax", "qx", "qy", "zb"):
            chunks = [np.asarray(c, dtype=np.float64) if keep else None
                      for _, c in stream_rows(snap.plane(name),
                                              snap.chunk_rows)]
            planes.append(np.concatenate(chunks) if keep else None)
        if not keep:
            return None
        return {"t": sim.t, "t_hydro": float(sim.carry.t_hydro),
                "state": planes}


GC_CLOCK = {"n": 0, "s": 0.0, "start": None}


def _gc_clock(phase, info):
    """gc.callbacks hook: counts the collections and their seconds."""
    if phase == "start":
        GC_CLOCK["start"] = time.perf_counter()
    elif GC_CLOCK["start"] is not None:
        GC_CLOCK["n"] += 1
        GC_CLOCK["s"] += time.perf_counter() - GC_CLOCK["start"]
        GC_CLOCK["start"] = None


def run_cell(workload, seed, seconds, trace_on, *, device="cuda",
             precision=None, sizes=None, limits=None, t_start=None,
             root=None, reference_cache=None, workdir=None):
    """One run of ``workload``; returns the result dict that ``run.py``
    prints (None on a rank other than 0).  ``device``, ``precision`` (the
    control's "single"), ``sizes`` (rows, cols and segment_s for a tiny
    CPU rehearsal) with ``limits`` for that size (the cell's own are read
    at its own size), and ``reference_cache`` (a dict that keeps the
    reference's outputs for the next run of the same seed) are for the
    tests and the readings tool: the command line sets none of them.
    ``workdir`` is the directory the ranks share (``ranks.py`` makes it);
    one process makes its own."""
    t_start = time.perf_counter() if t_start is None else t_start
    root = root or spec.ROOT
    bench = spec.benchmark(root)
    cell = spec.cell(bench, workload)
    config = spec.config(bench, cell["config"], root)
    traffic = spec.traffic(cell["traffic"], root)
    limits = limits or spec.limits(workload, root)
    if sizes:
        config.update({k: v for k, v in sizes.items() if k in config})
        traffic.update({k: v for k, v in sizes.items() if k in traffic})
    layout = config.get("layout")
    ranks, rank = world()
    need = int(layout["ranks"]) if layout else 1
    if int(cell["chips"]) != need or ranks != need:
        raise ValueError(f"{workload}: {cell['chips']} chip(s) and a run "
                         f"of {ranks} rank(s) for a layout of {need}")
    on_card = torch.device(device).type == "cuda"
    cells = config["rows"] * config["cols"]
    own_dir = workdir is None
    workdir = Path(workdir or tempfile.mkdtemp(
        prefix="portbench-", dir=os.environ.get("TMPDIR")))
    gc.callbacks.append(_gc_clock)
    try:
        xml = workdir / "model" / "model.xml"
        if rank == 0:
            model_dir.write(workdir / "model", config, traffic, seed,
                            precision=precision)
        barrier()
        run_precision = PRECISION[precision
                                  or config["floatingPointPrecision"]]
        seg = Segments(xml, device, workdir, traffic, layout)
        warm = seg.run()
        say(f"warm segment: {warm.wall:.3f} s, {warm.steps} steps "
            f"(+{warm.idle} idle), restore {warm.restore:.3f} s")
        if on_card:
            torch.cuda.synchronize()
            setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        barrier()
        setup_s = time.perf_counter() - t_start
        if trace_on:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if on_card else [])
            # One segment on the host clock alone, for the host-clock
            # metrics and the wall that the device's busy seconds are
            # measured against (the profiler slows this host-bound loop
            # by about half, with or without the host's operations); then
            # one under the profiler.
            plain = seg.run()
            with profile(activities=acts) as prof:
                segs = [seg.run()]
            tr = trace.collect(prof)
            del prof
        else:
            # Rank 0 decides, so that every rank runs the same segments.
            segs = []
            while from_rank0(not segs or sum(s.wall for s in segs)
                             < seconds):
                segs.append(seg.run())
        if on_card:
            torch.cuda.synchronize()
            window_peak = torch.cuda.max_memory_allocated()
        else:
            setup_peak = window_peak = 0
        loaded = forbidden_loaded()
        if loaded:
            raise ForbiddenModules(loaded)
        peaks = everyone((setup_peak, window_peak))
        busy = everyone((tr.busy_s(), tr.nccl_s())) if trace_on else None
        program = seg.outputs()
        # Every rank frees the program's state before the last
        # collective, so that the reference finds each card's memory free.
        del seg
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        barrier()
        if ranks > 1:
            # Every collective of the run is behind: the other ranks are
            # done, and rank 0 goes on alone.
            from hipims_tpu_torch.parallel import distributed
            distributed.shutdown()
        if rank != 0:
            return None
        wall = sum(s.wall for s in segs)
        failed = sum(s.steps != warm.steps for s in segs)
        seg_s = float(traffic["segment_s"])
        say(f"segments: {len(segs)} in {wall:.3f} s "
            f"(restores {sum(s.restore for s in segs):.3f} s apart: "
            + ", ".join(f"{s.restore:.3f}" for s in segs) + ")")
        say("steps per segment: "
            + ", ".join(str(s.steps) for s in segs)
            + f" (warm-up {warm.steps}); idle steps: "
            + ", ".join(str(s.idle) for s in segs))
        say("segment walls s: " + ", ".join(f"{s.wall:.4f}" for s in segs))
        say("segment host cpu s: "
            + ", ".join(f"{s.cpu:.4f}" for s in segs))
        say("segment gc: " + ", ".join(f"{s.gc_n} in {s.gc_s:.4f} s"
                                       for s in segs))
        events = [e for s in segs for e in s.events]
        if events:
            say("output events s: " + ", ".join(f"{e:.4f}" for e in events))
        say(f"cell updates per second: "
            f"{cells * sum(s.steps for s in segs) / wall:.6e}")
        if ranks > 1:
            say("peak bytes per card (set-up, window): "
                + ", ".join(f"{a} {b}" for a, b in peaks))

        result = {"correct": False, "attempted": len(segs), "failed": failed,
                  "metrics": {}}
        if trace_on:
            say(f"traced segment: profiled {segs[0].wall:.4f} s, "
                f"unprofiled {plain.wall:.4f} s")
            ctx = types.SimpleNamespace(
                trace=tr, spans=plain.spans, wall=plain.wall, cells=cells,
                steps=segs[0].steps, idle=segs[0].idle, config=config,
                traffic=traffic, precision=run_precision, chips=ranks)
            for m in spec.metrics(bench, workload, "per_layer"):
                value = spec.reader(m["name"], root)(ctx)
                if value is not None:
                    result["metrics"][m["name"]] = {"value": value,
                                                    "unit": m["unit"]}
            # The device's busy seconds, and the NCCL kernels' kept
            # apart, averaged over the cards; the readers and the
            # breakdown read rank 0's.
            busy_s = sum(b for b, _ in busy) / len(busy)
            nccl_s = sum(n for _, n in busy) / len(busy)
            window_s = tr.window_s
            with_nccl = trace.seconds(trace.union(tr.device_ops, tr.window))
            say("device busy s per card: "
                + ", ".join(f"{b:.6f}" for b, _ in busy)
                + "; NCCL kernels apart: "
                + ", ".join(f"{n:.6f}" for _, n in busy)
                + f"; rank 0's busy with them: {with_nccl:.6f}")
            breakdown = {"device_ops": trace.device_time_by_name(tr),
                         "idle_gaps": trace.idle_by_host(tr)}
            del tr
        else:
            e2e = {"sim_speed": len(segs) * seg_s / wall,
                   "peak_mem_GiB": max(w for _, w in peaks) / 2.0 ** 30,
                   "setup_s": setup_s}
            for m in spec.metrics(bench, workload, "end_to_end"):
                result["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                                "unit": m["unit"]}
        if on_card:
            name, limit = card_info()
            say(f"card: {name}, count {ranks} of "
                f"{torch.cuda.device_count()} visible, power limit {limit}")
            result["device"] = {"platform": "gpu", "kind": name,
                                "count": ranks,
                                "memory_peak_bytes": max(max(p)
                                                         for p in peaks)}
        else:
            result["device"] = {"platform": "cpu", "kind": "cpu",
                                "count": ranks, "memory_peak_bytes": 0}
        if trace_on:
            result["device"].update(busy_s=busy_s, window_s=window_s,
                                    nccl_s=nccl_s)
            result["breakdown"] = breakdown

        devices = reference_devices(config, device)
        if on_card:
            for d in devices:
                torch.cuda.reset_peak_memory_stats(d)
        r0 = time.perf_counter()
        model = reference.load(xml)
        if reference_cache is not None and "outputs" in reference_cache:
            ref = reference_cache["outputs"]
        else:
            ref = reference_outputs(model, traffic, devices)
            if reference_cache is not None:
                reference_cache["outputs"] = ref
        ref_s = time.perf_counter() - r0
        out_dir = xml.parent / "output"
        numbers = check.readings(
            program, ref,
            lambda kind, t: check.raster(out_dir / f"{kind}_{t:g}.tif"),
            traffic, config["cell_size_m"],
            lambda state, t, t_hydro: reference.settle(model, state, t,
                                                       t_hydro))
        correct, compared = check.judge(numbers, limits)
        say(f"reference: {ref_s:.3f} s, {numbers['reference_steps']} steps "
            "on " + ", ".join(
                f"{d} (peak {torch.cuda.max_memory_allocated(d)} B)"
                if on_card else str(d) for d in devices))
        say("readings: " + json.dumps(numbers))
        result["correct"] = correct
        result["compared"] = compared
        return result
    finally:
        gc.callbacks.remove(_gc_clock)
        if own_dir:
            shutil.rmtree(workdir, ignore_errors=True)


def reference_devices(config, device):
    """The devices of the float64 reference for a run of ``config`` on
    ``device``: one for each rank of its ``layout`` where that has
    several (the run's cards, ``cuda:0`` on; on the CPU, the CPU for
    each), else ``device`` alone."""
    n = int((config.get("layout") or {}).get("ranks", 1))
    if n > 1 and torch.device(device).type == "cuda":
        return [f"cuda:{k}" for k in range(n)]
    return [device] * n


def reference_outputs(model, traffic, devices):
    """The float64 reference's outputs for ``model`` (``reference.load``
    of the cell's XML) at each of the traffic's sync times (its output
    times and the segment's end), keyed by time: the whole grid on one
    device, or row blocks over several."""
    times = sorted({float(t) for t in traffic["output_times_s"]}
                   | {float(traffic["segment_s"])})
    outs = (reference.run(model, times, devices[0]) if len(devices) == 1
            else reference.run_blocks(model, times, devices))
    return dict(zip(times, outs))


def print_compared(result, stream=sys.stderr):
    """The numbers compared, each beside its limit, as the last lines of
    standard error."""
    for name, c in result["compared"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"{name} {c['value']!r} limit {c['limit']!r} {ok}",
              file=stream, flush=True)

