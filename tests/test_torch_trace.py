"""The port's profiler spans (``hipims_tpu_torch/utils/trace.py``) on the
CPU: off without a profiler, where each layer boundary puts them under
one, recorded as plain CPU operations (never user annotations, which the
profiler copies onto the device's timeline), and read by the benchmark's
per-layer readers (``portbench/metrics/``) from a hand-built trace."""

import collections
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hipims_tpu_torch.parallel import make_mesh
from hipims_tpu_torch.runtime import Simulation, SimulationConfig
from hipims_tpu_torch.runtime.output import RasterOutputWriter
from hipims_tpu_torch.utils import trace as program_trace
from portbench import spec, trace
from tests.test_torch_halo_deep import dam, flat, rain

torch.set_num_threads(1)
CPU = torch.device("cpu")
MS = 1_000_000          # ns


class CountingSpan:
    """Stands in for the profiler's record-function class: counts the
    spans constructed, by name."""

    made = collections.Counter()

    def __init__(self, name):
        CountingSpan.made[name] += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.fixture
def counting(monkeypatch):
    CountingSpan.made = collections.Counter()
    monkeypatch.setattr(program_trace, "RecordFunctionFast", CountingSpan)
    return CountingSpan


def muscl_sim(**kw):
    cfg = dict(scheme="muscl-hancock", duration=60.0, output_frequency=60.0,
               dtype="float64", batch_size=16, batch_auto=False)
    cfg.update(kw)
    return Simulation(dam(24, h_in=1.0, h_out=0.2), SimulationConfig(**cfg),
                      device=CPU)


def one_batch(sim):
    sync = torch.tensor(60.0, dtype=sim.dtype)
    sim._run_batch(sim._state, sim.carry, sim._static, sync, sim._comp, 16)


def program_events(prof):
    """(name, activity type, start, end) of the profile's hipims. events."""
    return [(ev.name(), str(ev.activity_type()), ev.start_ns(),
             ev.start_ns() + ev.duration_ns())
            for ev in prof.profiler.kineto_results.events()
            if ev.name().startswith("hipims.")]


def test_no_profiler_constructs_no_span(counting):
    sim = muscl_sim()
    assert program_trace.span("hipims.batch") is \
        program_trace.span("hipims.step.advance")
    one_batch(sim)
    assert counting.made == {}
    # The same batch under a profiler constructs its spans.
    with profile(activities=[ProfilerActivity.CPU]):
        one_batch(sim)
    assert counting.made == {"hipims.batch": 1, "hipims.step.scheme": 16,
                             "hipims.step.advance": 16}


def test_without_the_fast_class_spans_are_off(monkeypatch):
    monkeypatch.setattr(program_trace, "RecordFunctionFast", None)
    sim = muscl_sim()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        one_batch(sim)
    assert program_events(prof) == []


def test_batch_spans_nest_and_are_cpu_ops():
    sim = muscl_sim()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sim.run_to(1e-3)         # one batch: the target is within its
    events = program_events(prof)   # first step, the rest idle
    names = collections.Counter(n for n, *_ in events)
    assert names == {"hipims.batch": 1, "hipims.step.scheme": 16,
                     "hipims.step.advance": 16, "hipims.batch.read": 1}
    assert {kind for _, kind, _, _ in events} == {"cpu_op"}
    (_, _, b0, b1), = [e for e in events if e[0] == "hipims.batch"]
    for name, _, s, e in events:
        if name.startswith("hipims.step."):
            assert b0 <= s and e <= b1, name
        if name == "hipims.batch.read":
            assert s >= b1


@pytest.mark.parametrize("io_mode,chunks", [("gather", 1), ("stream", 3)])
def test_output_event_spans(tmp_path, io_mode, chunks):
    targets = [{"value": "depth", "format": "tif", "target": "depth_%t.tif"},
               {"value": "maxdepth", "format": "asc",
                "target": "maxdepth_%t.asc"}]
    written = {}
    for traced in (False, True):
        sim = muscl_sim(io_mode=io_mode, io_chunk_mb=0)
        out = tmp_path / str(traced)
        sim.output_writer = RasterOutputWriter(targets, str(out), sim.domain)
        sim.run_to(2.0)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            sim.emit_output(2.0)
        written[traced] = {p.name: p.read_bytes() for p in out.iterdir()}
    assert written[True] == written[False]
    assert sorted(written[True]) == ["depth_2.tif", "maxdepth_2.asc"]
    events = program_events(prof)
    names = collections.Counter(n for n, *_ in events)
    assert names["hipims.output.event"] == 1
    assert names["hipims.output.derive"] == len(targets) * chunks
    # One snapshot, then one host copy per chunk.
    assert names["hipims.output.snapshot"] == 1 + chunks
    assert names["hipims.output.encode"] >= chunks
    (_, _, e0, e1), = [e for e in events if e[0] == "hipims.output.event"]
    for name, kind, s, e in events:
        assert kind == "cpu_op"
        assert e0 <= s and e <= e1, name


def test_mesh_reruns_and_windows_are_counted():
    sim = Simulation(flat(48), SimulationConfig(
        scheme="godunov", duration=30.0, output_frequency=30.0,
        batch_size=4, batch_auto=False, sync_method="forecast",
        forecast_window=4, forecast_dt="window"), boundaries=(rain(3600.0),),
        mesh=make_mesh(2, shape=(2, 1), devices=[CPU] * 2))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sim.run_to(10.0)
    names = collections.Counter(n for n, *_ in program_events(prof))
    assert sim.window_reruns > 0
    # Every window of every batch, and each re-run once more.
    assert sim.windows == 4 * names["hipims.batch"] + sim.window_reruns
    assert names["hipims.mesh.halo"] == 4 * names["hipims.batch"]
    steps = names["hipims.step.scheme"]
    assert steps == 2 * 4 * (4 * names["hipims.batch"] + sim.window_reruns)
    assert names["hipims.step.boundaries"] == steps
    assert names["hipims.step.advance"] == steps // 2
    assert names["hipims.batch.read"] == names["hipims.batch"]


def test_one_device_counts_no_windows():
    sim = muscl_sim()
    sim.run_to(1e-3)
    assert (sim.windows, sim.window_reruns) == (0, 0)


def test_every_span_name_in_the_package_starts_with_hipims():
    import re
    from pathlib import Path

    import hipims_tpu_torch
    pkg = Path(hipims_tpu_torch.__file__).parent
    names = {n for p in pkg.rglob("*.py")
             for n in re.findall(r"\bspan\(\"([^\"]*)\"\)", p.read_text())}
    assert len(names) >= 15
    assert all(n.startswith("hipims.") for n in names), names


# ---------------------------------------------------------------------------
# The benchmark's readers of the spans, on a hand-built trace.
# ---------------------------------------------------------------------------

def hand_trace(program=True, device=True):
    """A segment of 100 ms: ``run_to`` 0-60 ms (a batch 5-55 of two steps,
    scheme then advance, and the batch's read 55-58), then two output
    events (60-80 and 80-100 ms).  Five launch calls in ``advance``, two
    in the scheme, one in the read, one before the batch; kernels 12-15
    and 32-35 ms."""
    spans = [("portbench.run_to", 0, 60 * MS),
             ("portbench.emit_output", 60 * MS, 80 * MS),
             ("portbench.emit_output", 80 * MS, 100 * MS)]
    ours = [("hipims.batch", 5, 55), ("hipims.step.scheme", 10, 20),
            ("hipims.step.advance", 20, 30), ("hipims.step.scheme", 30, 40),
            ("hipims.step.advance", 40, 50), ("hipims.batch.read", 55, 58),
            ("hipims.output.event", 60, 80),
            ("hipims.output.snapshot", 60, 62),
            ("hipims.output.derive", 62, 70),
            ("hipims.output.encode", 70, 78),
            ("hipims.output.event", 80, 100),
            ("hipims.output.derive", 82, 85),
            ("hipims.output.encode", 85, 95)]
    ops = [("aten::add", 21, 27), ("cudaLaunchKernel", 22, 23),
           ("cudaLaunchKernel", 24, 25), ("cudaLaunchKernel", 26, 27),
           ("cudaLaunchKernel", 42, 43), ("cuLaunchKernelEx", 44, 45),
           ("cudaLaunchKernel", 12, 13), ("cudaLaunchKernel", 32, 33),
           ("cudaLaunchKernel", 56, 57), ("cudaLaunchKernel", 2, 3)]
    host = [(n, s, e) for n, s, e in spans]
    host += [(n, s * MS, e * MS) for n, s, e in
             (ours if program else []) + (ops if device else [])]
    host.sort(key=lambda h: (h[1], -h[2]))
    device_ops = ([("muscl_predict_kernel", 12 * MS, 15 * MS, True),
                   ("muscl_correct_kernel", 32 * MS, 35 * MS, True)]
                  if device else [])
    return trace.Trace(device_ops=device_ops, spans=spans,
                       window=(0, 100 * MS), host=host)


# The same two events run without the profiler: 18 ms a mean event.
PLAIN = [("portbench.run_to", 0.0, 0.05),
         ("portbench.emit_output", 0.05, 0.066),
         ("portbench.emit_output", 0.066, 0.086)]


def read(name, tr, steps=1, idle=1, plain=PLAIN):
    ctx = types.SimpleNamespace(trace=tr, steps=steps, idle=idle,
                                spans=plain)
    return spec.reader(name)(ctx)


def test_advance_launches_per_step_reads_the_innermost_span():
    # 5 launches under advance (the aten op between them does not hide
    # them) over 2 steps, idle step included.
    assert read("advance_launches_per_step", hand_trace()) == 2.5
    assert read("advance_launches_per_step", hand_trace(), 4, 1) == 1.0


def test_advance_idle_pct_splits_gaps_at_span_edges():
    # Idle inside run_to: 0-12, 15-32, 35-60 = 54 ms; of it under advance
    # 20-30 and 40-50 = 20 ms.
    assert read("advance_idle_pct", hand_trace()) == \
        pytest.approx(100.0 * 20 / 54)


def test_output_parts_per_event():
    # Derive takes 11 of the profiled events' 40 ms, encode 18: their
    # shares of the unprofiled 18 ms event.
    assert read("output_derive_s", hand_trace()) == \
        pytest.approx(11 / 40 * 18e-3)
    assert read("output_encode_s", hand_trace()) == \
        pytest.approx(18 / 40 * 18e-3)
    # Without unprofiled events there is no clock to put them on.
    assert read("output_derive_s", hand_trace(), plain=PLAIN[:1]) is None


@pytest.mark.parametrize("name", ["advance_launches_per_step",
                                  "advance_idle_pct", "output_derive_s",
                                  "output_encode_s"])
def test_readers_without_program_spans_read_nothing(name):
    assert read(name, hand_trace(program=False)) is None


def test_cpu_trace_reads_only_the_output_parts():
    tr = hand_trace(device=False)
    assert read("advance_launches_per_step", tr) is None
    assert read("advance_idle_pct", tr) is None
    assert read("output_derive_s", tr) == pytest.approx(11 / 40 * 18e-3)
    assert read("output_encode_s", tr) == pytest.approx(18 / 40 * 18e-3)
