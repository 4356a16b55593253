"""The per-layer metrics' arithmetic on a synthetic trace, each reader
found by its name in BENCHMARK.json, and the bytes bound.

    python -m pytest --noconftest -p no:cacheprovider portbench/tests
"""

import types

import pytest

from portbench import costs, spec, trace

MS = 1_000_000          # ns


def synthetic(kernels, spans, memcpy=()):
    ops = [(name, s, e, True) for name, s, e in kernels]
    ops += [(name, s, e, False) for name, s, e in memcpy]
    host = sorted([(n, s, e) for n, s, e in spans]
                  + [("aten::item", 5 * MS, 6 * MS),
                     ("cudaStreamSynchronize", 5 * MS, 6 * MS)],
                  key=lambda h: (h[1], -h[2]))
    return trace.Trace(device_ops=ops, spans=spans,
                       window=(spans[0][1], spans[-1][2]), host=host)


@pytest.fixture
def ctx():
    bench = spec.benchmark()
    config = spec.config(bench, "malpasset-10m")
    k = "void muscl_correct_kernel<float, true>(float const*, int)"
    # Two overlapping kernels (1-3 and 2-4 ms), one at 6-7 ms, a copy at
    # 8-9 ms; stepping 0-10 ms, an output event 10-20 ms.
    tr = synthetic([(k, 1 * MS, 3 * MS), ("elementwise_kernel", 2 * MS,
                                          4 * MS), (k, 6 * MS, 7 * MS)],
                   [("portbench.run_to", 0, 10 * MS),
                    ("portbench.emit_output", 10 * MS, 20 * MS)],
                   memcpy=[("Memcpy DtoH (Device -> Pageable)", 8 * MS,
                            9 * MS)])
    # The host-clock spans of the unprofiled segment, in seconds.
    spans = [(n, s * 1e-9, e * 1e-9) for n, s, e in tr.spans]
    return types.SimpleNamespace(trace=tr, spans=spans, wall=20e-3,
                                 cells=config["rows"] * config["cols"],
                                 steps=2, idle=1, config=config, traffic={},
                                 precision="float32c")


def read(name, ctx):
    return spec.reader(name)(ctx)


def test_union_of_intervals_not_sum(ctx):
    # busy = [1, 4] + [6, 7] + [8, 9] = 5 ms of a 20 ms window
    assert ctx.trace.busy_s() == pytest.approx(5e-3)
    assert read("device_idle_pct", ctx) == pytest.approx(75.0)


def test_idle_share_is_of_the_unprofiled_wall(ctx):
    # the same 5 ms of device work in a segment of 10 ms without the
    # profiler: the profiler's 10 ms more are not the device's idle time
    ctx.wall = 10e-3
    assert read("device_idle_pct", ctx) == pytest.approx(50.0)


def test_launches_count_kernels_over_all_steps(ctx):
    assert read("launches_per_step", ctx) == pytest.approx(3 / 3)


def test_bytes_bound_at_both_grids():
    # the dam break's grid, and the 9.04 M-cell Thamesmead grid
    assert costs.step_bytes(1, "float32c") == 48
    assert costs.step_bound_s(2944 * 3072, "float32c") * 1e3 == \
        pytest.approx(0.1296, abs=5e-5)
    assert costs.step_bound_s(1024 * 1792, "float32c") * 1e3 == \
        pytest.approx(0.0263, abs=5e-5)


def test_scheme_roofline_reads_named_kernels_per_step(ctx):
    bound = costs.step_bound_s(ctx.cells, "float32c")
    # muscl_correct_kernel: 2 + 1 ms over 2 successful steps
    assert read("scheme_roofline", ctx) == pytest.approx(
        100 * bound / 1.5e-3)


def test_step_mfu_reads_run_to_spans(ctx):
    bound = costs.step_bound_s(ctx.cells, "float32c")
    assert read("step_mfu", ctx) == pytest.approx(100 * bound / 5e-3)


def test_output_event_and_silence(ctx):
    assert read("output_event_s", ctx) == pytest.approx(10e-3)
    ctx.spans = ctx.spans[:1]
    assert read("output_event_s", ctx) is None
    ctx.trace.device_ops = []
    assert read("scheme_roofline", ctx) is None
    assert read("launches_per_step", ctx) is None
    assert read("device_idle_pct", ctx) is None


def test_breakdown_labels_gaps_by_host_activity(ctx):
    gaps = dict(trace.idle_by_host(ctx.trace))
    assert gaps["output_event: python"] == pytest.approx(10e-3)
    # the 4-6 ms gap under the synchronising read; 0-1, 7-8, 9-10 in Python
    assert gaps["stepping: cudaStreamSynchronize"] == pytest.approx(2e-3)
    assert gaps["stepping: python"] == pytest.approx(3e-3)
    ops = dict(trace.device_time_by_name(ctx.trace))
    assert ops["muscl_correct_kernel"] == pytest.approx(3e-3)


NCCL = "ncclDevKernel_AllReduce_Sum_f64_RING_LL(ncclDevKernelArgsStorage)"


@pytest.mark.parametrize("name", [NCCL, "void NCCLKernel_SendRecv<4>()"])
def test_nccl_kernels_are_kept_out_of_the_busy_time(ctx, name):
    # The readers' values and the idle labels without NCCL's kernels.
    before = {m["name"]: read(m["name"], ctx) for m in spec.benchmark()
              ["per_layer"]}
    gaps = trace.idle_by_host(ctx.trace)
    assert ctx.trace.nccl_s() == 0.0
    # One in the 4-6 ms gap under the synchronising read, overlapping
    # nothing, and one over the kernel at 6-7 ms.
    ctx.trace.device_ops += [(name, 4 * MS, 5 * MS, True),
                             (name, 6.5 * MS, 7.5 * MS, True)]
    assert ctx.trace.busy_s() == pytest.approx(5e-3)
    assert ctx.trace.nccl_s() == pytest.approx(2e-3)
    assert trace.idle_by_host(ctx.trace) == gaps
    after = {n: read(n, ctx) for n in before}
    # Two launches more over the three steps; no other reader moves.
    assert after.pop("launches_per_step") == pytest.approx(5 / 3)
    before.pop("launches_per_step")
    assert after == before
    ops = dict(trace.device_time_by_name(ctx.trace))
    assert ops[trace.short_name(name)] == pytest.approx(2e-3)


def test_short_name():
    assert trace.short_name("void (anonymous namespace)::muscl_correct_"
                            "kernel<float, true, (SlopeSource)0>(float "
                            "const*)") == "muscl_correct_kernel"
    assert trace.short_name("void at::native::vectorized_elementwise_"
                            "kernel<4>(int)") == "vectorized_elementwise_kernel"

