"""Wall-clock batches bounded by the steps left to their sync point
(``Simulation._batch_steps``): the same run as unbounded batches, less the
idle steps past each sync.  The port alone, on the CPU."""

import math
import types

import numpy as np
import pytest
import torch

from hipims_tpu_torch.domain import Domain
from hipims_tpu_torch.ops.boundaries import UniformBoundary
from hipims_tpu_torch.parallel import make_mesh
from hipims_tpu_torch.runtime import Simulation, SimulationConfig, simulation
from hipims_tpu_torch.runtime.progress import ProgressReporter

torch.set_num_threads(1)

SCHEMES = ["godunov", "muscl-hancock", "inertial"]
DTYPES = ["float32c", "float64"]
LAYOUTS = [None, "timestep", "forecast"]
SYNCS = (0.5, 1.0, 2.5)


def _dam(rows=16, cols=24, deep=30.0, dx=2.0, depth=None):
    """An undulating bed with ``deep`` m of water on its western third and
    a dry rest, or ``depth`` m everywhere."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:rows, 0:cols]
    zb = (101.3 - 0.02 * xx + 0.4 * np.sin(yy / 3.0) * np.cos(xx / 5.0)
          + rng.uniform(0, 0.05, (rows, cols)))
    dom = Domain(zb=zb, manning=0.035, dx=dx, dy=dx)
    dom.set_initial_depth(np.where(xx < cols // 3, deep, 0.0)
                          if depth is None else np.full(zb.shape, depth))
    return dom


def _rain(mm_h=100.0):
    return UniformBoundary(values=np.full(61, mm_h), interval=60.0,
                           length=3600.0, is_loss=False)


def _sim(scheme="godunov", dtype="float32c", layout=None, batch=32,
         auto=True, dom=None, **cfg):
    """A rained-on dam break, synced at SYNCS.  ``batch`` counts steps;
    under a mesh, windows of its window's steps (rounded up)."""
    cfg = SimulationConfig(**{**dict(
        scheme=scheme, duration=SYNCS[-1], output_frequency=0.5,
        dtype=dtype, batch_size=batch, batch_auto=auto,
        sync_method=layout or "timestep", forecast_window=3), **cfg})
    mesh = (make_mesh(4, shape=(2, 2), devices=[torch.device("cpu")] * 4)
            if layout else None)
    sim = Simulation(dom or _dam(), cfg, boundaries=(_rain(),),
                     device=None if mesh else "cpu", mesh=mesh)
    sim._batch_size = -(-batch // sim.window)
    return sim


def _run(sim, syncs, bounded=True, adapt=False, progress=None):
    """``run_to`` every sync; returns, per sync, the host carry, the
    batches run and the bounded batches that fell short of their sync.
    Without ``adapt`` the batch size stays put; without ``bounded`` each
    batch is the batch size."""
    if not adapt:
        sim._adapt_batch = lambda elapsed: None
    if not bounded:
        sim._batch_steps = lambda target_time: sim._batch_size
    ran, short, real = [], [], sim._batch_steps

    def counted(target_time):
        n = real(target_time)
        ran.append((n < sim._batch_size, target_time))
        return n

    def after(s, t_new, elapsed):
        if ran[-1][0] and t_new < ran[-1][1]:
            short.append(t_new)
        if progress is not None:
            progress(s, t_new, elapsed)

    sim._batch_steps = counted
    out = []
    for t in syncs:
        sim.run_to(t, progress=after)
        c = sim.carry
        out.append(dict(t=float(c.t), dt=float(c.dt),
                        t_hydro=float(c.t_hydro), ok=int(c.batch_successful),
                        idle=int(c.batch_skipped), batches=len(ran),
                        short=len(short)))
    return out


_PAIRS = {}


def _pair(scheme, dtype, layout):
    """The same run in bounded and unbounded wall-clock batches, once per
    case for the tests below."""
    key = (scheme, dtype, layout)
    if key not in _PAIRS:
        free, bound = _sim(scheme, dtype, layout), _sim(scheme, dtype, layout)
        _PAIRS[key] = (free, _run(free, SYNCS, bounded=False),
                       bound, _run(bound, SYNCS))
    return _PAIRS[key]


def _carry(rec):
    return {k: rec[k] for k in ("t", "dt", "t_hydro", "ok")}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_bounded_batches_give_the_unbounded_run(scheme, dtype, layout):
    """State, comp and zmax ``torch.equal``, and t, dt, t_hydro and the
    successful steps equal at every sync.  Each bounded batch here reaches
    its sync: under frozen-speed windows a batch seeds its first window's
    speed afresh, so a batch that fell short would step other windows
    (as a wall-clock batch of another size does)."""
    free, got_free, bound, got = _pair(scheme, dtype, layout)
    assert got[-1]["short"] == 0
    assert [_carry(r) for r in got] == [_carry(r) for r in got_free]
    for name in ("z", "zmax", "qx", "qy"):
        assert torch.equal(getattr(bound.state, name),
                           getattr(free.state, name)), name
    if dtype == "float32c":
        assert torch.equal(bound.comp, free.comp)
    else:
        assert bound.comp is None and free.comp is None


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_bounded_batches_idle_less(scheme, dtype, layout):
    """Fewer idle steps, some batches bounded, none more batches than a
    sync point's one extra read each, and at least one idle step at every
    sync."""
    free, got_free, bound, got = _pair(scheme, dtype, layout)
    assert bound.batches_bounded > 0 and free.batches_bounded == 0
    assert got[-1]["idle"] < got_free[-1]["idle"]
    assert got[-1]["batches"] <= got_free[-1]["batches"]
    idle = [r["idle"] for r in got]
    assert all(b > a for a, b in zip([0] + idle, idle))


def test_a_short_estimate_is_bounded_again():
    """A batch bounded short of its sync (dt shrank) is followed by
    another; on one device and on a lock-step mesh any batch split gives
    the same run, so the end state is the unbounded run's."""
    for layout in (None, "timestep"):
        free, bound = _sim(layout=layout), _sim(layout=layout)
        want = _run(free, SYNCS, bounded=False)
        real = bound._batch_steps
        bound._batch_steps = lambda t: max(1, real(t) // 3)
        got = _run(bound, SYNCS)
        assert [_carry(r) for r in got] == [_carry(r) for r in want]
        assert got[-1]["short"] > 0
        assert got[-1]["batches"] > want[-1]["batches"]
        for a, b in zip(bound.state, free.state):
            assert torch.equal(a, b)


def _shallow_rain(auto=True, batch=64):
    """Rain on a thin film at 50 m cells, its clock set past the 60 s early
    limit: dt exceeds the 1 s hydrological interval."""
    dom = _dam(rows=12, cols=16, dx=50.0, depth=0.02)
    sim = _sim(dom=dom, auto=auto, batch=batch, duration=300.0,
               output_frequency=60.0)
    sim.carry = sim.carry._replace(t=torch.tensor(60.0, dtype=sim.dtype))
    sim._host_carry = sim._read_carry()
    return sim


def test_t_hydro_at_a_sync_past_one_second_steps():
    """A sync whose last step exceeds the hydrological interval: the idle
    step that follows resets ``t_hydro``, in bounded batches as in
    unbounded ones (the reset is a fault of the time controller, neither
    mended nor hidden here)."""
    syncs = (120.0, 180.0, 240.0, 300.0)
    free, bound = _shallow_rain(), _shallow_rain()
    want, got = _run(free, syncs, bounded=False), _run(bound, syncs)
    assert max(abs(r["dt"]) for r in want[1:]) > 1.0
    assert [_carry(r) for r in got] == [_carry(r) for r in want]
    assert bound.batches_bounded > 0
    assert got[-1]["idle"] < want[-1]["idle"]
    for a, b in zip(bound.state, free.state):
        assert torch.equal(a, b)


def test_a_batch_landing_on_its_sync_is_followed_by_an_idle_one():
    """A bounded batch that lands on its sync with no idle step past it
    (its first step, idle at the previous sync, does not count) is
    followed by one more, of the bound's minimum, so the carry at the sync
    is the one an idle step leaves: ``t_hydro`` reset.  Fixed batches
    take no extra batch."""
    syncs = (120.0, 180.0)
    want = _run(_shallow_rain(), syncs, bounded=False)
    assert want[1]["t_hydro"] == 0.0
    n_land = want[1]["ok"] - want[0]["ok"] + 1
    sim = _shallow_rain()
    real, calls, hydro = sim._batch_steps, [], []

    def landing(target_time):
        calls.append(target_time)
        return n_land if calls.count(180.0) == 1 and target_time == 180.0 \
            else real(target_time)

    sim._batch_steps = landing
    got = _run(sim, syncs,
               progress=lambda s, t, e: hydro.append(float(s.carry.t_hydro)))
    assert got[1]["batches"] - got[0]["batches"] == 2
    assert hydro[-2] > 1.0 and hydro[-1] == 0.0
    assert got[1]["idle"] - got[0]["idle"] == 1 + 8
    assert [_carry(r) for r in got] == [_carry(r) for r in want]

    fixed = _shallow_rain(auto=False, batch=want[0]["ok"])
    done = _run(fixed, syncs[:1])[0]
    assert (done["batches"], done["idle"], done["ok"]) == \
        (1, 0, want[0]["ok"])
    assert done["t"] == want[0]["t"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_fixed_batches_are_unchanged(layout):
    """Without wall-clock sizing no batch is bounded: each runs the batch
    size, so the idle steps are the batches' steps less the successful
    ones, as before bounds, and equal to a run with the bound patched
    off."""
    a = _sim(layout=layout, auto=False)
    b = _sim(layout=layout, auto=False)
    got, want = _run(a, SYNCS), _run(b, SYNCS, bounded=False)
    assert got == want and a.batches_bounded == 0
    steps = got[-1]["batches"] * a._batch_size * a.window
    assert got[-1]["idle"] + got[-1]["ok"] == steps
    for x, y in zip(a.state, b.state):
        assert torch.equal(x, y)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("per_step_ms", [0.01, 0.06, 0.1, 0.15, 0.2, 0.3,
                                         0.6, 1.0, 3.0])
@pytest.mark.parametrize("ran", [8, 40, 512, 1024])
def test_a_bounded_batch_sizes_as_an_unbounded_one(per_step_ms, ran,
                                                   monkeypatch):
    """``run_to`` sizes the next batch from the steps a batch ran: a
    bounded batch of ``ran`` steps leaves the batch size where a whole
    batch at the same seconds a step would, never above it.  The batches
    run on a clock that a step moves by ``per_step_ms``."""
    clock = [0.0]
    monkeypatch.setattr(simulation, "time", types.SimpleNamespace(
        perf_counter=lambda: clock[0]))
    sizes = {}
    for n in (2048, ran):
        sim = _sim()
        sim._batch_size = 2048
        sim.config.batch_target_seconds = 0.5

        def batch(state, carry, static, sync, comp, units):
            clock[0] += per_step_ms * 1e-3 * units
            return state, carry, comp

        seen = []

        def after(s, t_new, elapsed):
            seen.append(s._batch_size)
            if len(seen) == 2:
                raise _Stop

        sim._run_batch = batch
        sim._batch_steps = lambda target_time, n=n: n
        with pytest.raises(_Stop):
            sim.run_to(SYNCS[-1], progress=after)
        sizes[n] = seen[1]
    assert sizes[ran] == sizes[2048]


@pytest.mark.parametrize("dt", [0.0, -0.0, math.inf, -math.inf])
@pytest.mark.parametrize("layout", [None, "forecast"])
def test_no_bound_without_a_finite_timestep(dt, layout):
    """dt of 0 or non-finite (a dry domain fast-forwards) bounds nothing."""
    sim = _sim(layout=layout, batch=512)
    sim._host_carry = np.array([70.0, dt, 0.0, 10.0, 0.0])
    assert sim._batch_steps(100.0) == sim._batch_size


@pytest.mark.parametrize("dt", [0.5, -0.5, 1e-3, 7.0])
@pytest.mark.parametrize("left", [0.0, 0.25, 3.0, 30.0])
@pytest.mark.parametrize("layout", [None, "forecast"])
def test_the_bound(dt, left, layout):
    """The steps left, ceil(left / |dt|), with 1/16 and 8 more, in a
    multiple of 8 steps and never under 8; in windows under a mesh,
    rounded up; never above the batch size."""
    sim = _sim(layout=layout, batch=1 << 16)
    sim._host_carry = np.array([70.0, dt, 0.0, 10.0, 0.0])
    n = math.ceil(left / abs(dt))
    steps = 8 * math.ceil((math.ceil(1.0625 * n) + 8) / 8)
    want = min(-(-steps // sim.window), sim._batch_size)
    assert sim._batch_steps(70.0 + left) == want
    assert want * sim.window >= max(8, n + 8)
    sim.config.batch_auto = False
    assert sim._batch_steps(70.0 + left) == sim._batch_size


def test_the_early_limit_caps_the_estimate():
    """Before 60 s the estimate's dt is capped at the early limit, as the
    controller caps the step's: a sync's negative dt carries the CFL's."""
    sim = _sim(batch=1 << 14)
    sim._host_carry = np.array([10.0, -2.0, 0.0, 10.0, 0.0])
    n = math.ceil(10.0 / 0.1)
    assert sim._batch_steps(20.0) == 8 * math.ceil((
        math.ceil(1.0625 * n) + 8) / 8)


def test_the_summary_counts_bounded_batches():
    lines = []

    class Log:
        def line(self, msg):
            lines.append(msg)

        def block(self, msg):
            pass

    sim = _sim()
    _run(sim, SYNCS[:2])
    ProgressReporter(Log(), sim).final(1.0)
    assert (f"  Iterations:  {sim.total_steps} (+{sim.total_skipped} idle), "
            f"{sim.batches_bounded} batches bounded by their sync") in lines
    assert sim.batches_bounded > 0
