"""Gridded (radar) rain in a cell added by files alone, and the forcing
of the float64 reference, on the CPU.

A one-device radar cell comes out correct against the reference, and
not correct with the program's frame index one record ahead, or with
rain on the ring that the forcing leaves out.  The reference forces
exactly the simulated time: over runs that idle at their syncs, however
many idle steps a batch ends with, and under fixed steps whose
hydrological interval reaches 1 s exactly.  A program whose ``advance``
resets ``t_hydro`` on an idle step drops the forcing that step finds
owed, and a sync in mid-segment shows it as a gap of just that volume,
which the check fails; one that keeps it drops nothing and passes.  Both
rules are planted in the test, so the check is held whichever rule the
program has.

    python -m pytest --noconftest -p no:cacheprovider portbench/tests
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch
from dummy_cells import RADAR, add_cell
from test_portbench_reference import _reference_codes_advance

import hipims_tpu_torch.ops.boundaries as boundaries
import hipims_tpu_torch.runtime.simulation as simulation
from portbench import harness, model_dir, spec
from portbench.reference import model as reference
from portbench.reference import swe

SEED = 2147484001
HOUR_MM = 3_600_000.0


def run(root, workload, seed=SEED):
    """(result, readings) of a one-device run on the CPU."""
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        res = harness.run_cell(workload, seed, 0.0, False, device="cpu",
                               root=root)
    line = next(ln for ln in log.getvalue().splitlines()
                if ln.startswith("readings: "))
    return res, json.loads(line[len("readings: "):])


def _frame_ahead(real):
    def apply(self, state, static, t, dt, t_hydro, params, mask, comp=None):
        return real(self, state, static, t + self.interval, dt, t_hydro,
                    params, mask, comp=comp)
    return apply


def _rain_on_ring(real):
    def apply(self, state, static, t, dt, t_hydro, params, mask, comp=None):
        return real(self, state, static, t, dt, t_hydro, params,
                    torch.ones_like(mask), comp=comp)
    return apply


@pytest.mark.parametrize("fault", [None, "frame_ahead", "rain_on_ring"])
def test_radar_cell(tmp_path, monkeypatch, fault):
    workload = add_cell(tmp_path, "radar", initial="dry", edges="open")
    if fault:
        plant = {"frame_ahead": _frame_ahead,
                 "rain_on_ring": _rain_on_ring}[fault]
        monkeypatch.setattr(boundaries.GriddedBoundary, "apply",
                            plant(boundaries.GriddedBoundary.apply))
    res, _ = run(tmp_path, workload)
    assert res["correct"] == (fault is None), res["compared"]


def _reference_model(tmp_path, **cell):
    """The reference's model and the traffic of a dummy radar cell."""
    workload = add_cell(tmp_path, "radar", initial="dry", **cell)
    bench = spec.benchmark(tmp_path)
    c = spec.cell(bench, workload)
    config = spec.config(bench, c["config"], tmp_path)
    traffic = spec.traffic(c["traffic"], tmp_path)
    xml = model_dir.write(tmp_path / "model", config, traffic, SEED)
    return reference.load(xml), traffic


def _volume(out):
    z, _, _, _, zb = out["state"]
    return float(np.maximum(z - zb, 0.0)[1:-1, 1:-1].sum())


SYNCS = [37.0, 90.0, 123.0, 150.0]


def test_reference_forces_the_simulated_time_over_idle_syncs(tmp_path,
                                                             monkeypatch):
    model, _ = _reference_model(tmp_path, segment_s=150.0,
                                output_times_s=SYNCS)
    applied = []
    real = swe.gridded_forcing

    def counted(z, zmax, zb, mask, frames, rows, cols, interval, t, dt,
                t_hydro):
        if float(t_hydro) >= swe.TIMESTEP_HYDROLOGICAL and float(dt) > 0.0:
            applied.append((float(t), float(t_hydro)))
        return real(z, zmax, zb, mask, frames, rows, cols, interval, t, dt,
                    t_hydro)

    monkeypatch.setattr(swe, "gridded_forcing", counted)
    outs = list(reference.run(model, SYNCS, "cpu", check_every=64))
    # The runs idle at their syncs, and past the early cap steps exceed
    # the hydrological interval.
    assert max(t for t, _ in applied) > 100.0
    assert any(h > 1.5 for _, h in applied)
    assert all(o["t"] == s for o, s in zip(outs, SYNCS))
    total = sum(h for _, h in applied)
    assert total == pytest.approx(applied[-1][0], rel=1e-12)


def test_reference_volume_does_not_depend_on_idle_steps(tmp_path):
    model, _ = _reference_model(tmp_path, segment_s=150.0,
                                output_times_s=SYNCS)
    vols = [_volume(list(reference.run(model, SYNCS, "cpu",
                                       check_every=k))[-1])
            for k in (8, 64)]
    assert vols[0] > 0.0
    assert vols[0] == pytest.approx(vols[1], rel=1e-12)


def _fixed_dt_forcing(dt, advance):
    """(depth forced on one cell at 1 m/s, seconds simulated up to the
    last application) over fixed steps of ``dt`` from t = 60 s (past the
    early cap) through syncs at which three idle steps follow."""
    f64 = dict(dtype=torch.float64)
    z = torch.zeros((3, 3), **f64)
    zmax, zb = z.clone(), z.clone()
    mask = torch.zeros((3, 3), dtype=torch.bool)
    mask[1, 1] = True
    rate = torch.tensor([HOUR_MM], **f64)
    c = swe.Carry(torch.tensor(60.0, **f64), torch.tensor(dt, **f64),
                  torch.tensor(0.0, **f64), torch.tensor(0), torch.tensor(0))
    speed, last = torch.tensor(1.0, **f64), 60.0
    for sync in (61.7, 64.3, 70.0, 73.1):
        s = torch.tensor(sync, **f64)
        # A landing may fall an ulp short of the sync, where it suspends.
        while float(c.t) < sync - 1e-9:
            if float(c.t_hydro) >= 1.0 and float(c.dt) > 0.0:
                last = float(c.t)
            z = swe.uniform_forcing(z, zmax, zb, mask, rate, 1e9, 1e9, False,
                                    c.t, c.dt, c.t_hydro)
            c = advance(c, speed, s, 1e9, 2.0 * dt, 0.5)
        for _ in range(3):
            z = swe.uniform_forcing(z, zmax, zb, mask, rate, 1e9, 1e9, False,
                                    c.t, c.dt, c.t_hydro)
            c = advance(c, speed, s, 1e9, 2.0 * dt, 0.5)
    return float(z[1, 1]), last - 60.0


@pytest.mark.parametrize("dt", [0.25, 0.3, 0.5, 1.0])
def test_reference_forces_fixed_steps_exactly(dt):
    forced, simulated = _fixed_dt_forcing(dt, swe.advance)
    assert simulated > 10.0
    assert forced == pytest.approx(simulated, rel=1e-12)


@pytest.mark.parametrize("dt", [0.25, 0.5, 1.0])
def test_the_reference_codes_rule_misses_the_simulated_time(dt):
    """The control: the rule that the reference code and the program keep
    forces a second time where the interval reaches 1 s exactly, and
    drops what an idle step finds owed."""
    forced, simulated = _fixed_dt_forcing(dt, _reference_codes_advance)
    assert abs(forced - simulated) > 0.2


def _drops(t_hydro, dt_eff):
    """The rule that drops forcing (the reference code's): ``t_hydro``
    reset to the step taken once it is past 1 s, to 0 on an idle step."""
    return torch.where(t_hydro > swe.TIMESTEP_HYDROLOGICAL, dt_eff,
                       t_hydro + dt_eff)


def _keeps(t_hydro, dt_eff):
    """The reference's rule: kept on an idle step, reset at >= 1 s."""
    return torch.where(dt_eff > 0.0, torch.where(
        t_hydro >= swe.TIMESTEP_HYDROLOGICAL, dt_eff, t_hydro + dt_eff),
        t_hydro)


@pytest.mark.parametrize("rule", [_drops, _keeps], ids=["drops", "keeps"])
def test_the_program_drops_forcing_at_a_sync(tmp_path, monkeypatch, rule):
    """A sync at 90 s, where steps exceed the hydrological interval, with
    the program's ``t_hydro`` set by a rule planted here.  Under
    ``drops`` the idle steps after the sync reset ``t_hydro`` and drop
    the forcing owed, which the reference applies at the next step: the
    gap in the water's volume is that forcing, together with what each
    side still owes at the segment's end, and the run is not correct.
    Under ``keeps`` nothing is dropped and the run is correct.  One frame
    rains all through (its record is longer than the segment), so a
    second of forcing is the same volume whenever it falls."""
    steady = dict(RADAR, interval_s=200.0)
    workload = add_cell(tmp_path, "radar", initial="dry", segment_s=150.0,
                        output_times_s=(90.0, 150.0), boundaries=[steady])
    dropped = []
    real = simulation.advance

    def planted(carry, speed, sync, end, dx, ts):
        new = real(carry, speed, sync, end, dx, ts)
        new = new._replace(t_hydro=rule(carry.t_hydro,
                                        torch.clamp(carry.dt, min=0.0)))
        if float(carry.dt) <= 0.0 and float(new.t_hydro) < float(
                carry.t_hydro):
            dropped.append((float(carry.t), float(carry.t_hydro)))
        return new

    monkeypatch.setattr(simulation, "advance", planted)
    # Batches of a fixed 64 steps, so the idle steps do not hang on the
    # machine's speed.
    monkeypatch.setattr(simulation.Simulation, "_adapt_batch",
                        lambda self, elapsed: None)
    # On this seed the step before the sync exceeds the hydrological
    # interval (not on every seed: a landing can fall short of it).
    seed = 2147484002
    res, numbers = run(tmp_path, workload, seed)
    if rule is _keeps:
        assert not dropped
        assert res["correct"], res["compared"]
        return
    # The warm-up segment and the timed one drop the same, at 90 s and at
    # the end.
    assert len(dropped) % 2 == 0 and dropped[:len(dropped) // 2] == \
        dropped[len(dropped) // 2:]
    timed = dropped[len(dropped) // 2:]
    mid = sum(h for t, h in timed if t == 90.0)
    assert mid > 1.0
    tail = numbers["program_t_hydro"] + sum(h for t, h in timed
                                            if t == 150.0)
    bench = spec.benchmark(tmp_path)
    config = spec.config(bench, "dummy-radar", tmp_path)
    frame = model_dir.radar_frames(config, steady, 150.0, seed, 0)[0]
    dx = config["cell_size_m"]
    rows = np.minimum(np.arange(config["rows"]) * dx // 100.0,
                      frame.shape[0] - 1).astype(int)[1:-1]
    cols = np.minimum(np.arange(config["cols"]) * dx // 100.0,
                      frame.shape[1] - 1).astype(int)[1:-1]
    per_second = frame[np.ix_(rows, cols)].sum() / HOUR_MM * dx * dx
    owed = per_second * (mid + tail - numbers["reference_t_hydro"])
    gap = numbers["reference_volume_m3"] - numbers["program_volume_m3"]
    assert gap == pytest.approx(owed, rel=1e-6)
    assert not res["correct"]
