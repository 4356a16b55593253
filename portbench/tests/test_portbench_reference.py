"""The benchmark's float64 reference (portbench/reference/swe.py) against
the frozen per-cell numpy oracles beside it, and its imports.

Run from the repository root, without the root conftest.py (which sets
up JAX):

    python -m pytest --noconftest -p no:cacheprovider portbench/tests
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.reference import swe
from portbench.reference.oracle import godunov_step_oracle
from portbench.reference.oracle_muscl import muscl_step_oracle

REFERENCE = Path(__file__).resolve().parents[1] / "reference"
FORBIDDEN = {"jax", "jaxlib", "flax", "hipims_tpu", "hipims_tpu_torch",
             "chip_smoke", "kernel_ab", "tools"}


def random_domain(seed, rows, cols, dry_fraction=0.4, disabled_fraction=0.1):
    """An adversarial wet/dry state with disabled cells (the random domain
    of tests/test_godunov_oracle.py, a07496d)."""
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


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("scheme", ["godunov", "muscl-hancock"])
def test_step_matches_oracle(scheme, seed):
    z, zmax, qx, qy, zb, n = random_domain(seed, 13, 17)
    dt, dx = 0.01, 2.0
    oracle = godunov_step_oracle if scheme == "godunov" else muscl_step_oracle
    want = oracle(z, zmax, qx, qy, zb, n, dt, dx, dx)
    step = swe.godunov_step if scheme == "godunov" else swe.muscl_step
    got = step(*(torch.as_tensor(a) for a in (z, zmax, qx, qy, zb, n)),
               torch.tensor(dt, dtype=torch.float64), dx, dx, 1e-10)
    for name, g, w in zip(("z", "zmax", "qx", "qy"), got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-12,
                                   err_msg=name)


def test_idle_step_keeps_state():
    arrs = [torch.as_tensor(a) for a in random_domain(3, 9, 11)]
    for step in (swe.godunov_step, swe.muscl_step):
        out = step(*arrs, torch.tensor(-0.05, dtype=torch.float64), 1.0,
                   1.0, 1e-10)
        for o, a in zip(out, arrs):
            assert torch.equal(o, a)


def test_advance_lands_on_sync_and_suspends():
    f = lambda v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
    c = swe.Carry(f(9.9), f(0.05), f(0.0), torch.tensor(0), torch.tensor(0))
    c = swe.advance(c, f(1.0), f(10.0), 600.0, 2.0, 0.5)
    assert float(c.dt) == pytest.approx(0.05)       # what is left
    c = swe.advance(c, f(1.0), f(10.0), 600.0, 2.0, 0.5)
    assert float(c.t) == 10.0 and float(c.dt) < 0.0
    c = swe.advance(c, f(1.0), f(10.0), 600.0, 2.0, 0.5)
    assert float(c.t) == 10.0 and (int(c.steps), int(c.idle)) == (2, 1)


def _reference_codes_advance(c, speed, sync, end, dx, courant,
                             advance=swe.advance):
    """The time controller as the reference kept its hydrological
    interval before it stopped dropping forcing: reset on an idle step,
    and at ``>``."""
    new = advance(c, speed, sync, end, dx, courant)
    dt_eff = torch.clamp(c.dt, min=0.0)
    return new._replace(t_hydro=torch.where(
        c.t_hydro > swe.TIMESTEP_HYDROLOGICAL, dt_eff, c.t_hydro + dt_eff))


def test_dam_break_reference_is_unchanged(tmp_path, monkeypatch):
    """The dam break has no forcing, so the rule for the hydrological
    interval moves none of its reference's outputs: its states and steps
    at each sync equal those under the rule it replaced, to 1e-12."""
    from portbench import model_dir, spec
    from portbench.reference import model as reference

    bench = spec.benchmark()
    config = spec.config(bench, "malpasset-10m")
    traffic = spec.traffic("dambreak")
    config.update(rows=24, cols=40)
    xml = model_dir.write(tmp_path, config, traffic, 7)
    model = reference.load(xml)
    now = list(reference.run(model, [20.0, 45.0], "cpu", check_every=16))
    monkeypatch.setattr(swe, "advance", _reference_codes_advance)
    before = list(reference.run(model, [20.0, 45.0], "cpu",
                                check_every=16))
    for a, b in zip(now, before):
        assert (a["t"], a["steps"]) == (b["t"], b["steps"])
        for x, y in zip(a["state"], b["state"]):
            np.testing.assert_allclose(x, y, rtol=1e-12, atol=1e-12)


def test_reference_imports_nothing_of_the_program():
    for path in REFERENCE.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = [node.module.split(".")[0]]
            else:
                continue
            assert not FORBIDDEN & set(tops), (path.name, tops)


def test_readings_plant_a_fault_against_the_sound_reference(tmp_path):
    """``readings.py --faults``: the first-order step planted in
    MUSCL-Hancock's place, read against the sound reference of the same
    seed at a tiny size, keeps the water's mass and moves the depths."""
    from portbench import harness, model_dir, readings, spec
    from portbench.reference import model as reference

    sizes = {"rows": 24, "cols": 40, "segment_s": 8.0,
             "output_times_s": [8.0]}
    config = dict(spec.config(spec.benchmark(), "malpasset-10m"), **sizes)
    traffic = dict(spec.traffic("dambreak"), **sizes)
    xml = model_dir.write(tmp_path, config, traffic, 5)
    sound = harness.reference_outputs(reference.load(xml), traffic, ["cpu"])
    got = readings.planted_readings("malpasset-10m.dambreak", 5, "godunov",
                                    sound, "cpu", sizes)
    assert got["state_depth_volume_gap"] < 1e-9
    assert got["raster_depth_gap_mean_m"] > 0.1
