"""The port's partial-inertial scheme (ops/inertial.py and K4's dispatch)
against the JAX package's, on the CPU, from the same numpy inputs:

* ``inertial_step`` against JAX's ``inertial_step`` in float64 to
  rtol = atol = 1e-12 (the port writes depth^(10/3) as one exp/log pair,
  which agrees with ``**`` to a few ulps);
* ``stencil_step("inertial")`` against ``stencil_step_pallas("inertial")``
  in interpret mode: float64 to 1e-12 (speed rel 1e-12), and compensated
  float32 over 4 steps (fields rtol 1e-5 / atol 1e-6, true surface
  z + comp to 1e-6);
* a 64-step batch with rain and loss, port ``Simulation`` against JAX's;
* the CLI on the inertial dam break, port rasters against JAX's;
* a NaN Manning n: both ``run_to`` raise "diverged" at the same time.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipims_tpu.cli import main as jax_main
from hipims_tpu.domain import Domain as JDomain
from hipims_tpu.ops.boundaries import UniformBoundary as JUniform
from hipims_tpu.ops.godunov import SchemeParams as JParams
from hipims_tpu.ops.inertial import inertial_step as j_inertial_step
from hipims_tpu.ops.pallas.stencil import stencil_step_pallas
from hipims_tpu.runtime import Simulation as JSimulation
from hipims_tpu.runtime import SimulationConfig as JConfig
from hipims_tpu.state import DomainStatic as JStatic
from hipims_tpu.state import FlowState as JState
from hipims_tpu_torch.cli import main as torch_main
from hipims_tpu_torch.domain import Domain
from hipims_tpu_torch.io import raster as t_raster
from hipims_tpu_torch.models import get_scheme
from hipims_tpu_torch.ops.boundaries import UniformBoundary
from hipims_tpu_torch.ops.godunov import SchemeParams
from hipims_tpu_torch.ops.inertial import inertial_step
from hipims_tpu_torch.ops.kernels.stencil import KERNELS, stencil_step
from hipims_tpu_torch.runtime import Simulation, SimulationConfig
from hipims_tpu_torch.state import from_numpy, to_numpy
from hipims_tpu_torch.tools.model_builder import build_dam_break
from tests.test_godunov_oracle import random_domain
from tests.test_torch_simulation import _domains, _terrain

torch.set_num_threads(1)

F64 = dict(rtol=1e-12, atol=1e-12)


def _domain(seed, dtype, rows=14, cols=18):
    z, zmax, qx, qy, zb, n = (a.astype(dtype) for a in
                              random_domain(seed, rows=rows, cols=cols))
    return JState(z, zmax, qx, qy), JStatic(zb, n)


def test_scheme_registered():
    sch = get_scheme("inertial")
    assert (sch.name, sch.simplified_speed, sch.radius) == ("inertial",
                                                            True, 1)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dt", [0.05, -0.05])
def test_inertial_step_matches_jax(seed, dt):
    """Seeds as tests/test_inertial.py; dt <= 0 leaves every cell."""
    jstate, jstatic = _domain(seed, np.float64)
    params = dict(dx=2.0, dy=2.0)
    want = j_inertial_step(jstate, jstatic, dt, JParams(**params))
    got = inertial_step(from_numpy(jstate, "cpu"), from_numpy(jstatic, "cpu"),
                        torch.tensor(dt, dtype=torch.float64),
                        SchemeParams(**params))
    for name, g, w in zip(jstate._fields, to_numpy(got), want):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=name, **F64)
    if dt < 0:
        for g, w in zip(to_numpy(got), jstate):
            np.testing.assert_array_equal(g, w)


def test_mismatched_manning_faces():
    """Each cell computes its faces with its own n, so the two cells of a
    face store different discharges where n differs (tests/
    test_inertial.py); a non-square spacing shows the dx-only slopes and
    the dy-only FSL divisor."""
    rows, cols = 8, 8
    zb = np.zeros((rows, cols))
    z = np.full((rows, cols), 1.0)
    z[:, :4] = 2.0
    z[:4, :] += 0.25
    q0 = np.zeros((rows, cols))
    n = np.full((rows, cols), 0.01)
    n[:, 4:] = 0.10
    jstate = JState(z, z.copy(), q0, q0.copy())
    for dx, dy in ((2.0, 2.0), (2.0, 3.0)):
        want = j_inertial_step(jstate, JStatic(zb, n), 0.5, JParams(dx, dy))
        got = inertial_step(from_numpy(jstate, "cpu"),
                            from_numpy(JStatic(zb, n), "cpu"),
                            torch.tensor(0.5, dtype=torch.float64),
                            SchemeParams(dx, dy))
        for name, g, w in zip(jstate._fields, to_numpy(got), want):
            np.testing.assert_allclose(g, np.asarray(w), err_msg=name, **F64)
        assert got.qx[3, 4] != 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_stencil_step_matches_pallas_f64(seed):
    jstate, jstatic = _domain(seed, np.float64, rows=32, cols=128)
    want, want_speed = stencil_step_pallas(
        "inertial", jstate, jstatic, 0.05, JParams(2.0, 2.0),
        simplified_speed=True, tile_rows=8, interpret=True)
    before = [k.launches for k in KERNELS]
    got, speed = stencil_step(
        "inertial", from_numpy(jstate, "cpu"), from_numpy(jstatic, "cpu"),
        torch.tensor(0.05, dtype=torch.float64), SchemeParams(2.0, 2.0),
        simplified_speed=True)
    assert [k.launches for k in KERNELS] == before
    for name, g, w in zip(jstate._fields, to_numpy(got), want):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=name, **F64)
    assert speed.dim() == 0
    assert float(speed) == pytest.approx(float(want_speed), rel=1e-12)


def test_stencil_step_matches_pallas_compensated():
    """Four steps of comp accumulation against the Pallas comp plane."""
    jstate, jstatic = _domain(11, np.float32, rows=32, cols=128)
    dt = np.float32(0.05)
    want, want_comp = jstate, np.zeros_like(jstate.z)
    got = from_numpy(jstate, "cpu")
    static = from_numpy(jstatic, "cpu")
    got_comp = torch.zeros_like(got.z)
    for _ in range(4):
        want, want_speed, want_comp = stencil_step_pallas(
            "inertial", want, jstatic, dt, JParams(2.0, 2.0),
            simplified_speed=True, tile_rows=8, interpret=True,
            comp=want_comp)
        got, speed, got_comp = stencil_step(
            "inertial", got, static, torch.tensor(dt),
            SchemeParams(2.0, 2.0), comp=got_comp, simplified_speed=True)
    for name, g, w in zip(jstate._fields, to_numpy(got), want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    np.testing.assert_allclose(
        got.z.double().numpy() + got_comp.double().numpy(),
        np.asarray(want.z, np.float64) + np.asarray(want_comp, np.float64),
        rtol=1e-6, atol=1e-6)
    assert float(speed) == pytest.approx(float(want_speed), rel=1e-5)


def test_run_batch_matches_jax():
    """64 steps of boundaries (rain + loss) -> inertial step -> advance in
    float64, with the sync time at 3 s, so suspended steps are compared
    too; the fields to 1e-10 (64 steps of round-off)."""
    jd, pd = _domains(dry_depth=0.0)
    series = dict(interval=60.0, length=3600.0)
    cfg = dict(scheme="inertial", duration=600.0, output_frequency=600.0,
               dtype="float64", batch_size=64, batch_auto=False)
    jsim = JSimulation(jd, JConfig(**cfg), boundaries=(
        JUniform(values=np.full(61, 100.0), is_loss=False, **series),
        JUniform(values=np.full(61, 20.0), is_loss=True, **series)))
    psim = Simulation(pd, SimulationConfig(**cfg), boundaries=(
        UniformBoundary(values=np.full(61, 100.0), is_loss=False, **series),
        UniformBoundary(values=np.full(61, 20.0), is_loss=True, **series)),
        device="cpu")
    assert psim.ts_params.simplified_speed
    jstate, jcarry, _ = jsim._run_batch(
        jsim.state, jsim.carry, jsim.static, jnp.asarray(3.0, np.float64),
        jsim.comp, n_steps=64)
    state, carry, _ = psim._run_batch(
        psim.state, psim.carry, psim.static,
        torch.tensor(3.0, dtype=torch.float64), psim.comp, 64)
    assert int(carry.batch_successful) == int(jcarry.batch_successful)
    assert int(carry.batch_skipped) == int(jcarry.batch_skipped) > 0
    for name in ("t", "dt", "t_hydro", "batch_dt_total"):
        assert float(getattr(carry, name)) == pytest.approx(
            float(getattr(jcarry, name)), rel=1e-12, abs=1e-12), name
    for name, g, w in zip(jstate._fields, to_numpy(state), jstate):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-10, atol=1e-10,
                                   err_msg=name)
    # The scheme did act: water moved off the western third.
    assert float(state.qx.abs().max()) > 1e-3


def test_cli_dam_break_matches_jax(tmp_path):
    """``model_builder -t dam-break --scheme inertial`` (a wet start, XML
    "double" = compensated f32) through both CLIs: equal depth rasters at
    the existing CLI tests' bar, and the dam did break."""
    for pkg in ("jax", "torch"):
        build_dam_break(tmp_path / pkg, scheme="inertial")
    assert torch_main(["-c", str(tmp_path / "torch" / "dam-break.xml"), "-q",
                       "--platform", "cpu"]) == 0
    assert jax_main(["-c", str(tmp_path / "jax" / "dam-break.xml"), "-q",
                     "--platform", "cpu"]) == 0
    for t in (10, 20, 30, 40):
        got, want = (t_raster.read_raster(
            tmp_path / pkg / "output" / f"depth_{t}.tif").to_domain_array()
            for pkg in ("torch", "jax"))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    first = got[4]
    assert first[:200].min() < 2.0 - 0.1 and first[200:].max() > 0.2 + 0.1


def test_nan_manning_diverges_as_in_jax():
    """A NaN Manning n in one wet cell of an f64 inertial grid turns that
    cell's surface NaN (its faces carry its n), while its NaN depth stays
    out of the sqrt(g h) CFL speed; the batch's state-sum probe then turns
    the batch statistic NaN, and ``run_to`` raises "diverged" at the end of
    that batch, in the port as in the JAX package, at the same simulated
    time for the same batch size."""
    import re

    zb, depth = _terrain(rows=24, cols=32)
    manning = np.full(zb.shape, 0.035)
    wet = np.argwhere((depth[2:-2, 2:-2] > 0) & (zb[2:-2, 2:-2] > -9000))
    r, c = wet[len(wet) // 2] + 2
    manning[r, c] = np.nan
    cfg = dict(scheme="inertial", duration=600.0, output_frequency=600.0,
               dtype="float64", batch_size=8, batch_auto=False)
    times = {}
    for name, dom_cls, sim_cls, cfg_cls, kw in (
            ("jax", JDomain, JSimulation, JConfig, {}),
            ("torch", Domain, Simulation, SimulationConfig,
             dict(device="cpu"))):
        dom = dom_cls(zb=zb.copy(), manning=manning.copy(), dx=2.0, dy=2.0)
        dom.set_initial_depth(depth)
        sim = sim_cls(dom, cfg_cls(**cfg), **kw)
        with pytest.raises(RuntimeError, match="diverged") as err:
            sim.run_to(60.0)
        times[name] = float(re.search(r"\(t=([^,]+),", str(err.value))[1])
    assert 0.0 < times["torch"] < 60.0
    assert times["torch"] == pytest.approx(times["jax"], rel=1e-12)
