"""The port's Domain.build and single-device batch loop against the JAX
package's, on the CPU, from the same host inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipims_tpu.domain import Domain as JDomain
from hipims_tpu.ops.boundaries import UniformBoundary as JUniform
from hipims_tpu.runtime import Simulation as JSimulation
from hipims_tpu.runtime import SimulationConfig as JConfig
from hipims_tpu_torch.domain import Domain
from hipims_tpu_torch.ops.boundaries import UniformBoundary
from hipims_tpu_torch.runtime import Simulation, SimulationConfig
from hipims_tpu_torch.state import to_numpy

torch.set_num_threads(1)


def _terrain(rows=24, cols=40, seed=0, nodata=True, dry_depth=0.0):
    """Sloping, undulating bed at a real-world datum (~100 m) with 0.6 m
    of water on the western third, ``dry_depth`` elsewhere, and a few
    disabled (NODATA) cells."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:rows, 0:cols]
    zb = (101.3 - 0.02 * xx + 0.4 * np.sin(yy / 3.0) * np.cos(xx / 5.0)
          + rng.uniform(0, 0.05, (rows, cols)))
    if nodata:
        zb[rng.random((rows, cols)) < 0.03] = -9999.0
    depth = np.where(xx < cols // 3, 0.6, dry_depth) * (zb > -9000)
    return zb, depth


def _domains(edges=None, **kw):
    zb, depth = _terrain(**kw)
    out = []
    for cls in (JDomain, Domain):
        d = cls(zb=zb.copy(), manning=0.035, dx=2.0, dy=2.0)
        d.set_initial_depth(depth)
        if edges:
            d.edge_treatment.update(edges)
        out.append(d)
    return out


@pytest.mark.parametrize("dtype,shift", [(np.float64, False),
                                         (np.float32, True)])
@pytest.mark.parametrize("width", [1, 2])
def test_domain_build_matches_jax(dtype, shift, width):
    jd, pd = _domains(edges={"north": "open"})
    jstate, jstatic = jd.build(dtype=dtype, edge_wall_width=width,
                               datum_shift=shift)
    state, static = pd.build(dtype=getattr(torch, np.dtype(dtype).name),
                             device="cpu", edge_wall_width=width,
                             datum_shift=shift)
    assert pd.datum == jd.datum
    assert (pd.datum > 0.0) == shift
    for got, want in ((state, jstate), (static, jstatic)):
        for name, g, w in zip(want._fields, to_numpy(got), want):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    # Walls on the closed edges only, NODATA cells disabled.
    zb = np.asarray(jstatic.zb)
    assert (zb[:width] > 9999.0).all() and (zb[:, -width:] > 9999.0).all()
    assert not (zb[-1, width:-width] > 9999.0).any()
    assert (to_numpy(state).z[pd.active == False] == -9999.0).all()  # noqa


def _sims(dtype, rain=100.0, loss=20.0, dry_depth=0.0):
    jd, pd = _domains(dry_depth=dry_depth)
    series = dict(interval=60.0, length=3600.0)
    cfg = dict(scheme="godunov", duration=600.0, output_frequency=600.0,
               dtype=dtype, batch_size=64, batch_auto=False)
    jsim = JSimulation(jd, JConfig(**cfg), boundaries=(
        JUniform(values=np.full(61, rain), is_loss=False, **series),
        JUniform(values=np.full(61, loss), is_loss=True, **series)))
    psim = Simulation(pd, SimulationConfig(**cfg), boundaries=(
        UniformBoundary(values=np.full(61, rain), is_loss=False, **series),
        UniformBoundary(values=np.full(61, loss), is_loss=True, **series)),
        device="cpu")
    return jsim, psim


@pytest.mark.parametrize("dtype", ["float64", "float32c"])
@pytest.mark.parametrize("sync", [3.0, 300.0])
def test_run_batch_matches_jax(dtype, sync):
    """64 steps of boundaries (rain + loss) -> step -> advance; ``sync``
    3 s lands mid-batch, so the suspended steps are compared too.

    float64 rains onto dry ground.  float32c starts with 0.15 m of water
    everywhere: rain on dry ground makes ~1e-5 m films, where implicit
    friction (h^-7/3) turns the one-ulp difference between XLA's and
    PyTorch's CPU exp/log into discharge differences near 1e-5 within 30
    steps, in either package against any other f32 implementation."""
    jsim, psim = _sims(dtype, dry_depth=0.0 if dtype == "float64" else 0.15)
    np_dtype = np.float64 if dtype == "float64" else np.float32
    jstate, jcarry, jcomp = jsim._run_batch(
        jsim.state, jsim.carry, jsim.static, jnp.asarray(sync, np_dtype),
        jsim.comp, n_steps=64)
    state, carry, comp = psim._run_batch(
        psim.state, psim.carry, psim.static,
        torch.tensor(sync, dtype=psim.dtype), psim.comp, 64)

    assert int(carry.batch_successful) == int(jcarry.batch_successful)
    assert int(carry.batch_skipped) == int(jcarry.batch_skipped)
    assert int(carry.batch_skipped) > 0 if sync == 3.0 else True
    for name in ("t", "dt", "t_hydro", "batch_dt_total"):
        assert float(getattr(carry, name)) == pytest.approx(
            float(getattr(jcarry, name)), rel=1e-12 if dtype == "float64"
            else 1e-6, abs=1e-12), name
    tol = (dict(rtol=1e-10, atol=1e-10) if dtype == "float64"
           else dict(rtol=1e-5, atol=1e-6))
    for name, g, w in zip(jstate._fields, to_numpy(state), jstate):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=name, **tol)
    if dtype == "float32c":
        np.testing.assert_allclose(
            to_numpy(state).z.astype(np.float64) + to_numpy(comp),
            np.asarray(jstate.z, np.float64) + np.asarray(jcomp, np.float64),
            rtol=1e-6, atol=1e-6)
    # The boundaries did force the run: without them it ends elsewhere.
    _, pd = _domains(dry_depth=0.0 if dtype == "float64" else 0.15)
    bsim = Simulation(pd, psim.config, device="cpu")
    bare = bsim._run_batch(bsim.state, bsim.carry, bsim.static,
                           torch.tensor(sync, dtype=psim.dtype), bsim.comp,
                           64)[0]
    assert float((bare.z - state.z).abs().max()) > 1e-5


def test_divergence_raises():
    _, psim = _sims("float64")
    z = psim.state.z.clone()
    z[12, 20] = float("nan")
    psim.state = psim.state._replace(z=z)
    with pytest.raises(RuntimeError, match="diverged"):
        psim.run_to(10.0)


def test_stall_raises():
    jd, pd = _domains()
    cfg = SimulationConfig(duration=60.0, timestep_mode="fixed",
                           fixed_timestep=0.0, batch_size=8)
    sim = Simulation(pd, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="stalled"):
        sim.run_to(10.0)


@pytest.mark.parametrize("kw,err", [
    (dict(mesh=object()), NotImplementedError),
    (dict(config=SimulationConfig(io_mode="stream")), NotImplementedError),
    (dict(config=SimulationConfig(io_mode="auto", io_stream_cells=100)),
     NotImplementedError),
    (dict(config=SimulationConfig(scheme="inertial")),
     NotImplementedError),
    (dict(config=SimulationConfig(forecast_dt_safety=0.5)), ValueError),
])
def test_unported_and_invalid_configs_raise(kw, err):
    _, pd = _domains()
    args = dict(config=SimulationConfig(), device="cpu")
    args.update(kw)
    with pytest.raises(err):
        Simulation(pd, **args)
