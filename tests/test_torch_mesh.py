"""The port's mesh against the JAX package's, on the CPU: its geometry
(``parallel/mesh.py``, ``halo_pads``, ``device_table``), the mesh options
of the fused steps, and mesh runs of ``Simulation``.

``stencil_step`` (K1, K4) and ``muscl_step_split`` (K3, K5a-C behind
either predictor) with ``origin``, ``logical`` and ``speed_window`` are
held against the JAX package's Pallas kernels in interpret mode with the
same ``origin`` and ``speed_window``, float64, rtol = atol = 1e-12 on the
state and the max speed (tests/test_pallas_stencil.py's bar).  The block
is one that ``supports`` takes (rows a multiple of 8, columns of 128),
and its origin puts the logical ring inside it on its south and east
sides and outside it on its north and west sides.  The TPU kernels leave
the array's own edge ring to the halo (they fill it from stale rows where
it is not on the logical ring), while the port freezes it, so the
comparison covers every cell off that ring: one cell wide, two for the
MUSCL corrector.  On the card the kernels are held against these plain
versions (tests/test_torch_cuda.py, chip_smoke phase 3d).

The mesh runs mirror tests/test_sharding.py: the port's
``Simulation(..., mesh=make_mesh(8, devices=[cpu] * 8))`` against the JAX
package's ``Simulation(..., mesh=make_mesh(8))`` (its XLA backend on the
root conftest's 8 virtual CPU devices) on the same mesh shape and window,
with the bars of the JAX case each mirrors.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from hipims_tpu.ops.godunov import SchemeParams as JParams
from hipims_tpu.ops.pallas.muscl_split import muscl_step_pallas_split
from hipims_tpu.ops.pallas.stencil import stencil_step_pallas
from hipims_tpu.state import DomainStatic as JStatic
from hipims_tpu.parallel import make_mesh as jax_mesh
from hipims_tpu.runtime import Simulation as JSimulation
from hipims_tpu.runtime import SimulationConfig as JConfig
from hipims_tpu.state import FlowState as JState
from hipims_tpu_torch.ops.godunov import SchemeParams
from hipims_tpu_torch.ops.boundaries import interior_force_mask
from hipims_tpu_torch.ops.kernels.muscl_split import muscl_step_split
from hipims_tpu_torch.ops.kernels.stencil import stencil_step
from hipims_tpu_torch.parallel import Mesh, make_mesh
from hipims_tpu_torch.parallel.halo_deep import extend, halo_pads
from hipims_tpu_torch.parallel.mesh import block_geometry, block_spans
from hipims_tpu_torch.runtime import Simulation, SimulationConfig
from hipims_tpu_torch.runtime.progress import device_table
from hipims_tpu_torch.state import from_numpy
from tests.test_godunov_oracle import random_domain
from tests.test_sharding import _deep_dam_domain, _ne_quadrant_rain
from tests.test_simulation import circular_dam_domain
from tests.test_torch_halo_deep import dam, flat, ne_quadrant_rain, rain

torch.set_num_threads(1)
CPU = torch.device("cpu")

# A 24 x 128 block whose [0, 0] is the global cell (-3, 200) of a 100 x
# 320 grid: its first three rows lie outside the grid, its last nine
# columns on or past the grid's east ring; it owns rows 5..18 and
# columns 9..108.
ROWS, COLS = 24, 128
ORIGIN, LOGICAL, WINDOW = (-3, 200), (100, 320), (5, 14, 9, 100)


# ---------------------------------------------------------------------------
# Geometry.
# ---------------------------------------------------------------------------

def test_make_mesh_shapes():
    assert make_mesh(8, devices=[CPU] * 8).devices.shape in ((2, 4), (4, 2))
    m = make_mesh(4, shape=(4, 1), devices=[CPU] * 4)
    assert m.devices.shape == (4, 1) == m.shape
    assert all(d == CPU for d in m.devices.flat)
    assert make_mesh(shape=(2, 2), devices=[CPU] * 4).shape == (2, 2)
    with pytest.raises(ValueError, match="mesh shape"):
        make_mesh(4, shape=(3, 1), devices=[CPU] * 4)
    with pytest.raises(ValueError, match="need 4 devices"):
        make_mesh(4, devices=[CPU] * 3)


def test_make_mesh_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(4)


@pytest.mark.parametrize("rows,cols,shape", [
    (64, 64, (2, 4)), (2944, 3072, (2, 2)), (61, 67, (2, 4)),
    (7, 5, (3, 2)), (96, 128, (2, 1))])
def test_blocks_cover_the_grid_once(rows, cols, shape):
    cover = np.zeros((rows, cols), int)
    spans = block_geometry(rows, cols, shape)
    assert sorted(spans) == [(iy, ix) for iy in range(shape[0])
                             for ix in range(shape[1])]
    for r0, nr, c0, nc in spans.values():
        cover[r0:r0 + nr, c0:c0 + nc] += 1
    assert (cover == 1).all()
    sizes = {n for span in (block_spans(rows, shape[0]),
                            block_spans(cols, shape[1]))
             for n in (max(s for _, s in span) - min(s for _, s in span),)}
    assert sizes <= {0, 1}


def test_halo_pads_and_extend():
    assert halo_pads(1, 1) == (2, 2)
    assert halo_pads(8, 1) == (9, 9)
    assert halo_pads(8, 2) == (17, 17)
    full = torch.arange(30.0).reshape(5, 6)
    ext = extend(full, (0, 3, 3, 3), (2, 2), CPU)
    assert ext.shape == (7, 7)
    # Global rows -2..4 and columns 1..7: the two rows before the grid and
    # the two columns past it are 0, the rest the grid's own cells.
    assert (ext[:2] == 0).all() and (ext[:, 5:] == 0).all()
    assert torch.equal(ext[2:, :5], full[:, 1:6])


def test_device_table_rows():
    sim = SimpleNamespace(
        mesh=make_mesh(shape=(2, 3), devices=[CPU] * 6),
        domain=SimpleNamespace(rows=61, cols=67))
    lines = device_table(sim)
    assert len(lines) == 7 and "block rows" in lines[0]
    assert "(0,0)" in lines[1] and "[     0..    31)" in lines[1]
    assert "[     0..    23)" in lines[1] and f"{31 * 23:>10,}" in lines[1]
    assert "(1,2)" in lines[6] and "[    31..    61)" in lines[6]
    assert "[    45..    67)" in lines[6] and f"{30 * 22:>10,}" in lines[6]
    assert device_table(SimpleNamespace(mesh=None)) == []
    assert isinstance(sim.mesh, Mesh)


# ---------------------------------------------------------------------------
# The kernels' mesh options, against the TPU kernels in interpret mode.
# ---------------------------------------------------------------------------

def _block(seed, dtype=np.float64):
    z, zmax, qx, qy, zb, n = (a.astype(dtype) for a in
                              random_domain(seed, rows=ROWS, cols=COLS))
    return JState(z, zmax, qx, qy), JStatic(zb, n)


def _check(got, want, got_speed, want_speed, edge):
    inner = (slice(edge, -edge), slice(edge, -edge))
    for g, w, name in zip(got, want, ("z", "zmax", "qx", "qy")):
        np.testing.assert_allclose(g.numpy()[inner], np.asarray(w)[inner],
                                   rtol=1e-12, atol=1e-12, err_msg=name)
    assert float(got_speed) == pytest.approx(float(want_speed), rel=1e-12)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("scheme", ["godunov", "inertial"])
def test_stencil_step_mesh_options_match_pallas(scheme, seed):
    jstate, jstatic = _block(seed)
    simple = scheme == "inertial"
    want, want_speed = stencil_step_pallas(
        scheme, jstate, jstatic, 0.05, JParams(2.0, 2.0), simple, 8, True,
        *LOGICAL, None, WINDOW, np.asarray([ORIGIN]))
    state = from_numpy(jstate, "cpu")
    got, speed = stencil_step(
        scheme, state, from_numpy(jstatic, "cpu"),
        torch.tensor(0.05, dtype=torch.float64), SchemeParams(2.0, 2.0),
        simplified_speed=simple, origin=ORIGIN, logical=LOGICAL,
        speed_window=WINDOW)
    _check(got, want, speed, want_speed, 1)
    # The logical ring (rows 0..3 are outside or on it; columns 119.. on
    # it) keeps its values, the array's own ring too.
    for g, s in zip(got, state):
        assert torch.equal(g[:4], s[:4]) and torch.equal(g[:, 119:],
                                                         s[:, 119:])
        assert torch.equal(g[-1], s[-1]) and torch.equal(g[:, 0], s[:, 0])


@pytest.mark.parametrize("variant", ["split12", "recompute"])
def test_muscl_step_split_mesh_options_match_pallas(variant):
    jstate, jstatic = _block(2)
    want, want_speed = muscl_step_pallas_split(
        jstate, jstatic, 0.05, JParams(2.0, 2.0), 8, True, *LOGICAL,
        variant, None, WINDOW, np.asarray([ORIGIN]))
    state = from_numpy(jstate, "cpu")
    got, speed = muscl_step_split(
        state, from_numpy(jstatic, "cpu"),
        torch.tensor(0.05, dtype=torch.float64), SchemeParams(2.0, 2.0),
        variant, origin=ORIGIN, logical=LOGICAL, speed_window=WINDOW)
    _check(got, want, speed, want_speed, 2)
    # The two-cell logical ring: rows 0..4 (global -3..1), columns 118..
    for g, s in zip(got, state):
        assert torch.equal(g[:5], s[:5]) and torch.equal(g[:, 118:],
                                                         s[:, 118:])


@pytest.mark.parametrize("scheme", ["godunov", "inertial", "muscl-split"])
def test_mesh_options_compensated_ring_and_defaults(scheme):
    """f32c: comp keeps its values on the logical ring, as the state does;
    the one-device defaults, given outright, change nothing."""
    jstate, jstatic = _block(4, np.float32)
    state, static = from_numpy(jstate, "cpu"), from_numpy(jstatic, "cpu")
    comp = torch.as_tensor(np.random.default_rng(1).uniform(
        -1e-7, 1e-7, (ROWS, COLS)).astype(np.float32))
    dt, params = torch.tensor(0.05), SchemeParams(2.0, 2.0)

    def step(**mesh):
        if scheme == "muscl-split":
            return muscl_step_split(state, static, dt, params, None, comp,
                                    **mesh)
        return stencil_step(scheme, state, static, dt, params, comp=comp,
                            simplified_speed=scheme == "inertial", **mesh)

    got = step(origin=ORIGIN, logical=LOGICAL, speed_window=WINDOW)
    ring = ~interior_force_mask((ROWS, COLS),
                                2 if scheme == "muscl-split" else 1, CPU,
                                ORIGIN, LOGICAL)
    assert torch.equal(got[2][ring], comp[ring])
    assert not torch.equal(got[2][~ring], comp[~ring])
    plain, defaults = step(), step(origin=(0, 0), logical=(ROWS, COLS),
                                   speed_window=(0, ROWS, 0, COLS))
    for a, b in zip((*plain[0], plain[1], plain[2]),
                    (*defaults[0], defaults[1], defaults[2])):
        assert torch.equal(a, b)


def test_mesh_options_checked():
    jstate, jstatic = _block(0)
    state, static = from_numpy(jstate, "cpu"), from_numpy(jstatic, "cpu")
    dt = torch.tensor(0.05, dtype=torch.float64)
    with pytest.raises(ValueError, match="speed_window"):
        stencil_step("godunov", state, static, dt, SchemeParams(2.0, 2.0),
                     origin=ORIGIN, logical=LOGICAL,
                     speed_window=(20, 10, 0, 128))
    with pytest.raises(ValueError, match="no mesh path"):
        stencil_step("muscl-hancock", state, static, dt,
                     SchemeParams(2.0, 2.0), origin=ORIGIN)


# ---------------------------------------------------------------------------
# Mesh runs against the JAX package's (tests/test_sharding.py).
# ---------------------------------------------------------------------------

def _mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax_mesh(8)


def _pair(jdomain, tdomain, jb=(), tb=(), jmesh="8", tmesh=8, **cfg):
    """The same run in both packages: the JAX one on ``jmesh`` ("8", "1"
    or None) and the port's on a CPU mesh of ``tmesh`` blocks (or one
    device).  Returns (jax_sim, port_sim)."""
    meshes = {"8": _mesh8, "1": lambda: jax_mesh(1), None: lambda: None}
    j = JSimulation(jdomain, JConfig(**cfg), boundaries=jb,
                    mesh=meshes[jmesh]())
    j.run()
    t = Simulation(tdomain, SimulationConfig(**cfg), boundaries=tb,
                   device=None if tmesh else CPU,
                   mesh=make_mesh(tmesh, devices=[CPU] * tmesh)
                   if tmesh else None)
    t.run()
    if tmesh and jmesh:
        assert t.mesh.shape == j.mesh.devices.shape
    return j, t


def _close(j, t, rtol, atol, t_abs=1e-9):
    assert t.t == pytest.approx(j.t, abs=t_abs)
    for a, b, name in zip(j.state, t.state, ("z", "zmax", "qx", "qy")):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=rtol,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("scheme", ["godunov", "muscl-hancock", "inertial"])
def test_sharded_matches_jax_mesh(scheme):
    """test_sharded_matches_single_device: lock-step, one exchange per
    step (the JAX package's per-step GSPMD halos)."""
    j, t = _pair(circular_dam_domain(64), dam(), scheme=scheme,
                 duration=3.0, output_frequency=3.0, friction=True,
                 batch_size=8, batch_auto=False)
    _close(j, t, 1e-7, 5e-9)


@pytest.mark.parametrize("scheme", ["godunov", "muscl-hancock"])
def test_forecast_halo_deep_matches_jax(scheme):
    """test_forecast_halo_deep_matches_timestep: forecast windows of 5."""
    j, t = _pair(circular_dam_domain(64), dam(), scheme=scheme,
                 duration=3.0, output_frequency=3.0, friction=True,
                 batch_size=4, batch_auto=False, sync_method="forecast",
                 forecast_window=5)
    assert t.window == 5
    _close(j, t, 1e-7, 5e-9)


@pytest.mark.parametrize("sync,window", [("timestep", 1), ("forecast", 4)])
def test_gridded_rain_mesh_matches_jax(sync, window):
    """test_gridded_rain_mesh_xla: NE-quadrant radar rain, 1e-12."""
    n = 64
    from hipims_tpu.domain import Domain as JDomain
    jdom = JDomain(zb=np.zeros((n, n)), manning=0.03, dx=2.0, dy=2.0)
    jdom.set_initial_depth(0.0)
    j, t = _pair(jdom, flat(n), (_ne_quadrant_rain(n, 2.0),),
                 (ne_quadrant_rain(n),), scheme="godunov", duration=30.0,
                 output_frequency=30.0, batch_size=8, batch_auto=False,
                 sync_method=sync, forecast_window=window)
    assert t.volume() > 0.0
    assert t.volume() == pytest.approx(j.volume(), rel=1e-12)
    _close(j, t, 1e-12, 1e-12)
    d = t.depth()
    assert d[n // 2:, n // 2:].sum() > 0.98 * d.sum() > 0.0


def _deep(n=64):
    return dam(n, h_in=25.0, h_out=5.0, manning=0.02)


@pytest.mark.parametrize("scheme", ["godunov", "muscl-hancock"])
def test_forecast_window_dt_matches_jax_and_differs_from_lock_step(scheme):
    """test_forecast_window_dt_deterministic_across_mesh: the frozen-speed
    windows (deep water, so the CFL dt binds below the early clamp) on 8
    blocks match the JAX package's, and differ from lock-step (the case
    is not vacuous), with the same volume."""
    kw = dict(scheme=scheme, duration=3.0, output_frequency=3.0,
              batch_size=4, batch_auto=False, sync_method="forecast",
              forecast_window=4)
    j, t = _pair(_deep_dam_domain(64), _deep(), forecast_dt="window", **kw)
    _close(j, t, 1e-7, 5e-9)
    lock = Simulation(_deep(), SimulationConfig(forecast_dt="step", **kw),
                      mesh=make_mesh(8, devices=[CPU] * 8))
    lock.run()
    dz = (lock.state.z - t.state.z).abs()
    assert float(dz.max()) > 1e-9
    assert float(dz.mean()) < 0.03 and float(dz.max()) < 0.3
    assert t.volume() == pytest.approx(j.volume(), rel=1e-12)
    assert t.volume() == pytest.approx(lock.volume(), rel=1e-9)


def test_forecast_window_rollback_from_dry_matches_jax():
    """test_forecast_window_rollback_from_dry: heavy rain on a dry domain
    starts every batch at frozen speed 0, so windows re-run."""
    from hipims_tpu.domain import Domain as JDomain
    from hipims_tpu.ops.boundaries import UniformBoundary as JUniform
    jdom = JDomain(zb=np.zeros((48, 48)), manning=0.03, dx=2.0, dy=2.0)
    jdom.set_initial_depth(0.0)
    jrain = JUniform(values=np.full(10, 3600.0), interval=600.0,
                     length=6000.0, is_loss=False)
    j, t = _pair(jdom, flat(48), (jrain,), (rain(3600.0),),
                 scheme="godunov", duration=30.0, output_frequency=30.0,
                 batch_size=4, batch_auto=False, sync_method="forecast",
                 forecast_window=4, forecast_dt="window")
    assert t.window_reruns > 0
    _close(j, t, 1e-9, 2e-9)
    assert t.volume() > 0.0
    assert t.volume() == pytest.approx(j.volume(), rel=1e-9)


def test_forecast_window_fixed_dt_not_clamped_matches_jax():
    """test_forecast_window_fixed_dt_not_clamped: a fixed dt is neither
    validated nor clamped; the mesh run matches the one-device run."""
    j, t = _pair(_deep_dam_domain(64), _deep(), jmesh=None,
                 scheme="godunov", duration=3.0, output_frequency=3.0,
                 batch_size=4, batch_auto=False, timestep_mode="fixed",
                 fixed_timestep=0.02, sync_method="forecast",
                 forecast_window=4)
    assert abs(float(t.carry.dt)) == pytest.approx(0.02, abs=1e-12)
    assert t.window_reruns == 0
    _close(j, t, 1e-7, 5e-9)


def test_forecast_window_strict_safety_churn_matches_jax():
    """test_forecast_window_strict_safety_rollback_churn: a margin of 1.0
    re-runs every window whose speed grew; the physics matches the JAX
    package's strict run and the port's default margin, and a margin
    below 1 is refused."""
    kw = dict(scheme="godunov", duration=3.0, output_frequency=3.0,
              batch_size=4, batch_auto=False, sync_method="forecast",
              forecast_window=4)
    j, strict = _pair(_deep_dam_domain(64), _deep(), forecast_dt_safety=1.0,
                      **kw)
    _close(j, strict, 1e-7, 5e-9)
    assert strict.window_reruns > 0
    default = Simulation(_deep(), SimulationConfig(**kw),
                         mesh=make_mesh(8, devices=[CPU] * 8))
    default.run()
    assert strict.t == pytest.approx(default.t, abs=1e-9)
    assert bool(torch.isfinite(strict.state.z).all())
    assert strict.volume() == pytest.approx(default.volume(), rel=1e-12)
    assert float((strict.state.z - default.state.z).abs().mean()) < 0.03
    with pytest.raises(ValueError, match="forecast_dt_safety"):
        Simulation(_deep(), SimulationConfig(forecast_dt_safety=0.9),
                   mesh=make_mesh(8, devices=[CPU] * 8))
