"""The port's gridded (radar) boundary and its loader against the JAX
package's, on the CPU, from the same numpy inputs:

* ``GriddedBoundary.apply`` in both ``mass_flux`` modes, with and without
  the compensation plane, before the series, inside it, past its
  ``length`` and with a suspended step: float64 to 1e-12, and in f32c the
  true surface z + comp to 1e-6;
* ``_parse_gridded`` through ``load_config``: the frames, interval,
  offsets, length, and the warning at a missing frame;
* a 64-step batch of gridded rain + uniform loss against JAX's within the
  bars of the uniform-rain batch test (tests/test_torch_simulation.py).
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipims_tpu.io.xml_config import load_config as j_load_config
from hipims_tpu.ops import boundaries as JB
from hipims_tpu.ops.godunov import SchemeParams as JParams
from hipims_tpu.runtime import Simulation as JSimulation
from hipims_tpu.runtime import SimulationConfig as JConfig
from hipims_tpu.state import DomainStatic as JStatic
from hipims_tpu.state import FlowState as JState
from hipims_tpu_torch.domain import Domain
from hipims_tpu_torch.io.raster import Raster, write_raster
from hipims_tpu_torch.io.xml_config import load_config
from hipims_tpu_torch.ops import boundaries as B
from hipims_tpu_torch.ops.godunov import SchemeParams
from hipims_tpu_torch.runtime import Simulation, SimulationConfig
from hipims_tpu_torch.state import from_numpy, to_numpy
from tests.test_godunov_oracle import random_domain
from tests.test_torch_simulation import _domains

torch.set_num_threads(1)

F64 = dict(rtol=1e-12, atol=1e-12)
ROWS, COLS, DX = 24, 20, 2.0
# Frames on a 5 m grid that starts 3 m west and 4 m north of the domain's
# corner: some domain cells fall off its edges and clamp.
GRID = dict(interval=30.0, resolution=5.0, offset_x=-3.0, offset_y=4.0,
            length=90.0)


def _frames(seed=6, t=4, rows=9, cols=8):
    return np.random.default_rng(seed).uniform(6.0, 80.0, (t, rows, cols))


def _pair(mass_flux):
    series = _frames()
    jb = JB.GriddedBoundary(series=jnp.asarray(series), mass_flux=mass_flux,
                            **GRID)
    pb = B.GriddedBoundary(series=series, mass_flux=mass_flux, **GRID)
    return jb, pb


# (t, dt, t_hydro): inside the first and third frames, at a frame's first
# second, past ``length``, a suspended step, and a hydrological
# accumulator below its threshold (not live).
CASES = ((12.5, 0.3, 1.2), (60.0, 0.3, 1.5), (75.25, 0.3, 2.0),
         (95.0, 0.3, 1.2), (12.5, -0.3, 1.2), (12.5, 0.3, 0.4))


@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("mass_flux", [False, True])
def test_gridded_boundary_matches_jax(mass_flux, compensated):
    z, zmax, qx, qy, zb, n = random_domain(3, rows=ROWS, cols=COLS)
    jb, pb = _pair(mass_flux)
    pb = pb.to("cpu", torch.float64,
               Domain(zb=zb, manning=n, dx=DX, dy=DX))
    jmask = JB.interior_force_mask((ROWS, COLS), ROWS, COLS, 1)
    mask = B.interior_force_mask((ROWS, COLS), 1, "cpu")
    jparams, params = JParams(DX, DX), SchemeParams(DX, DX)
    comp0 = (np.random.default_rng(5).uniform(-1e-7, 1e-7, (ROWS, COLS))
             if compensated else None)
    jstate, jstatic = JState(z, zmax, qx, qy), JStatic(zb, n)
    state, static = from_numpy(jstate, "cpu"), from_numpy(jstatic, "cpu")
    for t, dt, th in CASES:
        args = tuple(jnp.asarray(v, np.float64) for v in (t, dt, th))
        targs = tuple(torch.tensor(v, dtype=torch.float64)
                      for v in (t, dt, th))
        if compensated:
            want, want_comp = jb.apply(jstate, jstatic, *args, jparams,
                                       comp=jnp.asarray(comp0), mask=jmask)
            got, got_comp = pb.apply(state, static, *targs, params, mask,
                                     comp=torch.as_tensor(comp0))
            np.testing.assert_allclose(got_comp.numpy(),
                                       np.asarray(want_comp), **F64)
        else:
            want = jb.apply(jstate, jstatic, *args, jparams, mask=jmask)
            got = pb.apply(state, static, *targs, params, mask)
        np.testing.assert_allclose(got.z.numpy(), np.asarray(want.z), **F64)
        moved = got.z.numpy() != z
        live = t < GRID["length"] and dt > 0 and th >= 1.0
        assert moved.any() == live
        # Only enabled cells off the static ring are forced.
        assert not moved[[0, -1], :].any() and not moved[:, [0, -1]].any()
        assert not moved[zmax <= -9999.0].any()


@pytest.mark.parametrize("mass_flux", [False, True])
def test_gridded_boundary_f32c_true_surface(mass_flux):
    """f32c: the true surface z + comp after 20 forced steps agrees with
    JAX's to 1e-6 (the visible z carries the datum-free f32 rounding)."""
    z, zmax, qx, qy, zb, n = random_domain(7, rows=ROWS, cols=COLS)
    f32 = [np.asarray(a, np.float32) for a in (z, zmax, qx, qy, zb, n)]
    jb, pb = _pair(mass_flux)
    pb = pb.to("cpu", torch.float32, Domain(zb=zb, manning=n, dx=DX, dy=DX))
    jmask = JB.interior_force_mask((ROWS, COLS), ROWS, COLS, 1)
    mask = B.interior_force_mask((ROWS, COLS), 1, "cpu")
    jstate, jstatic = JState(*map(jnp.asarray, f32[:4])), \
        JStatic(*map(jnp.asarray, f32[4:]))
    state, static = from_numpy(JState(*f32[:4]), "cpu"), \
        from_numpy(JStatic(*f32[4:]), "cpu")
    jcomp = jnp.zeros((ROWS, COLS), jnp.float32)
    comp = torch.zeros((ROWS, COLS), dtype=torch.float32)
    for k in range(20):
        t, dt, th = 4.0 * k + 0.5, 0.3, 1.0 + 0.01 * k
        jstate, jcomp = jb.apply(
            jstate, jstatic, *(jnp.asarray(v, jnp.float32)
                               for v in (t, dt, th)),
            JParams(DX, DX), comp=jcomp, mask=jmask)
        state, comp = pb.apply(
            state, static, *(torch.tensor(v, dtype=torch.float32)
                             for v in (t, dt, th)),
            SchemeParams(DX, DX), mask, comp=comp)
    np.testing.assert_allclose(
        state.z.numpy().astype(np.float64) + comp.numpy(),
        np.asarray(jstate.z, np.float64) + np.asarray(jcomp, np.float64),
        rtol=1e-6, atol=1e-6)
    assert float((state.z - torch.as_tensor(f32[0])).abs().max()) > 1e-4


def test_cell_index_is_built_once_in_float64():
    """The cell-to-grid map is floor(((ox + j) dx - offset_x) /
    resolution), clipped, computed in float64 on the host: at 2 m and
    grid lines every 1000 m, the cells on either side of a line land on
    either side of it (f32 arithmetic at j dx ~ 6000 m could flip)."""
    cols = 3072
    domain = Domain(zb=np.zeros((4, cols)), manning=0.0, dx=2.0, dy=2.0)
    b = B.GriddedBoundary(series=np.zeros((1, 1, 7)), interval=300.0,
                          resolution=1000.0, offset_x=0.0, offset_y=0.0,
                          mass_flux=False).to("cpu", torch.float32, domain)
    ci = b.cell_index.view(4, cols)[0].numpy()
    assert b.cell_index.dtype == torch.int64
    for line in range(1, 7):
        j = line * 500                       # (j * 2 m) = line * 1000 m
        assert (ci[j - 1], ci[j]) == (line - 1, line)
    assert ci[-1] == 6


def _radar_model(tmp_path, frames, drop=None, duration=90.0):
    """A 20x24-cell model at 2 m under radar frames every 30 s on a 4 m
    grid; frame ``drop`` is missing on disk."""
    (tmp_path / "bdy").mkdir(parents=True, exist_ok=True)
    write_raster(tmp_path / "dem.asc", Raster(
        np.random.default_rng(1).uniform(0.0, 0.3, (20, 24)), xll=100.0,
        yll=200.0, cell_size=2.0))
    for i, frame in enumerate(frames):
        if i != drop:
            write_raster(tmp_path / "bdy" / f"radar_00{i * 30 // 60:02d}"
                         f"{i * 30 % 60:02d}.tif",
                         Raster(frame, xll=98.0, yll=202.0, cell_size=4.0))
    (tmp_path / "m.xml").write_text(f"""<?xml version="1.0"?>
    <configuration><metadata><name>Radar</name></metadata>
    <simulation>
      <parameter name="duration" value="{duration}" />
      <parameter name="outputFrequency" value="{duration}" />
      <parameter name="floatingPointPrecision" value="double-strict" />
      <parameter name="realStart" value="2000/01/01 00h00m00s"
                 format="%Y/%m/%d %Hh%Mm%Ss" />
      <domainSet><domain type="cartesian">
        <data sourceDir="." targetDir="out/">
          <dataSource type="constant" value="depth" source="0.0" />
          <dataSource type="constant" value="manningCoefficient"
                      source="0.03" />
          <dataSource type="raster" value="structure,dem" source="dem.asc"/>
        </data>
        <scheme name="Godunov" />
        <boundaryConditions sourceDir="bdy/">
          <timeseries type="gridded" name="Radar" value="rain-intensity"
                      mask="radar_%H%M%S.tif" interval="30" />
        </boundaryConditions>
      </domain></domainSet></simulation></configuration>""")
    return tmp_path / "m.xml"


@pytest.mark.parametrize("drop", [None, 2])
def test_parse_gridded_matches_jax(tmp_path, caplog, drop):
    """Frames read from a strftime mask at realStart + k interval, flipped
    to domain orientation; the series stops at the first missing frame
    with one warning, in both packages."""
    frames = _frames(seed=2, t=4, rows=12, cols=14).astype(np.float32)
    xml = _radar_model(tmp_path, frames, drop=drop)
    with caplog.at_level(logging.WARNING):
        (jb,) = j_load_config(xml).boundaries
        (pb,) = load_config(xml).boundaries
    msgs = [r.message for r in caplog.records if "gridded frame" in r.message]
    assert len(msgs) == (2 if drop is not None else 0)
    if drop is not None:
        assert msgs[0] == msgs[1] and "radar_000100.tif" in msgs[0]
    assert isinstance(pb, B.GriddedBoundary)
    np.testing.assert_array_equal(pb.series, np.asarray(jb.series))
    kept = 4 if drop is None else drop
    np.testing.assert_array_equal(pb.series, frames[:kept, ::-1, :])
    for f in ("interval", "resolution", "offset_x", "offset_y", "mass_flux",
              "length"):
        assert getattr(pb, f) == getattr(jb, f), f
    assert (pb.offset_x, pb.offset_y, pb.length) == (-2.0, 2.0,
                                                     30.0 * kept)


def test_gridded_rain_batch_matches_jax():
    """64 steps of gridded rain + uniform loss -> step -> advance, in
    float64 on dry ground, against JAX's batch: the bars of
    test_run_batch_matches_jax."""
    jd, pd = _domains(dry_depth=0.0)
    frames = _frames(seed=9, t=3, rows=7, cols=11)
    grid = dict(interval=2.0, resolution=8.0, offset_x=-1.0, offset_y=2.5,
                mass_flux=False, length=6.0)
    loss = dict(values=np.full(61, 20.0), interval=60.0, length=3600.0,
                is_loss=True)
    cfg = dict(scheme="godunov", duration=600.0, output_frequency=600.0,
               dtype="float64", batch_size=64, batch_auto=False)
    jsim = JSimulation(jd, JConfig(**cfg), boundaries=(
        JB.GriddedBoundary(series=jnp.asarray(frames), **grid),
        JB.UniformBoundary(**loss)))
    psim = Simulation(pd, SimulationConfig(**cfg), boundaries=(
        B.GriddedBoundary(series=frames, **grid),
        B.UniformBoundary(**loss)), device="cpu")
    jstate, jcarry, _ = jsim._run_batch(
        jsim.state, jsim.carry, jsim.static, jnp.asarray(300.0), None,
        n_steps=64)
    state, carry, _ = psim._run_batch(
        psim.state, psim.carry, psim.static,
        torch.tensor(300.0, dtype=torch.float64), None, 64)
    assert int(carry.batch_successful) == int(jcarry.batch_successful) == 64
    for name in ("t", "dt", "t_hydro", "batch_dt_total"):
        assert float(getattr(carry, name)) == pytest.approx(
            float(getattr(jcarry, name)), rel=1e-12, abs=1e-12), name
    for name, g, w in zip(jstate._fields, to_numpy(state), jstate):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=name,
                                   rtol=1e-10, atol=1e-10)
    # Rain fell past the first frame's seconds and stopped at the length.
    assert float(carry.t) > grid["length"]
    assert float((state.z - psim.state.z).abs().max()) > 1e-5
