"""The port's per-cell timeseries boundary (``CellBoundary``) and its loader
against the JAX package's, on the CPU, from the same numpy inputs:

* ``CellBoundary.apply`` for every depth mode x discharge mode, with and
  without the compensation plane, in float64 to 1e-12 (the cube root is
  ``x ** (1/3)`` in the port and ``cbrt`` in JAX: a few ulps apart);
  cells inside the static ring are listed too and must not be forced;
* ``load_config`` on a small Thamesmead-class breach written by
  tools/bench_e2e.py: the same cells, series and modes as JAX's loader;
* both packages run that breach for 300 steps in float64 and agree
  within the f32c bars (rtol 1e-5, atol 1e-6).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipims_tpu.io.xml_config import load_config as j_load_config
from hipims_tpu.ops import boundaries as JB
from hipims_tpu.ops.godunov import SchemeParams as JParams
from hipims_tpu.state import DomainStatic as JStatic
from hipims_tpu.state import FlowState as JState
from hipims_tpu_torch.io.xml_config import load_config
from hipims_tpu_torch.ops import boundaries as B
from hipims_tpu_torch.ops.godunov import SchemeParams
from hipims_tpu_torch.state import from_numpy, to_numpy
from tests.test_godunov_oracle import random_domain
from tools.bench_e2e import XML, build_thamesmead_class

torch.set_num_threads(1)

F64 = dict(rtol=1e-12, atol=1e-12)
DEPTH_MODES = [B.DEPTH_IGNORE, B.DEPTH_IS_FSL, B.DEPTH_IS_DEPTH,
               B.DEPTH_IS_CRITICAL]
DISCHARGE_MODES = [B.DISCHARGE_IGNORE, B.DISCHARGE_IS_DISCHARGE,
                   B.DISCHARGE_IS_VELOCITY, B.DISCHARGE_IS_VOLUME]
ROWS, COLS = 12, 16
# Interior cells (one listed twice), and cells of the one-cell ring.
CELLS = ([(5, 7), (5, 8), (6, 7), (2, 3), (10, 14), (5, 7)],
         [(0, 4), (11, 9), (3, 0), (7, 15)])


def _series():
    rng = np.random.default_rng(4)
    t = np.arange(5) * 30.0
    return np.stack([t, rng.uniform(0.2, 1.5, 5) + 1.0,
                     rng.uniform(-3.0, 3.0, 5), rng.uniform(-3.0, 3.0, 5)],
                    axis=1)


def test_mode_constants_match_jax():
    for name in ("DEPTH_IGNORE", "DEPTH_IS_FSL", "DEPTH_IS_DEPTH",
                 "DEPTH_IS_CRITICAL", "DISCHARGE_IGNORE",
                 "DISCHARGE_IS_DISCHARGE", "DISCHARGE_IS_VELOCITY",
                 "DISCHARGE_IS_VOLUME"):
        assert getattr(B, name) == getattr(JB, name)


@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("depth_mode,discharge_mode",
                         list(itertools.product(DEPTH_MODES,
                                                DISCHARGE_MODES)))
def test_cell_boundary_matches_jax(depth_mode, discharge_mode, compensated):
    """Mid-interval (linear interpolation), at a record, past the series
    end and with a suspended step (dt <= 0: not live)."""
    z, zmax, qx, qy, zb, n = random_domain(3, rows=ROWS, cols=COLS)
    rr, cc = (np.array(v) for v in zip(*(CELLS[0] + CELLS[1])))
    series = _series()
    kw = dict(series=series, interval=30.0, length=120.0,
              depth_mode=depth_mode, discharge_mode=discharge_mode)
    jb = JB.CellBoundary(rows=rr.astype(np.int32), cols=cc.astype(np.int32),
                         **kw)
    pb = B.CellBoundary(rows=rr, cols=cc, **kw).to("cpu", torch.float64)
    jmask = JB.interior_force_mask((ROWS, COLS), ROWS, COLS, 1)
    mask = B.interior_force_mask((ROWS, COLS), 1, "cpu")
    jparams = JParams(2.0, 3.0, datum=0.5)
    params = SchemeParams(2.0, 3.0, datum=0.5)
    comp0 = (np.random.default_rng(5).uniform(-1e-7, 1e-7, (ROWS, COLS))
             if compensated else None)
    jstate, jstatic = JState(z, zmax, qx, qy), JStatic(zb, n)
    state, static = from_numpy(jstate, "cpu"), from_numpy(jstatic, "cpu")
    # JAX's masked-out entries gather at an out-of-bounds sentinel, which
    # jnp arrays clip (numpy's would raise).
    jstate, jstatic = (type(v)(*map(jnp.asarray, v)) for v in (jstate,
                                                               jstatic))
    changed = False
    for t, dt in ((37.5, 0.07), (60.0, 0.07), (130.0, 0.07), (37.5, -0.07)):
        args = tuple(jnp.asarray(v, np.float64) for v in (t, dt, 0.0))
        targs = tuple(torch.tensor(float(v), dtype=torch.float64)
                      for v in args)
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
        for name, g, w in zip(jstate._fields, to_numpy(got), want):
            np.testing.assert_allclose(g, np.asarray(w), err_msg=name, **F64)
        # Only the listed interior cells may change.
        moved = np.zeros((ROWS, COLS), bool)
        for g, w in zip(to_numpy(got), jstate):
            moved |= g != w
        allowed = np.zeros((ROWS, COLS), bool)
        allowed[tuple(zip(*CELLS[0]))] = True
        assert not (moved & ~allowed).any()
        changed |= moved.any()
        if dt < 0 or t >= 120.0:
            assert not moved.any()
    assert changed or (depth_mode in (B.DEPTH_IGNORE, B.DEPTH_IS_CRITICAL)
                       and discharge_mode == B.DISCHARGE_IGNORE)


def _breach(tmp_path, duration=600.0, precision="double"):
    spec = build_thamesmead_class(str(tmp_path), rows=64, cols=96,
                                  duration=duration, outfreq=duration)
    xml = tmp_path / "model.xml"
    xml.write_text(XML.format(precision=precision, **spec))
    return xml


def test_load_config_matches_jax_on_breach(tmp_path):
    xml = _breach(tmp_path)
    jm, pm = j_load_config(xml), load_config(xml)
    (jb,), (pb,) = jm.boundaries, pm.boundaries
    assert isinstance(pb, B.CellBoundary)
    np.testing.assert_array_equal(pb.rows, np.asarray(jb.rows))
    np.testing.assert_array_equal(pb.cols, np.asarray(jb.cols))
    np.testing.assert_array_equal(pb.series, np.asarray(jb.series))
    assert len(pb.rows) == 32 and (np.asarray(pb.cols) == 1).all()
    for f in ("interval", "length", "depth_mode", "discharge_mode"):
        assert getattr(pb, f) == getattr(jb, f), f
    assert (pb.depth_mode, pb.discharge_mode) == (
        B.DEPTH_IGNORE, B.DISCHARGE_IS_DISCHARGE)
    # "total" discharge is shared among the cells on the host.
    assert pb.series[0, 2] == pytest.approx(400.0 / 32)
    assert pm.config.scheme == jm.config.scheme == "godunov"


def test_cells_in_the_ring_warn(tmp_path, caplog):
    """A breach cell on the west edge (column 0) lies in the static ring:
    the loader says so, and the run never forces it."""
    xml = _breach(tmp_path)
    bdir = tmp_path / "boundaries"
    (bdir / "breach.csv").write_text(
        (bdir / "breach.csv").read_text() + "0.5,64.01\n")
    model = load_config(xml)
    assert "1 cell-boundary cell(s) fall inside" in caplog.text
    assert (np.asarray(model.boundaries[0].cols) == 0).sum() == 1


def test_breach_run_matches_jax(tmp_path):
    """300 steps of the breach in float64 (XML "double" forced to f64 in
    both packages): the fields agree within the f32c bars."""
    xml = _breach(tmp_path)
    jm, pm = j_load_config(xml), load_config(xml)
    for m in (jm, pm):
        m.config.dtype = "float64"
        m.output_targets = []
    jsim, psim = jm.simulation(), pm.simulation(device="cpu")
    jstate, jcarry, _ = jsim._run_batch(
        jsim.state, jsim.carry, jsim.static, jnp.asarray(600.0, np.float64),
        jsim.comp, n_steps=300)
    state, carry, _ = psim._run_batch(
        psim.state, psim.carry, psim.static,
        torch.tensor(600.0, dtype=torch.float64), psim.comp, 300)
    assert int(carry.batch_successful) == int(jcarry.batch_successful) == 300
    assert float(carry.t) == pytest.approx(float(jcarry.t), rel=1e-6)
    for name, g, w in zip(jstate._fields, to_numpy(state), jstate):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    depth = to_numpy(state).z - to_numpy(psim.static).zb
    assert depth[16:48, 1].min() > 0.5       # the breach cells flood
    assert (depth[:, 2:] > 1e-3).sum() > 32  # and water spreads inland
