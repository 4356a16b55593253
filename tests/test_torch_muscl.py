"""The port's MUSCL-Hancock slice against the JAX package, on the CPU, from
the same numpy inputs: the limiter, the MUSCL interface solve, the
predictor and corrector, the whole-grid step (and the numpy oracle), the
split step against ``muscl_step_pallas_split`` run in interpret mode, and
the batch loop against the JAX ``Simulation``.

Tolerances: float64 to rtol = atol = 1e-12 (torch and XLA round exp/log/
sqrt differently by an ulp or so); float32 to rtol 1e-5 / atol 1e-6; the
multi-step compensated split step to the bars of
tests/test_pallas_stencil.py (fields 1e-4/1e-5, z + comp 1e-6).

On CPU tensors every kernel wrapper runs its plain version; the CUDA
kernels are held against those plain versions on the card
(tests/test_torch_cuda.py, skipped without a card, and ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipims_tpu.ops import limiters as j_lim
from hipims_tpu.ops import muscl as j_muscl
from hipims_tpu.ops import riemann as j_riem
from hipims_tpu.ops.godunov import SchemeParams as JParams
from hipims_tpu.ops.oracle_muscl import muscl_step_oracle
from hipims_tpu.ops.pallas.muscl_split import muscl_step_pallas_split
from hipims_tpu.ops.boundaries import UniformBoundary as JUniform
from hipims_tpu.runtime import Simulation as JSimulation
from hipims_tpu.runtime import SimulationConfig as JConfig
from hipims_tpu.state import DomainStatic as JStatic
from hipims_tpu.state import FlowState as JState
from hipims_tpu_torch.ops import limiters, muscl, riemann
from hipims_tpu_torch.ops.boundaries import UniformBoundary
from hipims_tpu_torch.ops.godunov import SchemeParams
from hipims_tpu_torch.ops.kernels import muscl_split as ms
from hipims_tpu_torch.runtime import Simulation, SimulationConfig
from hipims_tpu_torch.state import from_numpy, to_numpy
from tests.test_godunov_oracle import random_domain
from tests.test_torch_simulation import _domains

torch.set_num_threads(1)

TOL = {np.float64: dict(rtol=1e-12, atol=1e-12),
       np.float32: dict(rtol=1e-5, atol=1e-6)}
DTYPES = [np.float64, np.float32]
VS = 1e-10


def _t(a, dtype):
    return torch.as_tensor(np.asarray(a, dtype=dtype))


def _close(got, want, dtype, name=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, err_msg=name, **TOL[dtype])


def _arrays(seed, dtype, rows=16, cols=24):
    return tuple(a.astype(dtype) for a in
                 random_domain(seed, rows=rows, cols=cols))


def _inputs(seed, dtype, rows=16, cols=24):
    z, zmax, qx, qy, zb, n = _arrays(seed, dtype, rows, cols)
    return JState(z, zmax, qx, qy), JStatic(zb, n)


# ---------------------------------------------------------------------------
# Limiter and interface solve.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("beta", [1.0, 1.5])
def test_limited_slope(dtype, beta, monkeypatch):
    """beta = 1 is the MINMOD form the kernels use; another beta takes the
    ratio branch, which both packages keep."""
    monkeypatch.setattr(j_lim, "MINBEE_BETA", beta)
    monkeypatch.setattr(limiters, "MINBEE_BETA", beta)
    rng = np.random.default_rng(0)
    left, center, right = rng.uniform(-1, 1, (3, 200)).astype(dtype)
    right[:20] = center[:20]                  # flat on one side
    left[20:40] = center[20:40]
    want = j_lim.limited_slope(left, center, right)
    got = limiters.limited_slope(*(_t(a, dtype) for a in
                                   (left, center, right)))
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", [0, 1])
def test_slope_vector(dtype, seed):
    z, zmax, qx, qy, zb, n = _arrays(seed, dtype)
    args = [a[:, k:k + 22] for k in range(3) for a in (z, zb, qx, qy)]
    want = j_lim.slope_vector(*args, VS)
    got = limiters.slope_vector(*(_t(a, dtype) for a in args), VS)
    for g, w in zip(got, want):
        _close(g, w, dtype)


def _face_estimates(seed, dtype):
    """Random face estimates on both sides of 600 interfaces, with dry
    faces (h = 0), faces exactly at the threshold (h = vs) and faces just
    above it, beside wet ones."""
    rng = np.random.default_rng(seed)
    shape = (20, 30)
    h_l, h_r = rng.uniform(0.0, 2.0, (2, *shape))
    h_l[rng.random(shape) < 0.2] = 0.0
    h_r[rng.random(shape) < 0.2] = 0.0
    h_l[rng.random(shape) < 0.1] = VS
    h_r[rng.random(shape) < 0.1] = VS
    h_r[rng.random(shape) < 0.05] = 2 * VS
    zb_l, zb_r = rng.uniform(0.0, 3.0, (2, *shape))
    q = rng.uniform(-1.5, 1.5, (6, *shape))
    q[:2, rng.random(shape) < 0.1] = 0.0
    q[:, rng.random(shape) < 0.05] = 1e-7    # f32 stop-guard noise scale
    return tuple(a.astype(dtype) for a in (
        zb_l + h_l, h_l, q[0], q[1], zb_r + h_r, h_r, q[2], q[3],
        q[4], q[5], q[1] * 0.7, q[3] * 1.3))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", [0, 1])
def test_solve_interfaces_muscl(dtype, seed):
    *faces, qal, qar, qcl, qcr = _face_estimates(seed, dtype)
    want = j_riem.solve_interfaces_muscl(*faces, qal, qar, VS,
                                         qcl_cell=qcl, qcr_cell=qcr)
    got = riemann.solve_interfaces_muscl(
        *(_t(a, dtype) for a in faces), _t(qal, dtype), _t(qar, dtype), VS,
        qcl_cell=_t(qcl, dtype), qcr_cell=_t(qcr, dtype))
    assert bool(np.asarray(want.stop_l).any()) and \
        bool(np.asarray(want.stop_r).any())
    for name, g, w in zip(want._fields, got, want):
        _close(g, w, dtype, name)


# ---------------------------------------------------------------------------
# Predictor, corrector, whole-grid step.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", [0, 1])
def test_predictor_base_slopes_and_faces(dtype, seed):
    z, zmax, qx, qy, zb, n = _arrays(seed, dtype)
    dt = np.asarray(0.05, dtype)
    params = SchemeParams(2.0, 2.0)
    want = j_muscl.muscl_predictor_base_slopes(z, zmax, qx, qy, zb, dt,
                                               JParams(2.0, 2.0))
    got = muscl.muscl_predictor_base_slopes(
        *(_t(a, dtype) for a in (z, zmax, qx, qy, zb, dt)), params)
    for g_part, w_part in zip(got, want):
        for g, w in zip(g_part, w_part):
            _close(g, w, dtype)
    want_faces = j_muscl.faces_from_base_slopes(*want)
    got_faces = muscl.faces_from_base_slopes(*got)
    want_interior = j_muscl.muscl_predictor_interior(
        z, zmax, qx, qy, zb, dt, JParams(2.0, 2.0))
    for g_face, w_face, w2 in zip(got_faces, want_faces, want_interior):
        for g, w, w_int in zip(g_face, w_face, w2):
            _close(g, w, dtype)
            _close(g, w_int, dtype)


@pytest.mark.parametrize("dtype,compensated", [(np.float64, False),
                                               (np.float32, False),
                                               (np.float32, True)])
def test_corrector_full(dtype, compensated):
    z, zmax, qx, qy, zb, n = _arrays(3, dtype)
    dt = np.asarray(0.05, dtype)
    base, sx, sy = j_muscl.muscl_predictor_base_slopes(
        z, zmax, qx, qy, zb, dt, JParams(2.0, 2.0))
    # Full-size faces: the interior from the predictor, the ring from the
    # state (the kernels' placeholder convention).
    pad = [np.stack([z, z - zb, qx, qy]) for _ in range(4)]
    for k, face in enumerate(j_muscl.faces_from_base_slopes(base, sx, sy)):
        for c in range(4):
            pad[k][c, 1:-1, 1:-1] = np.asarray(face[c])
    comp = (np.random.default_rng(0).uniform(-1e-7, 1e-7, z.shape)
            .astype(dtype) if compensated else None)
    want = j_muscl.muscl_corrector_full(
        z, zmax, qx, qy, zb, n, [j_muscl.FaceExtrap(*f) for f in pad], dt,
        JParams(2.0, 2.0), comp=comp)
    got = muscl.muscl_corrector_full(
        *(_t(a, dtype) for a in (z, zmax, qx, qy, zb, n)),
        [muscl.FaceExtrap(*torch.as_tensor(f)) for f in pad], _t(dt, dtype),
        SchemeParams(2.0, 2.0),
        comp=None if comp is None else torch.as_tensor(comp))
    assert len(got) == len(want) == (5 if compensated else 4)
    for g, w in zip(got, want):
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("friction_on", [True, False])
def test_muscl_step(dtype, seed, friction_on):
    jstate, jstatic = _inputs(seed, dtype)
    dt = np.asarray(0.05, dtype)
    want = j_muscl.muscl_step(jstate, jstatic, dt,
                              JParams(2.0, 2.0, friction=friction_on))
    got = muscl.muscl_step(from_numpy(jstate, "cpu"),
                           from_numpy(jstatic, "cpu"), _t(dt, dtype),
                           SchemeParams(2.0, 2.0, friction=friction_on))
    for name, g, w in zip(want._fields, got, want):
        _close(g, w, dtype, name)


@pytest.mark.parametrize("dt", [0.05, -0.05])
def test_muscl_step_compensated(dt):
    jstate, jstatic = _inputs(4, np.float32)
    comp = np.random.default_rng(0).uniform(
        -1e-7, 1e-7, jstate.z.shape).astype(np.float32)
    dtv = np.asarray(dt, np.float32)
    want, wcomp = j_muscl.muscl_step(jstate, jstatic, dtv, JParams(2.0, 2.0),
                                     comp=comp)
    got, gcomp = muscl.muscl_step(from_numpy(jstate, "cpu"),
                                  from_numpy(jstatic, "cpu"),
                                  _t(dtv, np.float32), SchemeParams(2.0, 2.0),
                                  comp=torch.as_tensor(comp))
    for name, g, w in zip(want._fields, got, want):
        _close(g, w, np.float32, name)
    np.testing.assert_allclose(
        got.z.double().numpy() + gcomp.double().numpy(),
        np.asarray(want.z, np.float64) + np.asarray(wcomp, np.float64),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("friction_on", [True, False])
def test_muscl_step_matches_oracle(seed, friction_on):
    jstate, jstatic = _inputs(seed, np.float64, rows=14, cols=18)
    want = muscl_step_oracle(*jstate, *jstatic, 0.05, 2.0, 2.0,
                             friction=friction_on)
    got = muscl.muscl_step(from_numpy(jstate, "cpu"),
                           from_numpy(jstatic, "cpu"),
                           torch.tensor(0.05, dtype=torch.float64),
                           SchemeParams(2.0, 2.0, friction=friction_on))
    # The oracle solves every face twice with the per-cell datum shift;
    # the bar of the JAX package's own MUSCL oracle test.
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-9, atol=1e-11)


# ---------------------------------------------------------------------------
# The split step (the kernels' plain versions) against the Pallas split.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["split12", "recompute"])
def test_muscl_step_split_matches_pallas_f64(variant):
    jstate, jstatic = _inputs(6, np.float64, rows=32, cols=128)
    want, want_speed = muscl_step_pallas_split(
        jstate, jstatic, 0.05, JParams(2.0, 2.0), tile_rows=8,
        interpret=True, variant=variant)
    got, speed = ms.muscl_step_split(
        from_numpy(jstate, "cpu"), from_numpy(jstatic, "cpu"),
        torch.tensor(0.05, dtype=torch.float64), SchemeParams(2.0, 2.0),
        variant)
    for g, w, name in zip(got, want, ("z", "zmax", "qx", "qy")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-12, err_msg=name)
    assert speed.dim() == 0
    assert float(speed) == pytest.approx(float(want_speed), rel=1e-12)


@pytest.mark.parametrize("variant", ["split12", "recompute"])
def test_muscl_step_split_matches_pallas_compensated(variant):
    """Three steps of comp accumulation against the Pallas comp plane."""
    jstate, jstatic = _inputs(12, np.float32, rows=32, cols=128)
    dt = np.float32(0.05)
    want, want_comp = jstate, np.zeros_like(jstate.z)
    got = from_numpy(jstate, "cpu")
    static = from_numpy(jstatic, "cpu")
    got_comp = torch.zeros_like(got.z)
    for _ in range(3):
        want, want_speed, want_comp = muscl_step_pallas_split(
            want, jstatic, dt, JParams(2.0, 2.0), tile_rows=8,
            interpret=True, variant=variant, comp=want_comp)
        got, speed, got_comp = ms.muscl_step_split(
            got, static, torch.tensor(dt), SchemeParams(2.0, 2.0), variant,
            comp=got_comp)
    for g, w, name in zip(got, want, ("z", "zmax", "qx", "qy")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    np.testing.assert_allclose(
        got.z.double().numpy() + got_comp.double().numpy(),
        np.asarray(want.z, np.float64) + np.asarray(want_comp, np.float64),
        rtol=1e-6, atol=1e-6)
    assert float(speed) == pytest.approx(float(want_speed), rel=1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
def test_split_variants_equal_and_match_whole_step(dtype):
    """The recompute corrector rebuilds exactly the slopes split12 stores,
    so the two plain variants agree bit for bit; both equal the
    whole-grid step."""
    jstate, jstatic = _inputs(9, dtype, rows=20, cols=28)
    state, static = from_numpy(jstate, "cpu"), from_numpy(jstatic, "cpu")
    dt, params = _t(0.05, dtype), SchemeParams(2.0, 2.0)
    a, sa = ms.muscl_step_split(state, static, dt, params, "split12")
    b, sb = ms.muscl_step_split(state, static, dt, params, "recompute")
    whole = muscl.muscl_step(state, static, dt, params)
    for x, y, w in zip(a, b, whole):
        assert torch.equal(x, y)
        _close(x, w.numpy(), dtype)
    assert torch.equal(sa, sb)


def test_predictor_planes_layout():
    """12 planes (base, sx, sy); the edge ring holds the first-order
    placeholder and zero slopes; the base-only variant is the first 4."""
    jstate, jstatic = _inputs(2, np.float64, rows=10, cols=12)
    state, static = from_numpy(jstate, "cpu"), from_numpy(jstatic, "cpu")
    dt, params = torch.tensor(0.05, dtype=torch.float64), SchemeParams(2, 2)
    pred = ms.muscl_predict(state, static, dt, params)
    base = ms.muscl_predict_base(state, static, dt, params)
    assert pred.shape == (12, 10, 12) and base.shape == (4, 10, 12)
    assert torch.equal(pred[:4], base)
    ring = torch.ones(10, 12, dtype=torch.bool)
    ring[1:-1, 1:-1] = False
    for k, a in enumerate((state.z, state.z - static.zb, state.qx,
                           state.qy)):
        assert torch.equal(pred[k][ring], a[ring])
    assert not pred[4:, ring].any()
    want = j_muscl.muscl_predictor_base_slopes(*jstate, jstatic.zb, 0.05,
                                               JParams(2.0, 2.0))
    for k, w in enumerate(p for part in want for p in part):
        _close(pred[k, 1:-1, 1:-1], w, np.float64)


def test_unknown_variant_raises():
    jstate, jstatic = _inputs(0, np.float64, rows=8, cols=8)
    with pytest.raises(ValueError, match="unknown MUSCL split variant"):
        ms.muscl_step_split(from_numpy(jstate, "cpu"),
                            from_numpy(jstatic, "cpu"),
                            torch.tensor(0.05, dtype=torch.float64),
                            SchemeParams(2.0, 2.0), "split16")


@pytest.mark.parametrize("variant", ["split12", "recompute"])
def test_cpu_path_never_counts_launches(variant):
    jstate, jstatic = _inputs(0, np.float64, rows=8, cols=8)
    before = [k.launches for k in ms.KERNELS]
    ms.muscl_step_split(from_numpy(jstate, "cpu"), from_numpy(jstatic, "cpu"),
                        torch.tensor(0.05, dtype=torch.float64),
                        SchemeParams(2.0, 2.0), variant)
    assert [k.launches for k in ms.KERNELS] == before


# ---------------------------------------------------------------------------
# The batch loop against the JAX Simulation.
# ---------------------------------------------------------------------------

def _sims(dtype, dry_depth, variant):
    jd, pd = _domains(dry_depth=dry_depth)
    series = dict(interval=60.0, length=3600.0)
    cfg = dict(scheme="muscl-hancock", duration=600.0,
               output_frequency=600.0, dtype=dtype, batch_size=64,
               batch_auto=False, muscl_variant=variant)
    jsim = JSimulation(jd, JConfig(**cfg), boundaries=(
        JUniform(values=np.full(61, 100.0), is_loss=False, **series),
        JUniform(values=np.full(61, 20.0), is_loss=True, **series)))
    psim = Simulation(pd, SimulationConfig(**cfg), boundaries=(
        UniformBoundary(values=np.full(61, 100.0), is_loss=False, **series),
        UniformBoundary(values=np.full(61, 20.0), is_loss=True, **series)),
        device="cpu")
    return jsim, psim


@pytest.mark.parametrize("dtype,variant", [("float64", None),
                                           ("float32c", "recompute")])
def test_run_batch_matches_jax(dtype, variant):
    """64 steps of boundaries (rain + loss) -> MUSCL step -> advance, with
    a sync time mid-batch.  float64 rains onto dry ground; float32c starts
    with 0.15 m of water everywhere (rain films amplify the ulp
    differences of any two f32 implementations; tests/test_torch_
    simulation.py)."""
    jsim, psim = _sims(dtype, 0.0 if dtype == "float64" else 0.15, variant)
    assert psim.scheme.radius == 2
    np_dtype = np.float64 if dtype == "float64" else np.float32
    jstate, jcarry, jcomp = jsim._run_batch(
        jsim.state, jsim.carry, jsim.static, jnp.asarray(3.0, np_dtype),
        jsim.comp, n_steps=64)
    state, carry, comp = psim._run_batch(
        psim.state, psim.carry, psim.static,
        torch.tensor(3.0, dtype=psim.dtype), psim.comp, 64)

    assert int(carry.batch_successful) == int(jcarry.batch_successful)
    assert int(carry.batch_skipped) == int(jcarry.batch_skipped) > 0
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
    # The scheme did act: a Godunov run from the same start ends elsewhere.
    _, pd = _domains(dry_depth=0.0 if dtype == "float64" else 0.15)
    gsim = Simulation(pd, SimulationConfig(dtype=dtype, batch_size=64,
                                           batch_auto=False,
                                           duration=600.0), device="cpu")
    god = gsim._run_batch(gsim.state, gsim.carry, gsim.static,
                          torch.tensor(3.0, dtype=psim.dtype), gsim.comp,
                          64)[0]
    assert float((god.qx - state.qx).abs().max()) > 1e-6
