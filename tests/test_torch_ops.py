"""hipims_tpu_torch operators against their JAX counterparts (and the numpy
oracle), on the CPU, from the same numpy inputs.

Tolerances: float64 to rtol = atol = 1e-12 (torch and XLA round exp/log/
sqrt differently by an ulp or so); float32 to rtol 1e-5 / atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipims_tpu.ops import compensated as j_comp
from hipims_tpu.ops import friction as j_fric
from hipims_tpu.ops import godunov as j_god
from hipims_tpu.ops import riemann as j_riem
from hipims_tpu.ops import timestep as j_ts
from hipims_tpu.ops.oracle import godunov_step_oracle
from hipims_tpu.state import DomainStatic as JStatic
from hipims_tpu.state import FlowState as JState
from hipims_tpu.state import StepCarry as JCarry
from hipims_tpu_torch.ops import compensated, friction, godunov, riemann
from hipims_tpu_torch.ops import timestep
from hipims_tpu_torch.state import from_numpy
from tests.test_godunov_oracle import random_domain

torch.set_num_threads(1)

TOL = {np.float64: dict(rtol=1e-12, atol=1e-12),
       np.float32: dict(rtol=1e-5, atol=1e-6)}
DTYPES = [np.float64, np.float32]


def _t(a, dtype):
    return torch.as_tensor(np.asarray(a, dtype=dtype))


def _close(got, want, dtype, name=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, err_msg=name, **TOL[dtype])


def _interfaces(seed, dtype):
    """x-axis interfaces of a random wet/dry domain (left/right cells)."""
    z, zmax, qx, qy, zb, n = (a.astype(dtype) for a in
                              random_domain(seed, rows=16, cols=40))
    return (z[:, :-1], zb[:, :-1], qx[:, :-1], qy[:, :-1],
            z[:, 1:], zb[:, 1:], qx[:, 1:], qy[:, 1:])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", [0, 1])
def test_solve_interfaces(dtype, seed):
    args = _interfaces(seed, dtype)
    want = j_riem.solve_interfaces(*args, very_small=1e-10)
    got = riemann.solve_interfaces(*(_t(a, dtype) for a in args),
                                   very_small=1e-10)
    for name, g, w in zip(want._fields, got, want):
        _close(g, w, dtype, name)


@pytest.mark.parametrize("dtype", DTYPES)
def test_local_datum(dtype):
    rng = np.random.default_rng(3)
    zc, zbm = rng.uniform(-2, 5, (2, 8, 9)).astype(dtype)
    for g, w in zip(riemann.local_datum(_t(zc, dtype), _t(zbm, dtype)),
                    j_riem.local_datum(zc, zbm)):
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dt", [0.05, 1e-12])
def test_implicit_friction(dtype, dt):
    z, zmax, qx, qy, zb, n = (a.astype(dtype) for a in
                              random_domain(5, rows=16, cols=24))
    z = np.where(z < -9000, zb, z).astype(dtype)
    dtv = np.asarray(dt, dtype)
    want = j_fric.implicit_friction(z, qx, qy, zb, n, dtv, 1e-10)
    got = friction.implicit_friction(*(_t(a, dtype) for a in
                                       (z, qx, qy, zb, n, dtv)), 1e-10)
    for g, w in zip(got, want):
        _close(g, w, dtype)


def test_comp_add_f32():
    rng = np.random.default_rng(7)
    z = rng.uniform(10, 100, 64).astype(np.float32)
    comp = rng.uniform(-1e-6, 1e-6, 64).astype(np.float32)
    delta = rng.uniform(-1e-4, 1e-4, 64).astype(np.float32)
    want = j_comp.comp_add(z, comp, delta)
    got = compensated.comp_add(*(torch.as_tensor(a) for a in
                                 (z, comp, delta)))
    for g, w in zip(got, want):
        # Fast2Sum is exact arithmetic: bitwise equal.
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("simplified", [False, True])
def test_max_wave_speed(dtype, simplified):
    z, zmax, qx, qy, zb, n = (a.astype(dtype) for a in
                              random_domain(2, rows=16, cols=24))
    want = j_ts.max_wave_speed(z, zmax, qx, qy, zb, 1e-9, simplified)
    got = timestep.max_wave_speed(*(_t(a, dtype) for a in
                                    (z, zmax, qx, qy, zb)), 1e-9, simplified)
    assert got.dim() == 0
    _close(got, want, dtype)


# (t, dt, t_hydro, max_speed, sync, end): near-sync, end time, suspended
# (negative dt), dry domain (max_speed = 0 -> inf), hydrological reset.
ADVANCE_CASES = {
    "near_sync": (9.93, 0.05, 0.4, 3.0, 10.0, 100.0),
    "end_time": (99.95, 0.02, 0.2, 2.0, 200.0, 100.0),
    "negative_dt": (10.0, -0.3, 0.5, 4.0, 10.0, 100.0),
    "max_speed_zero": (70.0, 0.5, 0.2, 0.0, 300.0, 600.0),
    "hydro_reset": (30.0, 0.08, 1.02, 10.0, 60.0, 600.0),
    "start_floor": (0.0, 0.01, 0.0, 1e12, 10.0, 100.0),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(ADVANCE_CASES))
@pytest.mark.parametrize("dynamic", [True, False])
def test_advance(dtype, case, dynamic):
    t, dt, th, speed, sync, end = ADVANCE_CASES[case]
    f = lambda v: jnp.asarray(v, dtype)  # noqa: E731
    jc = JCarry(f(t), f(dt), f(th), f(1.5), jnp.int32(3), jnp.int32(1))
    jp = j_ts.TimestepParams(dynamic=dynamic, fixed_dt=0.2)
    want = j_ts.advance(jc, f(speed), f(sync), end, 2.0, jp)
    got = timestep.advance(from_numpy(jc, "cpu"), _t(speed, dtype),
                           _t(sync, dtype), end, 2.0,
                           timestep.TimestepParams(dynamic=dynamic,
                                                   fixed_dt=0.2))
    for name, g, w in zip(want._fields, got, want):
        assert g.dim() == 0 and g.numpy().dtype == np.asarray(w).dtype, name
        _close(g, w, dtype, name)


def _step_inputs(seed, dtype, rows=16, cols=24):
    z, zmax, qx, qy, zb, n = (a.astype(dtype) for a in
                              random_domain(seed, rows=rows, cols=cols))
    return JState(z, zmax, qx, qy), JStatic(zb, n)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("friction_on", [True, False])
def test_godunov_step(dtype, seed, friction_on):
    jstate, jstatic = _step_inputs(seed, dtype)
    dt = np.asarray(0.05, dtype)
    want = j_god.godunov_step(jstate, jstatic, dt,
                              j_god.SchemeParams(2.0, 2.0,
                                                 friction=friction_on))
    got = godunov.godunov_step(from_numpy(jstate, "cpu"),
                               from_numpy(jstatic, "cpu"), _t(dt, dtype),
                               godunov.SchemeParams(2.0, 2.0,
                                                    friction=friction_on))
    for name, g, w in zip(want._fields, got, want):
        _close(g, w, dtype, name)


@pytest.mark.parametrize("dt", [0.05, -0.05])
def test_godunov_step_compensated(dt):
    jstate, jstatic = _step_inputs(4, np.float32)
    comp = np.random.default_rng(0).uniform(
        -1e-7, 1e-7, jstate.z.shape).astype(np.float32)
    dtv = np.asarray(dt, np.float32)
    want, wcomp = j_god.godunov_step(jstate, jstatic, dtv,
                                     j_god.SchemeParams(2.0, 2.0),
                                     comp=comp)
    got, gcomp = godunov.godunov_step(from_numpy(jstate, "cpu"),
                                      from_numpy(jstatic, "cpu"),
                                      _t(dtv, np.float32),
                                      godunov.SchemeParams(2.0, 2.0),
                                      comp=torch.as_tensor(comp))
    for name, g, w in zip(want._fields, got, want):
        _close(g, w, np.float32, name)
    np.testing.assert_allclose(
        got.z.double().numpy() + gcomp.double().numpy(),
        np.asarray(want.z, np.float64) + np.asarray(wcomp, np.float64),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("friction_on", [True, False])
def test_godunov_step_matches_oracle(seed, friction_on):
    jstate, jstatic = _step_inputs(seed, np.float64, rows=14, cols=18)
    want = godunov_step_oracle(*jstate, *jstatic, 0.05, 2.0, 2.0,
                               friction=friction_on)
    got = godunov.godunov_step(from_numpy(jstate, "cpu"),
                               from_numpy(jstatic, "cpu"),
                               torch.tensor(0.05, dtype=torch.float64),
                               godunov.SchemeParams(2.0, 2.0,
                                                    friction=friction_on))
    # The oracle solves every face twice with the per-cell datum shift;
    # the same bar as the JAX package's own oracle test.
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-9, atol=1e-11)
