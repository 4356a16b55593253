"""The port's fused step (``stencil_step``) against the JAX package's Pallas
kernel ``stencil_step_pallas`` run in interpret mode on the CPU, mirroring
tests/test_pallas_stencil.py: float64 to 1e-12 (speed rel 1e-12), and
compensated float32 over 4 steps (fields 1e-5/1e-6, z + comp 1e-6).

On CPU tensors ``stencil_step`` runs its plain version; the CUDA kernel is
held against that plain version on the card (tests/test_torch_cuda.py,
skipped without a card, and ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from hipims_tpu.ops.godunov import SchemeParams as JParams
from hipims_tpu.ops.pallas.stencil import stencil_step_pallas
from hipims_tpu.state import DomainStatic as JStatic
from hipims_tpu.state import FlowState as JState
from hipims_tpu_torch.ops.godunov import SchemeParams
from hipims_tpu_torch.ops.kernels.stencil import (stencil_step,
                                                  stencil_step_plain)
from hipims_tpu_torch.state import from_numpy
from tests.test_godunov_oracle import random_domain

torch.set_num_threads(1)


def _domain(seed, dtype, rows=32, cols=128):
    z, zmax, qx, qy, zb, n = (a.astype(dtype) for a in
                              random_domain(seed, rows=rows, cols=cols))
    return JState(z, zmax, qx, qy), JStatic(zb, n)


@pytest.mark.parametrize("seed", [0, 1])
def test_stencil_step_matches_pallas_f64(seed):
    jstate, jstatic = _domain(seed, np.float64)
    want, want_speed = stencil_step_pallas(
        "godunov", jstate, jstatic, 0.05, JParams(2.0, 2.0), tile_rows=8,
        interpret=True)
    got, speed = stencil_step(
        "godunov", from_numpy(jstate, "cpu"), from_numpy(jstatic, "cpu"),
        torch.tensor(0.05, dtype=torch.float64), SchemeParams(2.0, 2.0))
    for g, w, name in zip(got, want, ("z", "zmax", "qx", "qy")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-12, err_msg=name)
    assert speed.dim() == 0
    assert float(speed) == pytest.approx(float(want_speed), rel=1e-12)


def test_stencil_step_matches_pallas_compensated():
    """Multi-step comp accumulation against the Pallas comp plane."""
    jstate, jstatic = _domain(11, np.float32)
    dt = np.float32(0.05)
    want, want_comp = jstate, np.zeros_like(jstate.z)
    got = from_numpy(jstate, "cpu")
    static = from_numpy(jstatic, "cpu")
    got_comp = torch.zeros_like(got.z)
    for _ in range(4):
        want, want_speed, want_comp = stencil_step_pallas(
            "godunov", want, jstatic, dt, JParams(2.0, 2.0), tile_rows=8,
            interpret=True, comp=want_comp)
        got, speed, got_comp = stencil_step(
            "godunov", got, static, torch.tensor(dt), SchemeParams(2.0, 2.0),
            comp=got_comp)
    for g, w, name in zip(got, want, ("z", "zmax", "qx", "qy")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(
        got.z.double().numpy() + got_comp.double().numpy(),
        np.asarray(want.z, np.float64) + np.asarray(want_comp, np.float64),
        rtol=1e-6, atol=1e-6)
    assert float(speed) == pytest.approx(float(want_speed), rel=1e-5)


def test_stencil_step_rejects_unported_scheme():
    jstate, jstatic = _domain(0, np.float64, rows=8, cols=8)
    with pytest.raises(NotImplementedError, match="not ported"):
        stencil_step("muscl-hancock", from_numpy(jstate, "cpu"),
                     from_numpy(jstatic, "cpu"),
                     torch.tensor(0.05, dtype=torch.float64),
                     SchemeParams(2.0, 2.0))


def test_cpu_path_never_counts_launches():
    jstate, jstatic = _domain(0, np.float64, rows=8, cols=8)
    before = stencil_step.launches
    stencil_step("godunov", from_numpy(jstate, "cpu"),
                 from_numpy(jstatic, "cpu"),
                 torch.tensor(0.05, dtype=torch.float64),
                 SchemeParams(2.0, 2.0))
    assert stencil_step.launches == before
