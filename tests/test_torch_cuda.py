"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every case carries the ``cuda`` marker and skips without a CUDA device.
This module imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` skips the repo's conftest.py, which sets up JAX).  The
inputs are the adversarial wet/dry random domain of chip_smoke.py, made
with numpy from a seed.  Tolerances: float64 to 1e-12 (bit-equal is
expected under --fmad=false), float32 to rtol 1e-5 / atol 1e-6, and the
true surface z + comp to 1e-6.
"""

import numpy as np
import pytest
import torch

from chip_smoke import random_domain
from hipims_tpu_torch.ops.godunov import SchemeParams
from hipims_tpu_torch.ops.kernels import muscl_split as ms
from hipims_tpu_torch.ops.kernels.stencil import (stencil_step,
                                                  stencil_step_plain)
from hipims_tpu_torch.state import DomainStatic, FlowState

MODES = ["f64", "f32", "f32c"]
PARAMS = SchemeParams(2.0, 2.0)


def _inputs(mode, rows=32, cols=128):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dtype = torch.float64 if mode == "f64" else torch.float32
    t = [torch.as_tensor(a, device="cuda").to(dtype)
         for a in random_domain(0, rows, cols)]
    comp = None
    if mode == "f32c":
        rng = np.random.default_rng(1)
        comp = torch.as_tensor(rng.uniform(-1e-7, 1e-7, (rows, cols)),
                               device="cuda").to(dtype)
    dt = torch.tensor(0.05, dtype=dtype, device="cuda")
    return FlowState(*t[:4]), DomainStatic(*t[4:]), comp, dt


def _tol(mode):
    return (dict(rtol=1e-12, atol=1e-12) if mode == "f64"
            else dict(rtol=1e-5, atol=1e-6))


def _assert_step_close(got, want, mode):
    """(new_state, speed[, comp]) results: fields, speed, z + comp."""
    tol = _tol(mode)
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), **tol)
    assert float(got[1]) == pytest.approx(float(want[1]), rel=tol["rtol"])
    if len(got) == 3:
        np.testing.assert_allclose(
            (got[0].z.double() + got[2].double()).cpu().numpy(),
            (want[0].z.double() + want[2].double()).cpu().numpy(),
            rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_k1_matches_plain(mode):
    """K1 on the card against its plain version on the same card."""
    state, static, comp, dt = _inputs(mode)
    before = stencil_step.launches
    got = stencil_step("godunov", state, static, dt, PARAMS, comp=comp)
    want = stencil_step_plain(state, static, dt, PARAMS, comp=comp)
    assert stencil_step.launches == before + 1
    _assert_step_close(got, want, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["split12", "recompute"])
@pytest.mark.parametrize("mode", MODES)
def test_muscl_kernels_match_plain(variant, mode):
    """K2 + K3 (split12) or K5a-P + K5a-C (recompute) against their plain
    versions on the same card: every predictor plane, then the
    corrector's result from the plain predictor planes."""
    state, static, comp, dt = _inputs(mode)
    store = variant == "split12"
    pred_k, corr_k = ((ms.muscl_predict, ms.muscl_correct) if store else
                      (ms.muscl_predict_base, ms.muscl_correct_recompute))
    before = (pred_k.launches, corr_k.launches)
    pred = pred_k(state, static, dt, PARAMS)
    want_pred = ms.muscl_predict_plain(state, static, dt, PARAMS,
                                       store_slopes=store)
    np.testing.assert_allclose(pred.cpu().numpy(), want_pred.cpu().numpy(),
                               **_tol(mode))
    got = corr_k(state, static, want_pred, dt, PARAMS, comp=comp)
    want = ms.muscl_correct_plain(state, static, want_pred, dt, PARAMS,
                                  comp=comp)
    assert (pred_k.launches, corr_k.launches) == (before[0] + 1,
                                                  before[1] + 1)
    _assert_step_close(got, want, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_muscl_variants_equal_on_card(mode):
    """The recompute corrector rebuilds exactly the slopes K2 stores."""
    state, static, comp, dt = _inputs(mode)
    a = ms.muscl_step_split(state, static, dt, PARAMS, "split12", comp)
    b = ms.muscl_step_split(state, static, dt, PARAMS, "recompute", comp)
    for x, y in zip([*a[0], a[1], *a[2:]], [*b[0], b[1], *b[2:]]):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_muscl_kernels_reject_bad_inputs():
    state, static, comp, dt = _inputs("f32")
    with pytest.raises(ValueError, match="predictor planes"):
        ms.muscl_correct(state, static, torch.zeros_like(state.z), dt,
                         PARAMS)
    with pytest.raises(ValueError, match="dt must be"):
        ms.muscl_predict(state, static, dt.double(), PARAMS)
