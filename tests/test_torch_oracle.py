"""The port's numpy oracles (hipims_tpu_torch/ops/oracle.py, oracle_muscl.py).

They are copies of the JAX package's per-cell transcriptions of the
reference kernels, taking only the port's ``constants``, so that the
card's machine, which has no JAX, holds the kernels against a second
reference (tests/test_torch_cuda.py, chip_smoke phase 3e).  Here, on the
CPU: the copies give the originals' bytes on the JAX tests' random
domains, and the port's plain whole-grid steps agree with them to 1e-12
in float64.
"""

import numpy as np
import pytest
import torch

from hipims_tpu.ops import oracle as j_oracle
from hipims_tpu.ops import oracle_muscl as j_oracle_muscl
from hipims_tpu_torch.ops import oracle, oracle_muscl
from hipims_tpu_torch.ops.godunov import SchemeParams
from hipims_tpu_torch.ops.kernels.muscl_split import muscl_step_split
from hipims_tpu_torch.ops.kernels.stencil import stencil_step
from hipims_tpu_torch.state import DomainStatic, FlowState
from tests.test_godunov_oracle import random_domain

DT, DX = 0.05, 2.0
STEPS = {"godunov": (oracle.godunov_step_oracle,
                     j_oracle.godunov_step_oracle),
         "muscl-hancock": (oracle_muscl.muscl_step_oracle,
                           j_oracle_muscl.muscl_step_oracle)}


@pytest.mark.parametrize("scheme", sorted(STEPS))
@pytest.mark.parametrize("friction", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oracles_equal_the_jax_packages(scheme, friction, seed):
    arrs = random_domain(seed)
    port, jax_pkg = STEPS[scheme]
    got = port(*arrs, DT, DX, DX, friction=friction)
    want = jax_pkg(*arrs, DT, DX, DX, friction=friction)
    for g, w, name in zip(got, want, ("z", "zmax", "qx", "qy")):
        assert g.dtype == np.float64 and np.array_equal(g, w), name


def test_muscl_predictor_oracle_equals_the_jax_packages():
    z, zmax, qx, qy, zb, _ = random_domain(3)
    got = oracle_muscl.predictor_oracle(z, zmax, qx, qy, zb, DT, DX, DX)
    want = j_oracle_muscl.predictor_oracle(z, zmax, qx, qy, zb, DT, DX, DX)
    assert len(got) == len(want) == 4
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == z.shape + (4,) and np.array_equal(g, w), k


@pytest.mark.parametrize("scheme,variant", [("godunov", None),
                                            ("muscl-hancock", "split12"),
                                            ("muscl-hancock", "recompute")])
@pytest.mark.parametrize("friction", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_plain_steps_match_the_port_oracles(scheme, variant, friction, seed):
    z, zmax, qx, qy, zb, n = random_domain(seed)
    state = FlowState(*(torch.from_numpy(a) for a in (z, zmax, qx, qy)))
    static = DomainStatic(torch.from_numpy(zb), torch.from_numpy(n))
    dt = torch.tensor(DT, dtype=torch.float64)
    params = SchemeParams(DX, DX, friction=friction)
    if scheme == "godunov":
        got, _ = stencil_step(scheme, state, static, dt, params)
    else:
        got, _ = muscl_step_split(state, static, dt, params, variant)
    want = STEPS[scheme][0](z, zmax, qx, qy, zb, n, DT, DX, DX,
                            friction=friction)
    for g, w, name in zip(got, want, ("z", "zmax", "qx", "qy")):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-12,
                                   err_msg=name)
