"""The time controller's kernel wrapper (``ops/kernels/timestep.py``) on the
CPU, and the unreduced CFL partials that feed it.

On CPU tensors the wrapper runs the plain ``ops.timestep.advance`` and
launches nothing.  The plain version given a step kernel's 1-d partial
maxima takes their NaN-propagating max.  ``launch_step`` returns the 0-d
max by default and the partials themselves on request, and the batch loop
asks for them.  The kernel itself is held to the plain version bit for bit
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3f).
"""

import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

import chip_smoke
from hipims_tpu_torch.ops import timestep as plain
from hipims_tpu_torch.ops.kernels import common
from hipims_tpu_torch.ops.kernels import timestep as kernel
from hipims_tpu_torch.parallel import halo_deep
from hipims_tpu_torch.runtime import Simulation, SimulationConfig
from hipims_tpu_torch.runtime import simulation
from hipims_tpu_torch.state import FlowState, StepCarry

DTYPES = [torch.float32, torch.float64]
# (t, dt, t_hydro, speed, sync, end): near the sync point, at the end
# time, idle (negative dt), a dry domain (speed 0), the hydrological
# reset, the start-up floor, the sync point reached (the flip).
CASES = {
    "near_sync": (9.93, 0.05, 0.4, 3.0, 10.0, 100.0),
    "end_time": (99.95, 0.02, 0.2, 2.0, 200.0, 100.0),
    "negative_dt": (10.0, -0.3, 0.5, 4.0, 10.0, 100.0),
    "max_speed_zero": (70.0, 0.5, 0.2, 0.0, 300.0, 600.0),
    "hydro_reset": (30.0, 0.08, 1.02, 10.0, 60.0, 600.0),
    "start_floor": (0.0, 0.01, 0.0, 1e12, 10.0, 100.0),
    "flip": (9.95, 0.05, 0.4, 3.0, 10.0, 100.0),
}


def _carry(dtype, t, dt, t_hydro):
    def f(v):
        return torch.tensor(v, dtype=dtype)

    return StepCarry(f(t), f(dt), f(t_hydro), f(1.5),
                     torch.tensor(3, dtype=torch.int32),
                     torch.tensor(1, dtype=torch.int32))


def _bits(carry):
    """The carry's values as bytes: equal bits, NaN payloads included."""
    return [v.numpy().tobytes() for v in carry]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dynamic", [True, False])
def test_wrapper_on_cpu_is_the_plain_advance(dtype, case, dynamic):
    t, dt, th, speed, sync, end = CASES[case]
    carry = _carry(dtype, t, dt, th)
    params = plain.TimestepParams(dynamic=dynamic, fixed_dt=0.2)
    args = (torch.tensor(speed, dtype=dtype), torch.tensor(sync, dtype=dtype),
            end, 2.0, params)
    before = kernel.advance.launches
    got = kernel.advance(carry, *args)
    assert kernel.advance.launches == before
    assert _bits(got) == _bits(plain.advance(carry, *args))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dynamic", [True, False])
@pytest.mark.parametrize("speeds", ["one", "partials", "nan_among_1000",
                                    "all_zero"])
def test_partials_fold_like_their_amax(dtype, dynamic, speeds):
    """advance given a vector of partials equals advance given their
    torch.amax (NaN propagates: one NaN among 1000 partials gives a NaN
    dt, as a NaN max does)."""
    rng = np.random.default_rng(3)
    vec = {"one": np.array([31.7]),
           "partials": rng.uniform(0.0, 30.0, 1920),
           "nan_among_1000": rng.uniform(0.0, 30.0, 1000),
           "all_zero": np.zeros(1920)}[speeds]
    if speeds == "nan_among_1000":
        vec[417] = np.nan
    vec = torch.as_tensor(vec).to(dtype)
    carry = _carry(dtype, 30.0, 0.08, 0.5)
    params = plain.TimestepParams(dynamic=dynamic)
    sync = torch.tensor(60.0, dtype=dtype)
    got = kernel.advance(carry, vec, sync, 600.0, 10.0, params)
    want = plain.advance(carry, torch.amax(vec), sync, 600.0, 10.0, params)
    assert _bits(got) == _bits(want)
    assert bool(got.dt.isnan()) == (dynamic and speeds == "nan_among_1000")


def test_wrapper_rejects_other_devices():
    carry = StepCarry(*(torch.zeros((), device="meta") for _ in range(6)))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernel.advance(carry, carry.t, carry.t, 1.0, 1.0,
                       plain.TimestepParams())


# The comp plane is a float32 option.
@pytest.mark.parametrize("dtype, with_comp", [(torch.float32, False),
                                              (torch.float32, True),
                                              (torch.float64, False)])
@pytest.mark.parametrize("partials", [False, True])
def test_launch_step_returns_the_max_or_the_partials(monkeypatch, dtype,
                                                      with_comp, partials):
    """launch_step up to a stand-in C entry point that writes the
    partials: by default the 0-d max of the partials (the return every
    caller but the batch loop takes), with ``partials`` the 1-d partials
    unreduced."""
    values = [3.0, 7.5, 1.0, 0.0]
    ctype = ctypes.c_float if dtype == torch.float32 else ctypes.c_double

    def entry(*args):
        # The partials' pointer, then dt's and the stream (no kernel args).
        (ctype * len(values)).from_address(args[-3])[:] = values
        return 0

    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    lib = types.SimpleNamespace(step_f32=entry, step_f64=entry)
    plane = torch.zeros(4, 5, dtype=dtype)
    state = FlowState(plane, plane, plane, plane)
    comp = plane.clone() if with_comp else None
    dt = torch.tensor(0.1, dtype=dtype)
    out = common.launch_step(lib, "step", "step", [None] * 6, state, comp,
                             dt, len(values), (), partials=partials)
    assert len(out) == (3 if with_comp else 2)
    speed = out[1]
    if partials:
        assert speed.shape == (4,)
        assert _bits([speed]) == _bits([torch.tensor(values, dtype=dtype)])
    else:
        assert speed.dim() == 0 and float(speed) == 7.5


@pytest.mark.parametrize("scheme", ["godunov", "muscl-hancock", "inertial"])
def test_batch_loop_hands_the_partials_to_the_kernel_wrapper(monkeypatch,
                                                             scheme):
    """Every step of ``Simulation._run_batch`` asks its scheme step for
    the unreduced partials and hands them to the kernel wrapper, once a
    step; the mesh's controller is the same wrapper."""
    assert simulation.advance is kernel.advance
    assert halo_deep.advance is kernel.advance
    seen = dict(partials=[], advance=0)
    for name in ("stencil_step", "muscl_step_split"):
        fn = getattr(simulation, name)

        def step(*args, _fn=fn, **kwargs):
            seen["partials"].append(kwargs.get("partials"))
            return _fn(*args, **kwargs)

        monkeypatch.setattr(simulation, name, step)

    def advance(*args):
        seen["advance"] += 1
        return kernel.advance(*args)

    monkeypatch.setattr(simulation, "advance", advance)
    sim = Simulation(chip_smoke.dambreak_domain(16, 24),
                     SimulationConfig(scheme=scheme, duration=20.0,
                                      output_frequency=20.0,
                                      dtype="float32c", batch_size=8,
                                      batch_auto=False), device="cpu")
    sim.run_to(1.0)
    steps = sim.total_steps + sim.total_skipped
    assert steps > 0 and seen["advance"] == steps
    assert seen["partials"] == [True] * steps
