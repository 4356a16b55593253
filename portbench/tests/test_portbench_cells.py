"""Each cell's check, driven end to end at a tiny size on the CPU through
``harness.run_cell`` (an entry the command line cannot reach): a sound
segment comes out correct, and the timed path broken underneath comes
out not correct, once for each fault a one-chip simulation cell can
have: a step that returns its state unchanged, half of the grid left
out of the step, and an answer altered where it is produced (the state
the steps return, or the raster the output layer derives); and for the
faults that keep the water's mass, which its volume cannot see: the
first-order step in MUSCL-Hancock's place, and van Leer's limiter in
minmod's place.  No committed cell runs across chips, so none has an
exchange to leave out (``test_portbench_ranks.py`` leaves it out of a
dummy four-rank cell).  The control (the program in plain float32) is run at the
cells' own size on the card (``test_control_fails_on_the_card``, marked
``cuda``).

    python -m pytest --noconftest -p no:cacheprovider portbench/tests
"""

import pytest
import torch

import hipims_tpu_torch.ops.limiters as limiters
import hipims_tpu_torch.runtime.output as output
import hipims_tpu_torch.runtime.simulation as simulation
from hipims_tpu_torch.ops.kernels.stencil import stencil_step
from hipims_tpu_torch.state import FlowState
from portbench import harness

TINY = {"malpasset-10m.dambreak": {"rows": 48, "cols": 80,
                                   "segment_s": 60.0,
                                   "output_times_s": [60.0]}}
# The gaps of a sound run are larger on these tiny grids than at the
# cell's own size (its first minute is all dam-break front), so the tiny
# runs are held to limits read on the CPU at this size, on seeds 11 and
# 12: sound runs read depth gap means of 0.025-0.026 m and maxdepth block
# gap means of 0.012-0.013 m, van Leer's limiter 0.31-0.32 and 0.24, the
# first-order step 1.19-1.20 and 1.16-1.18.
TINY_LIMITS = {"malpasset-10m.dambreak": {"compared": {
    "time_gap_s": 0.0, "raster_depth_volume_gap": 5e-7,
    "raster_depth_gap_mean_m": 0.1, "raster_maxdepth_block_gap_mean_m": 0.06}}}


def run(workload, seed=11, **kw):
    return harness.run_cell(workload, seed, 0.0, False, device="cpu",
                            sizes=TINY[workload], limits=TINY_LIMITS[workload],
                            **kw)


@pytest.mark.parametrize("workload", sorted(TINY))
def test_sound_segment_is_correct(workload):
    res = run(workload)
    assert res["correct"], res["compared"]


def _broken_batch(real, fault):
    """``Simulation._run_batch`` with ``fault``: each batch of steps
    returns the state it was given (the clock still advances), or leaves
    the northern half of the grid as it was, or returns a state altered
    where the steps produce it (1 um of water added a step)."""
    def run_batch(self, state, carry, static, sync_time, comp, n_steps):
        new, carry, new_comp = real(self, state, carry, static, sync_time,
                                    comp, n_steps)
        if fault == "unchanged":
            return state, carry, comp
        if fault == "half":
            half = state.z.shape[0] // 2
            new = FlowState(*(torch.cat([n[:half], o[half:]])
                              for n, o in zip(new, state)))
            if comp is not None:
                new_comp = torch.cat([new_comp[:half], comp[half:]])
            return new, carry, new_comp
        return new._replace(z=new.z + 1e-6 * n_steps), carry, new_comp
    return run_batch


def _altered_field(*args, **kwargs):
    out = real_derive(*args, **kwargs)
    return out + 0.01 * (out > 0.0)


real_derive = output.derive_field


def _first_order(state, static, dt, params, variant=None, comp=None,
                 partials=False):
    return stencil_step("godunov", state, static, dt, params, comp=comp,
                        partials=partials)


def _van_leer(left, center, right):
    rl, rr = center - left, right - center
    r = torch.where(rl == 0.0, 0.0, rr / torch.where(rl == 0.0, 1.0, rl))
    return (r + torch.abs(r)) / (1.0 + torch.abs(r)) * rl


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered",
                                   "first_order", "van_leer"])
@pytest.mark.parametrize("workload", sorted(TINY))
def test_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    if fault == "first_order":
        monkeypatch.setattr(simulation, "muscl_step_split", _first_order)
    elif fault == "van_leer":
        monkeypatch.setattr(limiters, "limited_slope", _van_leer)
    elif fault == "altered" and TINY[workload].get("output_times_s"):
        # The answer the check reads is the raster: alter it where the
        # output layer derives it.
        monkeypatch.setattr(output, "derive_field", _altered_field)
    else:
        monkeypatch.setattr(simulation.Simulation, "_run_batch",
                            _broken_batch(simulation.Simulation._run_batch,
                                          fault))
    res = run(workload)
    assert not res["correct"], res["compared"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(TINY))
def test_control_fails_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's own size on a CUDA card")
    res = harness.run_cell(workload, 2718281828, 0.0, False,
                           device="cuda:0", precision="single")
    assert not res["correct"], res["compared"]
