"""Per-cell debug tracing.

The reference's debugging story is printf tracing of one chosen cell from
inside the kernels (DEBUG_OUTPUT/DEBUG_CELLX/DEBUG_CELLY constants,
src/Schemes/CSchemeGodunov.cpp:680-689, CLSchemeGodunov.clc:237-246).
Here the simulation runs one step at a time and records the chosen cell's
state after each, with any scheme, on any device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class CellTrace:
    t: list
    dt: list
    z: list
    zmax: list
    qx: list
    qy: list

    def as_arrays(self):
        return {k: np.asarray(getattr(self, k))
                for k in ("t", "dt", "z", "zmax", "qx", "qy")}


def trace_cell(sim, row: int, col: int, n_steps: int) -> CellTrace:
    """Advance ``n_steps`` single steps recording (t, dt, state) of one
    cell; each step reads the cell back to the host."""
    tr = CellTrace([], [], [], [], [], [])
    sync = torch.tensor(sim.config.duration, dtype=sim.dtype,
                        device=sim.device)
    for _ in range(n_steps):
        sim.state, sim.carry, sim.comp = sim._run_batch(
            sim.state, sim.carry, sim.static, sync, sim.comp, 1)
        tr.t.append(float(sim.carry.t))
        tr.dt.append(float(sim.carry.dt))
        for name in ("z", "zmax", "qx", "qy"):
            getattr(tr, name).append(float(getattr(sim.state, name)[row,
                                                                     col]))
    sim._host_carry = sim._read_carry()
    return tr
