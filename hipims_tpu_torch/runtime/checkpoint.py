"""Checkpoint / resume.

A checkpoint holds the whole prognostic state and the time controller, so
a run resumes exactly: same t, dt, hydrological accumulator and batch
counters.  The file is the JAX package's (hipims_tpu/runtime/checkpoint.py,
gathered branch): an .npz with a ``meta`` JSON string, the planes z, zmax,
qx, qy, the compensated-f32 residue plane ``comp`` where the run has one,
and the six StepCarry scalars under their field names, so a file written
by either package resumes in the other (tests/test_torch_checkpoint.py).
The port writes the members uncompressed (``np.savez``; the JAX package
deflates them): on a wet 9.04 M-cell f32c state deflate saved 10% of
the bytes for ~10 s per checkpoint on an H100 machine (PERF.md),
and ``np.load`` reads either.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..state import FlowState, StepCarry

CHECKPOINT_VERSION = 1


def _meta(sim) -> dict:
    # The grid is never padded here: rows/cols and logical_rows/cols are
    # the same, and a JAX checkpoint of a padded grid does not match.
    return dict(
        version=CHECKPOINT_VERSION,
        scheme=sim.config.scheme,
        dtype=sim.config.dtype,
        rows=sim.domain.rows,
        cols=sim.domain.cols,
        logical_rows=sim.domain.rows,
        logical_cols=sim.domain.cols,
        duration=sim.config.duration,
        datum=sim.domain.datum,
    )


def save_checkpoint(path, sim, snapshot=None):
    """Write the simulation's resumable state to an .npz file.

    ``snapshot`` (an output event's host copy) saves copying the state off
    the device a second time when the caller has just made one; the comp
    plane, which only a checkpoint reads, is copied here."""
    path = Path(path)
    state = (snapshot.state_full if snapshot is not None
             else FlowState(*(a.cpu().numpy() for a in sim.state)))
    comp = sim.comp.cpu().numpy() if sim.comp is not None else None
    arrays = dict(meta=json.dumps(_meta(sim)),
                  z=state.z, zmax=state.zmax, qx=state.qx, qy=state.qy)
    for name, value in sim.carry._asdict().items():
        arrays[name] = value.cpu().numpy()
    if comp is not None:
        # Without the residue plane a resume would restart the rounding
        # error from zero (harmless but inexact).
        arrays["comp"] = comp
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **arrays)


def load_checkpoint(path, sim):
    """Restore a checkpoint into an existing, compatible Simulation: the
    same grid, scheme and datum (precision modes with different datum
    shifts cannot resume each other)."""
    with np.load(Path(path), allow_pickle=False) as data:
        meta = json.loads(str(data["meta"]))
        if meta["version"] != CHECKPOINT_VERSION:
            raise ValueError(f"unsupported checkpoint version "
                             f"{meta['version']}")
        if (meta["rows"], meta["cols"]) != (sim.domain.rows,
                                            sim.domain.cols):
            raise ValueError(
                f"checkpoint grid {meta['rows']}x{meta['cols']} does not "
                f"match simulation {sim.domain.rows}x{sim.domain.cols}")
        if meta["scheme"] != sim.config.scheme:
            raise ValueError(f"checkpoint scheme '{meta['scheme']}' != "
                             f"'{sim.config.scheme}'")
        ck_datum = meta.get("datum", 0.0)
        if ck_datum != sim.domain.datum:
            raise ValueError(
                f"checkpoint datum {ck_datum} != simulation datum "
                f"{sim.domain.datum} (precision modes with different "
                "datum shifts cannot resume each other)")

        def put(key, dtype=sim.dtype):
            # One plane at a time: read -> cast -> place -> free.
            return torch.as_tensor(np.asarray(data[key])).to(
                device=sim.device, dtype=dtype)

        sim.state = FlowState(z=put("z"), zmax=put("zmax"), qx=put("qx"),
                              qy=put("qy"))
        if sim.compensated:
            sim.comp = (put("comp") if "comp" in data
                        else torch.zeros_like(sim.state.z))
        sim.carry = StepCarry(
            t=put("t"), dt=put("dt"), t_hydro=put("t_hydro"),
            batch_dt_total=put("batch_dt_total"),
            batch_successful=put("batch_successful", torch.int32),
            batch_skipped=put("batch_skipped", torch.int32))
    sim._host_carry = sim._read_carry()
    sim.total_steps = int(sim._host_carry[3])
    sim.total_skipped = int(sim._host_carry[4])
    return sim
