"""Checkpoint / resume.

A checkpoint holds the whole prognostic state and the time controller, so
a run resumes exactly: same t, dt, hydrological accumulator and batch
counters.  The file is the JAX package's (hipims_tpu/runtime/checkpoint.py,
gathered branch): an .npz with a ``meta`` JSON string, the planes z, zmax,
qx, qy, the compensated-f32 residue plane ``comp`` where the run has one,
and the six StepCarry scalars under their field names, so a file written
by either package resumes in the other (tests/test_torch_checkpoint.py).
The port writes the members uncompressed (stored, as ``np.savez`` does;
the JAX package deflates them): on a wet 9.04 M-cell f32c state deflate
saved 10% of the bytes for ~10 s per checkpoint on an H100 machine
(PERF.md), and ``np.load`` reads either.

Each plane is written in row chunks of the output event's snapshot
(runtime/sharded_io.py ``StreamingCheckpointWriter``): a streamed
snapshot's bounded chunks, so no plane is copied to the host whole, or a
gathered snapshot's host copy as one chunk.  In a multi-process run every
rank reads the chunks (the reads are collective), rank 0 alone writes the
file, and a barrier follows, so no rank resumes from a half-written file;
on resume every rank reads the file and loads its own blocks.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch

from ..parallel.distributed import barrier, is_coordinator
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

    ``snapshot`` is an output event's snapshot (runtime/simulation.py
    ``output_view``), so the event's host copy, where it made one, is not
    made twice; without one, the simulation's is taken.  Each plane
    streams in row chunks of ``snapshot.chunk_rows`` into its stored
    member, in the order ``np.savez`` would write them.  The file is
    written beside ``path`` and renamed over it once whole, so a failed
    save leaves the last checkpoint as it was.  Every rank of a
    multi-process run calls this: all read the chunks, rank 0 writes, and
    all wait for it."""
    from .sharded_io import StreamingCheckpointWriter, host_dtype, stream_rows

    path = Path(path)
    snap = snapshot if snapshot is not None else sim.output_view()
    names = list(FlowState._fields) + (["comp"] if sim.compensated else [])
    if not is_coordinator():
        for name in names:
            for _ in stream_rows(snap.plane(name), snap.chunk_rows):
                pass
        barrier()
        return

    def stream(zw, name):
        plane = snap.plane(name)
        zw.stream_array(name, plane.shape, host_dtype(plane),
                        (c for _, c in stream_rows(plane, snap.chunk_rows)))

    path.parent.mkdir(parents=True, exist_ok=True)
    part = path.with_name(path.name + ".part")
    with StreamingCheckpointWriter(part) as zw:
        zw.add_array("meta", json.dumps(_meta(sim)))
        for name in names[:4]:
            stream(zw, name)
        for name, value in sim.carry._asdict().items():
            zw.add_array(name, value.cpu().numpy())
        if sim.compensated:
            # Without the residue plane a resume would restart the
            # rounding error from zero (harmless but inexact).
            stream(zw, "comp")
    os.replace(part, path)
    barrier()


def load_checkpoint(path, sim):
    """Restore a checkpoint into an existing, compatible Simulation: the
    same grid, scheme and datum (precision modes with different datum
    shifts cannot resume each other).  Under a mesh each plane is loaded
    into this rank's blocks."""
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

        z = put("z")
        sim.state = FlowState(z=z, zmax=put("zmax"), qx=put("qx"),
                              qy=put("qy"))
        if sim.compensated:
            sim.comp = (put("comp") if "comp" in data
                        else torch.zeros_like(z))
        sim.carry = StepCarry(
            t=put("t"), dt=put("dt"), t_hydro=put("t_hydro"),
            batch_dt_total=put("batch_dt_total"),
            batch_successful=put("batch_successful", torch.int32),
            batch_skipped=put("batch_skipped", torch.int32))
    sim._host_carry = sim._read_carry()
    sim.total_steps = int(sim._host_carry[3])
    sim.total_skipped = int(sim._host_carry[4])
    return sim
