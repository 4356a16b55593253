"""Progress reporting: simulated time, rate, ETA, batch statistics.

Replaces the reference's progress table (src/CModel.cpp:343-462): cells/s
throughput, average timestep, batch size, percent complete, ETA — printed at
most every 0.85 s of wall time, like the reference's UI update interval.
"""

from __future__ import annotations

import time


class ProgressReporter:
    def __init__(self, log, sim, quiet=False, interval=0.85):
        self.log = log
        self.sim = sim
        self.quiet = quiet
        self.interval = interval
        self._last = 0.0
        self._last_steps = 0
        self._last_t = 0.0
        self._elapsed = 0.0   # device seconds accumulated since last print
        self._start = time.monotonic()

    def __call__(self, sim, t_now, batch_elapsed):
        # d_steps spans every batch since the last print, so the rate must
        # divide by the elapsed time of all of them, not just the batch
        # that triggered the print.
        self._elapsed += batch_elapsed
        now = time.monotonic()
        if now - self._last < self.interval or self.quiet:
            return
        self._last = now
        steps = sim.total_steps
        d_steps = steps - self._last_steps
        cells = sim.domain.cell_count
        elapsed = max(self._elapsed, 1e-9)
        rate = d_steps * cells / elapsed
        dur = sim.config.duration
        pct = 100.0 * t_now / dur if dur else 0.0
        sim_speed = (t_now - self._last_t) / elapsed
        eta = (dur - t_now) / max(sim_speed, 1e-12)
        avg_dt = (t_now - self._last_t) / max(d_steps, 1)
        self._last_steps = steps
        self._last_t = t_now
        self._elapsed = 0.0
        self.log.line(
            f"t={t_now:10.1f}s {pct:5.1f}%  dt≈{avg_dt:8.4f}s  "
            f"batch={sim._batch_size:<5d} {rate / 1e6:8.1f} Mcells/s  "
            f"ETA {eta:6.0f}s")

    def final(self, wall):
        sim = self.sim
        cells = sim.domain.cell_count
        total = sim.total_steps
        self.log.block("Simulation complete")
        self.log.line(f"  Simulated:   {sim.t:.1f} s in {wall:.1f} s wall")
        self.log.line(f"  Iterations:  {total} (+{sim.total_skipped} idle)")
        if wall > 0:
            self.log.line(f"  Throughput:  {total * cells / wall / 1e6:.1f} "
                          f"Mcells/s")



def device_table(sim):
    """Per-block rows for a mesh run, the reference's per-domain progress
    table (src/CModel.cpp:343-462) re-shaped for one shared time step:
    every block advances in lock step (one global dt), so the figures that
    vary per domain in the reference (batch size, average dt) are shared
    here, and the table reports each block's device, its place in the
    mesh, its rows and columns of the logical grid, its cells and the
    rank that owns it.  Returns a list of formatted lines (none without a
    mesh)."""
    if sim.mesh is None:
        return []
    from ..parallel.mesh import block_geometry
    lines = ["  device      placement   block rows        block cols       "
             "cells  rank"]
    for (iy, ix), (r0, nr, c0, nc) in sorted(block_geometry(
            sim.domain.rows, sim.domain.cols, sim.mesh.shape).items()):
        lines.append(
            f"  {str(sim.mesh.devices[iy, ix]):<10}  ({iy},{ix})      "
            f"[{r0:>6}..{r0 + nr:>6})  [{c0:>6}..{c0 + nc:>6})  "
            f"{nr * nc:>10,}  {sim.mesh.ranks[iy, ix]:>4}")
    return lines
