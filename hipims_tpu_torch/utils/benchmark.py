"""Wall-clock and device timing utilities.

Replaces CBenchmark (reference: src/General/CBenchmark.cpp:46-119) and adds
what the reference lacked: per-phase timers (CUDA events on a CUDA device,
so a section times the device work it enqueued, not the enqueue), a
device profiler hook (torch.profiler, a Chrome trace per call) and a
mass-balance audit trail.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class Benchmark:
    """Named accumulating timers.  With a CUDA ``device`` each section is
    timed by a pair of CUDA events and synchronised at its end; else by
    the host clock."""

    def __init__(self, device=None):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.device = torch.device(device) if device is not None else None
        self._start = time.monotonic()

    @contextlib.contextmanager
    def section(self, name: str):
        if self.device is not None and self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                yield
            finally:
                end.record()
                end.synchronize()
                self.totals[name] += start.elapsed_time(end) / 1e3
                self.counts[name] += 1
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    @property
    def elapsed(self) -> float:
        return time.monotonic() - self._start

    def report(self) -> str:
        lines = [f"total wall: {self.elapsed:.2f}s"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(f"  {name:<24s} {self.totals[name]:9.3f}s "
                         f"x{self.counts[name]}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a profile of the CPU and (where there is one) the CUDA
    device into ``log_dir`` as a Chrome trace:

        with device_trace('prof'):
            sim.run_to(60.0)
    """
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


class MassBalanceAudit:
    """Tracks domain volume over time; the papers' <1% budget check as a
    runtime observable."""

    def __init__(self, sim):
        self.sim = sim
        self.records = []

    def sample(self):
        self.records.append((self.sim.t, self.sim.volume()))
        return self.records[-1]

    def drift(self) -> float:
        """Relative volume change between first and last samples."""
        if len(self.records) < 2:
            return 0.0
        v0 = self.records[0][1]
        v1 = self.records[-1][1]
        return (v1 - v0) / max(abs(v0), 1e-30)
