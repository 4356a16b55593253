"""Reduces a torch.profiler trace of one segment to what the per-layer
readers read: the device operations in the segment, the benchmark's own
spans around ``run_to`` and ``emit_output`` (``record_function`` ranges
named ``portbench.<call>``), the device's busy time as the union of its
operations' intervals, and the idle gaps, each labelled by the span and
the innermost host operation under way at its middle.

NCCL's kernels (``is_nccl``: names that start with ``nccl``) are kept
apart from the busy time: a collective's kernel spins on the card until
every rank has reached it, so its interval is the wait for the host and
the other ranks, not work.  Their union is ``Trace.nccl_s``, the time
the exchange holds the card, which the busy time counts as idle; the
kernel names and times (``device_time_by_name``) and the launches
(``Trace.kernels``) still list them.
"""

from __future__ import annotations

import dataclasses
import re
from collections import defaultdict

import numpy as np

SPAN_PREFIX = "portbench."
SPAN_KIND = {"portbench.run_to": "stepping",
             "portbench.emit_output": "output_event"}


@dataclasses.dataclass
class Trace:
    """Times in ns on the profiler's clock."""

    device_ops: list         # (name, start, end, is_kernel)
    spans: list              # (span name, start, end)
    window: tuple            # (start, end) of the traced segment
    host: list = dataclasses.field(default_factory=list)
    # (name, start, end) of the main thread's host operations, nested

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) * 1e-9

    def kernels(self):
        return [op for op in self.device_ops if op[3]]

    def busy_intervals(self):
        """The union of the device operations' intervals, NCCL's kernels
        left out, clipped to the window, as sorted disjoint (start, end)
        arrays."""
        return union([op for op in self.device_ops if not is_nccl(op[0])],
                     self.window)

    def busy_s(self):
        return seconds(self.busy_intervals())

    def nccl_s(self):
        """Seconds of the union of NCCL's kernels in the window."""
        return seconds(union([op for op in self.device_ops
                              if is_nccl(op[0])], self.window))

    def gaps(self):
        """(start, end) of each idle stretch in the window."""
        w0, w1 = self.window
        s, e = self.busy_intervals()
        gs = np.concatenate([[w0], e])
        ge = np.concatenate([s, [w1]])
        keep = ge > gs
        return gs[keep], ge[keep]


NCCL = re.compile(r"(void\s+)?nccl", re.IGNORECASE)


def is_nccl(name):
    """An NCCL kernel: a name that starts with ``nccl``, in any case,
    after a template's ``void``."""
    return NCCL.match(name) is not None


def union(ops, window):
    """The union of the intervals of ``ops`` ((name, start, end, ...)),
    clipped to ``window``, as sorted disjoint (start, end) arrays."""
    w0, w1 = window
    if not ops:
        return np.zeros(0), np.zeros(0)
    s = np.array([op[1] for op in ops], dtype=np.float64)
    e = np.array([op[2] for op in ops], dtype=np.float64)
    s, e = np.clip(s, w0, w1), np.clip(e, w0, w1)
    keep = e > s
    s, e = s[keep], e[keep]
    order = np.argsort(s, kind="stable")
    s, e = s[order], np.maximum.accumulate(e[order])
    if s.size == 0:
        return s, e
    new = np.ones(s.size, dtype=bool)
    new[1:] = s[1:] > e[:-1]
    starts = s[new]
    idx = np.flatnonzero(new)
    ends = e[np.append(idx[1:] - 1, s.size - 1)]
    return starts, ends


def seconds(intervals):
    """The length in seconds of disjoint (start, end) arrays in ns."""
    s, e = intervals
    return float((e - s).sum()) * 1e-9


def short_name(name):
    """A kernel's name without its return type, namespaces, template
    arguments and parameters."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip().split("::")[-1] or name


def collect(prof):
    """A Trace of a finished ``torch.profiler.profile`` over one segment.
    Reads the profiler's raw events, not its function-event tree, which
    takes minutes to build for a segment of 10^5 launches."""
    events = prof.profiler.kineto_results.events()
    device_ops, spans, cpu = [], [], []
    for ev in events:
        dev = str(ev.device_type())
        name = ev.name()
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if dev.endswith("CUDA"):
            if name.startswith(SPAN_PREFIX):
                continue            # a span's copy on the device timeline
            low = name.lower()
            device_ops.append((name, start, end,
                               not (low.startswith("memcpy")
                                    or low.startswith("memset"))))
        elif name.startswith(SPAN_PREFIX):
            spans.append((name, start, end))
            cpu.append((name, start, end, ev.start_thread_id()))
        else:
            cpu.append((name, start, end, ev.start_thread_id()))
    spans.sort(key=lambda s: s[1])
    window = ((spans[0][1], spans[-1][2]) if spans else (0, 0))
    main = ({t for n, s, e, t in cpu if n.startswith(SPAN_PREFIX)}
            or {None})
    host = sorted(((n, s, e) for n, s, e, t in cpu if t in main),
                  key=lambda h: (h[1], -h[2]))
    return Trace(device_ops=device_ops, spans=spans, window=window,
                 host=host)


def _parents(host):
    """Each host operation's enclosing one (-1 for none); ``host`` is
    sorted by start, longer first on a tie."""
    parent, stack = np.full(len(host), -1), []
    for i, (_, s, e) in enumerate(host):
        while stack and host[stack[-1]][2] <= s:
            stack.pop()
        if stack:
            parent[i] = stack[-1]
        stack.append(i)
    return parent


def idle_by_host(trace, top=10):
    """[label, seconds] of the idle time summed by what the host was doing:
    each gap split at the spans' edges, each piece labelled by its span's
    kind and the innermost host operation open at its middle (``python``
    where only the span itself was), the largest first."""
    gs, ge = trace.gaps()
    host = trace.host
    starts = np.array([h[1] for h in host], dtype=np.float64)
    parent = _parents(host)
    totals = defaultdict(float)
    for g0, g1 in zip(gs, ge):
        for name, s, e in trace.spans:
            p0, p1 = max(g0, s), min(g1, e)
            if p1 <= p0:
                continue
            mid = 0.5 * (p0 + p1)
            i = int(np.searchsorted(starts, mid, side="right")) - 1
            while i >= 0 and host[i][2] < mid:
                i = parent[i]
            op = host[i][0] if i >= 0 else "python"
            op = "python" if op.startswith(SPAN_PREFIX) else op
            totals[f"{SPAN_KIND.get(name, name)}: {op}"] += (p1 - p0) * 1e-9
    return sorted(([k, v] for k, v in totals.items()),
                  key=lambda kv: -kv[1])[:top]


def device_time_by_name(trace, top=10):
    """[name, seconds] of the device operations' time summed by short
    name, the largest first."""
    totals = defaultdict(float)
    w0, w1 = trace.window
    for name, s, e, _ in trace.device_ops:
        totals[short_name(name)] += max(0, min(e, w1) - max(s, w0)) * 1e-9
    return sorted(([k, v] for k, v in totals.items()),
                  key=lambda kv: -kv[1])[:top]
