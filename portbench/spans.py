"""The program's own spans in a traced segment.

hipims_tpu_torch records host events named ``hipims.<layer>...`` in any
torch profiler that runs around it (its ``utils/trace.py``): plain CPU
operations on the main thread, on the clock of the device's operations,
which ``trace.collect`` keeps in ``Trace.host`` beside the ``aten::``
operations and the CUDA runtime's calls.  A program that records none (an
older commit) gives no spans here, and every reader of them returns None.
"""

from __future__ import annotations

import numpy as np

from portbench.trace import _parents

PREFIX = "hipims."


def program_spans(trace):
    """(name, start, end) of the program's spans, by start, longer first
    on a tie (``Trace.host``'s order)."""
    return [h for h in trace.host if h[0].startswith(PREFIX)]


def innermost_at(spans, times):
    """The name of the innermost of ``spans`` (``program_spans``) open at
    each of ``times`` (None outside every span): the search and the climb
    through enclosing spans that ``trace.idle_by_host`` makes."""
    if not spans:
        return [None] * len(times)
    starts = np.array([s for _, s, _ in spans], dtype=np.float64)
    ends = np.array([e for _, _, e in spans], dtype=np.float64)
    parent = _parents(spans)
    t = np.asarray(times, dtype=np.float64)
    i = np.searchsorted(starts, t, side="right") - 1
    while True:
        out = (i >= 0) & (ends[np.maximum(i, 0)] <= t)
        if not out.any():
            break
        i = np.where(out, parent[np.maximum(i, 0)], i)
    return [spans[k][0] if k >= 0 else None for k in i]


def idle_under(trace, name):
    """(seconds of device idle time inside the benchmark's
    ``portbench.run_to`` spans, the part of it during which the innermost
    program span is ``name``): the time cut at every gap's, span's and
    ``run_to``'s edge, each piece labelled at its middle."""
    gs, ge = trace.gaps()
    run_to = sorted((s, e) for n, s, e in trace.spans
                    if n == "portbench.run_to")
    spans = program_spans(trace)
    if not gs.size or not run_to:
        return 0.0, 0.0
    r0 = np.array([s for s, _ in run_to], dtype=np.float64)
    r1 = np.array([e for _, e in run_to], dtype=np.float64)
    cuts = np.unique(np.concatenate(
        [gs, ge, r0, r1, [s for _, s, _ in spans], [e for _, _, e in spans]]))
    mid, width = 0.5 * (cuts[1:] + cuts[:-1]), np.diff(cuts)

    def inside(lo, hi):
        k = np.searchsorted(lo, mid, side="right") - 1
        return (k >= 0) & (mid < hi[np.maximum(k, 0)])

    keep = inside(gs, ge) & inside(r0, r1)
    mid, width = mid[keep], width[keep]
    hit = np.array([n == name for n in innermost_at(spans, mid)], dtype=bool)
    return float(width.sum()) * 1e-9, float(width[hit].sum()) * 1e-9


def share_of_event(ctx, name):
    """The share of the profiled output events (``hipims.output.event``
    spans) that the spans ``name`` take, times the mean seconds of the
    benchmark's span around ``emit_output`` in the segment run without
    the profiler: the part's seconds an event on the unprofiled clock.
    The profiler slows an event (numpy and zlib included) by about a
    tenth, so the profiled spans' own seconds would count that slowing.
    None without either span, or without unprofiled events."""
    spans = program_spans(ctx.trace)
    event = sum(e - s for n, s, e in spans if n == "hipims.output.event")
    part = sum(e - s for n, s, e in spans if n == name)
    plain = [e - s for n, s, e in ctx.spans if n == "portbench.emit_output"]
    if event <= 0 or not part or not plain:
        return None
    return part / event * sum(plain) / len(plain)
