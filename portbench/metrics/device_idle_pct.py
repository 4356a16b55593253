"""device_idle_pct: the share of a segment's wall time in which no
operation ran on the device, in %: one less the device's busy seconds in
the traced segment (the union of its operations' intervals, not a sum
of kernel times) over the wall seconds of the same segment run without
the profiler.  Both segments run the same kernels, but the profiler
slows this host-bound loop by about half, so its own window would count
the profiler's cost as idle.

On a mesh, NCCL's kernels are not busy time (``trace.is_nccl``): a
collective's kernel spins on the card until every rank has reached it,
so the exchange's seconds count as idle.  They are the time that the
host and the exchange hold the card back, which this share is to show;
``nccl_s`` in the result's ``device`` gives their union apart."""


def read(ctx):
    busy = ctx.trace.busy_s()
    if not ctx.trace.device_ops or busy <= 0.0 or ctx.wall <= 0.0:
        return None
    return 100.0 * (1.0 - busy / ctx.wall)
