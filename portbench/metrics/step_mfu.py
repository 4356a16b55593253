"""step_mfu: the whole step's share of the card's peak, in %: the bytes
bound of one step (costs.step_bound_s: the state planes read and written
once) over the wall seconds per successful step of the ``run_to`` calls
of a segment run without the profiler (host clock, output events
excluded).  A later PR that fuses or removes a kernel still moves this
share."""

from portbench import costs


def read(ctx):
    run_s = sum(e - s for name, s, e in ctx.spans
                if name == "portbench.run_to")
    if ctx.steps <= 0 or run_s <= 0.0:
        return None
    bound = costs.step_bound_s(ctx.cells, ctx.precision)
    return 100.0 * bound / (run_s / ctx.steps)
