"""advance_idle_pct: the share of the device's idle time inside the
benchmark's ``portbench.run_to`` spans during which the innermost of the
program's spans was ``hipims.step.advance``, the time controller, in %:
each idle stretch split at the program's span edges, each piece put down
to the innermost span open over it.  Read under the profiler, which slows
every host operation, so it is a share of the idle time, not a time.
None where the program records no such span, or without device
operations (a CPU run)."""

from portbench import spans


def read(ctx):
    tr = ctx.trace
    if not tr.device_ops or not any(
            n == "hipims.step.advance" for n, _, _ in spans.program_spans(tr)):
        return None
    idle, advance = spans.idle_under(tr, "hipims.step.advance")
    return 100.0 * advance / idle if idle > 0.0 else None
