"""output_event_s: the mean wall seconds of the benchmark's span around
``Simulation.emit_output`` in a segment run without the profiler, which
ends once the event's files are closed.  None in a cell without output
events."""


def read(ctx):
    spans = [e - s for name, s, e in ctx.spans
             if name == "portbench.emit_output"]
    return sum(spans) / len(spans) if spans else None
