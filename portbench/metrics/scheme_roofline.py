"""scheme_roofline: the scheme kernels' share of their bytes roofline, in
%: the step's bytes bound (costs.step_bound_s) over the device seconds
per successful step of the kernels the configuration names under
``scheme_kernels`` (matched by name in the trace).  None where no such
kernel ran."""

from portbench import costs
from portbench.trace import short_name


def read(ctx):
    names = set(ctx.config["scheme_kernels"])
    w0, w1 = ctx.trace.window
    busy = sum(min(e, w1) - max(s, w0) for name, s, e, _ in
               ctx.trace.kernels() if short_name(name) in names) * 1e-9
    if busy <= 0.0 or ctx.steps <= 0:
        return None
    bound = costs.step_bound_s(ctx.cells, ctx.precision)
    return 100.0 * bound / (busy / ctx.steps)
