"""launches_per_step: device kernels in the traced segment over its
steps, idle steps included (the host's boundary pass, ``advance`` and the
scheme kernels all launch on every step)."""


def read(ctx):
    steps = ctx.steps + ctx.idle
    kernels = len(ctx.trace.kernels())
    if steps <= 0 or kernels == 0:
        return None
    return kernels / steps
