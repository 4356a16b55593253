"""advance_launches_per_step: the host's kernel launch calls (CUDA
runtime events ``cudaLaunchKernel*`` / ``cuLaunchKernel*``) made while the
innermost of the program's spans was ``hipims.step.advance``, the time
controller, over the traced segment's steps, idle steps included.  A
count that repeats exactly.  None where the program records no such span,
or where the trace has no launch calls (a CPU run)."""

from portbench import spans

LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")


def read(ctx):
    program = spans.program_spans(ctx.trace)
    launches = [s for n, s, e in ctx.trace.host if n.startswith(LAUNCHES)]
    steps = ctx.steps + ctx.idle
    if (steps <= 0 or not launches
            or not any(n == "hipims.step.advance" for n, _, _ in program)):
        return None
    labels = spans.innermost_at(program, launches)
    return sum(n == "hipims.step.advance" for n in labels) / steps
