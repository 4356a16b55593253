"""Named spans at the program's layer boundaries, for ``torch.profiler``.

``span(name)`` is a context manager.  While a torch profiler runs it
records one host event named ``name`` in that profiler, on the clock of
the profiler's other events (the ``aten::`` operations, the CUDA runtime
calls and the device's kernels), so a trace shows which layer the host
was in while the device waited.  With no profiler running it returns a
shared no-op after one flag check: no torch operation, no allocation.

The event is recorded with ``torch._C._profiler._RecordFunctionFast``, a
private class, wrapped here alone, for two reasons:

- it records a plain ``cpu_op``.  ``torch.profiler.record_function``
  records a ``user_annotation``, and the profiler copies every user
  annotation that encloses device work onto the device's timeline, where
  a batch's span would read as the device busy for the whole batch;
- it costs 1.3-1.6 us of host time a span under a profiler on an H100
  machine's host CPU, against 8-10 for ``record_function``; with none
  running, ``span`` enters neither and timed the same there as entering
  an empty ``contextlib.nullcontext``.

Where the installed torch lacks the class, spans are off: falling back to
``record_function`` would put the spans on the device's timeline.

Every name starts with ``hipims.``; the spans and what they cover:

- ``hipims.batch``: one batch of steps (``Simulation._run_batch``,
  ``HaloDeepBlocks.run_batch``), its NaN probe included;
- ``hipims.step.boundaries`` / ``.scheme`` / ``.advance``: a step's
  boundary pass (only where there are boundaries), fused scheme step and
  time controller, on one device and on each block of a mesh;
- ``hipims.batch.read``: the batch's one host read of the carry, and its
  wait on the device; ``hipims.batch.agree``: the carries agreed across
  processes;
- ``hipims.output.event``: one output event; inside it
  ``hipims.output.snapshot`` (the snapshot and each chunk's or gauge
  sample's host copy), ``hipims.output.derive`` (each derived field),
  ``hipims.output.encode`` (a raster writer's work on the calling thread:
  encoding rows, handing GeoTIFF strips to the deflate pool, every wait on
  the pool, at its in-flight cap and in ``close``'s drain, and the writes;
  the pool's threads record no span) and ``hipims.output.checkpoint``;
- ``hipims.mesh.halo`` (the halo strips' exchange) and ``hipims.mesh.max``
  (the cross-block and cross-rank maxima and NaN probe sums);
- ``hipims.kernels.build`` (an nvcc run) and ``hipims.kernels.load``
  (loading a kernel library).
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _autograd_profiler

RecordFunctionFast = getattr(getattr(torch._C, "_profiler", None),
                             "_RecordFunctionFast", None)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records the span ``name`` while a torch
    profiler runs, and does nothing otherwise."""
    if RecordFunctionFast is None or \
            not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return RecordFunctionFast(name)
