"""Embedding API: the equivalent of the reference's DLL surface.

The reference exports a C API for a Windows GUI (reference: src/main.h:99-154
SimulationLoad/Launch/Close/Abort, GetDeviceName/Count/Current,
GetDomainInfo; src/main.cpp:161-371).  This module gives the same
lifecycle to Python applications, as hipims_tpu/api.py does: load a model,
launch it (optionally on a background thread), poll its progress, take
field snapshots at output events, abort.

``simulation_load`` runs on the first CUDA device unless the caller names
another device (``device="cpu"`` runs the kernels' plain versions on the
CPU); without CUDA the default raises, as the CLI does, and never falls
back to the CPU.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class DomainInfo:
    """Mirror of the reference's structDomainInfo (src/main.h:60-78)."""

    rows: int
    cols: int
    resolution: float
    xll: float
    yll: float
    cell_count: int
    scheme: str
    precision: str


class SimulationHandle:
    """One loaded simulation with a launch/abort lifecycle."""

    def __init__(self, model, device, mesh=None):
        self._sim = model.simulation(device=device, mesh=mesh)
        self._thread: Optional[threading.Thread] = None
        self._abort = threading.Event()
        self._error: Optional[BaseException] = None
        self._progress_cbs = []
        self._output_cbs = []
        self._snapshot = None       # live only inside on_output callbacks

    # -- reference: SimulationLaunch (main.cpp:202-230) -----------------
    def launch(self, blocking=True):
        """Run to the end: here, or on a background thread that
        ``running``, ``error`` and ``abort`` follow."""
        if blocking:
            self._sim.run(progress=self._progress_cb)
            return self
        # The current CUDA device is per thread: the run's thread takes
        # the simulation's ("cuda" alone is the caller's current device).
        dev = self._sim.device
        index = None
        if dev.type == "cuda":
            index = (dev.index if dev.index is not None
                     else torch.cuda.current_device())
        self._thread = threading.Thread(target=self._run_bg, args=(index,),
                                        daemon=True)
        self._thread.start()
        return self

    def _run_bg(self, cuda_index):
        if cuda_index is not None:
            torch.cuda.set_device(cuda_index)
        try:
            self._sim.run(progress=self._progress_cb)
        except _Aborted:
            pass
        except Exception as e:          # surfaced through .error
            self._error = e

    def _progress_cb(self, sim, t_now, elapsed):
        # Fired between batches: an abort stops the run there.
        if self._abort.is_set():
            raise _Aborted()
        for cb in self._progress_cbs:
            cb(self, t_now, elapsed)

    # -- push-style callbacks (the DLL's visualisation surface) ----------
    def on_progress(self, callback):
        """Register callback(handle, t_now, batch_elapsed), fired once per
        batch (the reference GUI's progress stream)."""
        self._progress_cbs.append(callback)
        return self

    def on_output(self, callback):
        """Register callback(handle, t), fired at every output time; inside
        it ``handle.field(...)`` reads the event's host snapshot (the
        reference DLL's cell-data callbacks, src/main.h:99-154).  It rides
        the simulation's writer chain, so it fires with the file outputs.

        The chain adopts the writer installed at registration time as its
        ``inner``; a writer added later should wrap
        ``handle.simulation.output_writer.inner``: replacing
        ``output_writer`` outright would disconnect the callbacks."""
        self._output_cbs.append(callback)
        current = self._sim.output_writer
        if not (isinstance(current, _ChainedWriter)
                and current.handle is self):
            self._sim.output_writer = _ChainedWriter(self, current)
        return self

    # -- reference: SimulationAbort (main.cpp:246-258) ------------------
    def abort(self):
        self._abort.set()
        if self._thread is not None:
            self._thread.join()

    # -- reference: SimulationClose (main.cpp:232-244) ------------------
    def close(self):
        self.abort()
        self._sim = None

    # -- polling ---------------------------------------------------------
    @property
    def time(self) -> float:
        return self._sim.t

    @property
    def progress(self) -> float:
        return min(1.0, self._sim.t / self._sim.config.duration)

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def error(self):
        return self._error

    # -- reference: GetDomainInfo (main.cpp:330-367) ---------------------
    def domain_info(self) -> DomainInfo:
        d = self._sim.domain
        return DomainInfo(rows=d.rows, cols=d.cols, resolution=d.dx,
                          xll=d.xll, yll=d.yll, cell_count=d.cell_count,
                          scheme=self._sim.config.scheme,
                          precision=self._sim.config.dtype)

    # -- field access (the DLL's visualisation callbacks) ----------------
    def field(self, value: str) -> np.ndarray:
        """One derived field (runtime/output.py VALUE_NAMES) in domain
        orientation: from the event's snapshot inside an on_output
        callback, else from a new snapshot of the run.  A streaming
        snapshot assembles only the requested field, from row chunks.
        Inside a callback of a multi-process streamed run it raises: the
        callback fires on the writing rank alone, and the chunk reads
        are collective (use io_mode="gather", or gauges)."""
        from .parallel.distributed import world_size
        from .runtime.output import derive_field
        if getattr(self._snapshot, "streaming", False) and world_size() > 1:
            raise RuntimeError(
                "field() inside an on_output callback is not available in "
                "multi-process streamed-IO runs; set io_mode='gather' (or "
                "sample gauges instead)")
        view = (self._snapshot if self._snapshot is not None
                else self._sim.output_view())
        dx, datum = self._sim.domain.dx, self._sim.domain.datum
        return np.concatenate([derive_field(value, st, sc, dx, datum=datum)
                               for _r0, st, sc in view.stream_chunks()])

    @property
    def simulation(self):
        return self._sim


class _ChainedWriter:
    """The writer installed by SimulationHandle.on_output: runs the
    adopted ``inner`` writer first (on every rank: its reads are
    collective), then, where the event writes files, the handle's
    callbacks with the event's snapshot exposed.  ``inner`` is public so
    later code can extend the chain instead of replacing it."""

    def __init__(self, handle, inner):
        self.handle = handle
        self.inner = inner

    def __call__(self, sim_view, t):
        if self.inner is not None:
            self.inner(sim_view, t)
        if not getattr(sim_view, "write_files", True):
            return
        h = self.handle
        h._snapshot = sim_view
        try:
            for cb in h._output_cbs:
                cb(h, t)
        finally:
            h._snapshot = None


class _Aborted(Exception):
    pass


def simulation_load(config_file, device=None, mesh=None) -> SimulationHandle:
    """Load an XML model configuration (reference: SimulationLoad,
    src/main.cpp:180-200) onto ``device``: None is the first CUDA device,
    and raises without CUDA; or onto the blocks of ``mesh`` (a
    ``parallel.Mesh``), whose first device is then the simulation's."""
    from .io.xml_config import load_config
    if mesh is not None:
        return SimulationHandle(load_config(config_file), device, mesh)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("simulation_load: CUDA is not available (no "
                               "device or a CPU-only PyTorch); pass "
                               "device='cpu' to run the plain versions on "
                               "the CPU")
        device = torch.device("cuda", 0)
    return SimulationHandle(load_config(config_file), torch.device(device))


def device_count() -> int:
    """Reference: GetDeviceCount (src/main.cpp:294-308)."""
    return torch.cuda.device_count()


def cluster_groups() -> dict:
    """The process groups of a multi-process run
    (``parallel.distributed.groups``): ``world``, the gloo group's backend,
    and ``device``, "nccl" where every rank holds a card of its own and
    the halo strips and maxima move card to card, None where they go
    through the host; both None in one process."""
    from .parallel.distributed import groups
    return groups()


def device_name(index: int = 0) -> str:
    """Reference: GetDeviceName (src/main.cpp:262-292)."""
    return torch.cuda.get_device_name(index)
