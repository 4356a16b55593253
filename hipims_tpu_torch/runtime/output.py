"""Raster output writing with derived fields and %t filename substitution.

Mirrors CRasterDataset::domainToRaster (reference:
src/Datasets/CRasterDataset.cpp:101-290): depth/maxdepth clamp + 1e-8
nodata floor, velocity = Q/h (nodata when dry), Froude = |v|/sqrt(gh),
discharge scaled by cell resolution, FSL/maxFSL masked on dry or walled
cells, -9999 nodata, bottom-up row order.

Point gauges (GaugeOutputWriter, an extension over the reference) append
one CSV row per output event.  A writer is called with an output event's
snapshot (runtime/simulation.py ``output_view``), or with the simulation,
of which it takes one: the gathered host copy of the grid or the streamed
view (io_mode "stream", runtime/sharded_io.py).  Both are read alike: row
chunks feed the rasters north-first in one pass (the gathered copy is one
chunk), and sampled cells feed the gauges, so both give the same bytes:
the same ``derive_field`` on the same float64 values, through the same
strip writers.  Every rank of a multi-process run calls the writers,
since their reads are collective (parallel/distributed.py); each writes
files only where the snapshot's ``write_files`` is set.
"""

from __future__ import annotations

import numpy as np

from .. import constants as C
from ..io.raster import Raster, write_raster
from ..parallel.distributed import is_coordinator
from ..utils import time_label
from ..utils.trace import span

NODATA = -9999.0
_EPS = 1e-8

VALUE_NAMES = ("depth", "maxdepth", "fsl", "maxfsl", "velocityx",
               "velocityy", "dischargex", "dischargey", "froude", "dem",
               "manningcoefficient")

def derive_field(value: str, state, static, resolution: float,
                 datum: float = 0.0) -> np.ndarray:
    """Compute one output field (domain orientation) with nodata masking.

    ``datum`` is the vertical shift removed from device-side elevations
    (Domain.build datum_shift); absolute-elevation outputs (fsl, maxfsl,
    dem) add it back in float64 here."""
    value = value.strip().lower()
    z = np.asarray(state.z, dtype=np.float64)
    zmax = np.asarray(state.zmax, dtype=np.float64)
    qx = np.asarray(state.qx, dtype=np.float64)
    qy = np.asarray(state.qy, dtype=np.float64)
    zb = np.asarray(static.zb, dtype=np.float64)
    h = z - zb

    if value == "depth":
        out = np.maximum(0.0, h)
        out[out < _EPS] = NODATA
    elif value == "maxdepth":
        out = np.maximum(0.0, zmax - zb)
        out[(out < _EPS) | (out <= -9990.0) | (out >= 9999.0)] = NODATA
    elif value == "fsl":
        out = z + datum
        out[(z < zb + _EPS) | (zb > 9999.0)] = NODATA
    elif value == "maxfsl":
        out = zmax + datum
        out[(zmax < zb + _EPS) | (zb > 9999.0)] = NODATA
    elif value == "velocityx":
        out = np.where(h > _EPS, qx / np.where(h > _EPS, h, 1.0), NODATA)
    elif value == "velocityy":
        out = np.where(h > _EPS, qy / np.where(h > _EPS, h, 1.0), NODATA)
    elif value == "dischargex":
        out = qx * resolution
    elif value == "dischargey":
        out = qy * resolution
    elif value == "froude":
        hs = np.where(h > _EPS, h, 1.0)
        vel = np.hypot(qx / hs, qy / hs)
        out = np.where(h > _EPS, vel / np.sqrt(C.GRAVITY * hs), NODATA)
    elif value == "dem":
        out = zb + datum
        out[zb > 9999.0] = C.CLOSED_EDGE_ELEVATION
    elif value == "manningcoefficient":
        out = np.asarray(static.manning, dtype=np.float64).copy()
    else:
        raise ValueError(f"unknown output value '{value}'")
    return out


class GaugeOutputWriter:
    """Appends point-gauge samples of one field to a CSV at every output
    time: one row per time, one column per gauge (the same file as the
    JAX package's writer, row for row).  Every rank samples; the writing
    rank appends."""

    def __init__(self, value, gauges, target_path, domain):
        """gauges: [(x_world, y_world, name)]; gauges off the grid are
        dropped.  The header is written by rank 0 alone, so a late rank
        cannot truncate the rows rank 0 has appended."""
        import os
        self.value = value
        self.domain = domain
        self.target_path = target_path
        os.makedirs(os.path.dirname(str(target_path)) or ".", exist_ok=True)
        self.cells = []
        names = []
        for x, y, name in gauges:
            ci = int((x - domain.xll) / domain.dx)
            ri = int((y - domain.yll) / domain.dy)
            if 0 <= ri < domain.rows and 0 <= ci < domain.cols:
                self.cells.append((ri, ci))
                names.append(name)
        if is_coordinator():
            with open(target_path, "w") as f:
                f.write("Time (s)," + ",".join(names) + "\n")

    def __call__(self, sim, t: float):
        # Every field is derived cell by cell, so derive it on the gauge
        # cells alone (on a streamed snapshot, read on the device).
        idx = tuple(np.asarray(self.cells, dtype=np.int64).reshape(-1, 2).T)
        view = sim.output_view()
        state, static = view.sample_cells(*idx)
        if not view.write_files:
            return
        with span("hipims.output.derive"):
            vals = derive_field(self.value, state, static, sim.domain.dx,
                                datum=sim.domain.datum)
        # Derived fields set the sentinel exactly; a tight absolute
        # tolerance maps it to 0 without a wide isclose window around
        # real near--9999 values.
        vals = [0.0 if abs(v - NODATA) <= 1e-6 else v for v in vals]
        with open(self.target_path, "a") as f:
            f.write(f"{t:.6f}," + ",".join(f"{v:.6f}" for v in vals) + "\n")


class CompositeOutputWriter:
    """Fans one output event out to several writers (rasters + gauges)."""

    def __init__(self, writers):
        self.writers = list(writers)

    def __call__(self, sim, t: float):
        for w in self.writers:
            w(sim, t)


def read_gauge_map(path):
    """(x, y, name) rows from a gauge map CSV (the shape of the cell
    boundary map files, reference: CBoundaryCell::importMap); a row
    without a name is called G<n>."""
    import csv
    gauges = []
    with open(path, newline="") as f:
        for rec in csv.reader(f):
            rec = [c.strip() for c in rec if c.strip() != ""]
            if len(rec) < 2:
                continue
            try:
                x, y = float(rec[0]), float(rec[1])
            except ValueError:
                continue
            name = rec[2] if len(rec) >= 3 else f"G{len(gauges) + 1}"
            gauges.append((x, y, name))
    return gauges


class _AssembleRows:
    """The strip sink of HFA, which has no streaming container here: the
    rows are kept on the host and the file written at close.  They keep
    the derived field's float64, as the gathered raster does, so the file
    is the same bytes (the JAX package's keeps float32)."""

    def __init__(self, path, fmt, xll, yll, cell_size):
        self.path, self.fmt = path, fmt
        self.xll, self.yll, self.cell_size = xll, yll, cell_size
        self._rows = []

    def write_rows(self, block):
        self._rows.append(np.asarray(block))

    def close(self):
        with span("hipims.output.encode"):
            write_raster(self.path,
                         Raster(data=np.concatenate(self._rows),
                                xll=self.xll, yll=self.yll,
                                cell_size=self.cell_size, nodata=NODATA),
                         fmt=self.fmt)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()


class RasterOutputWriter:
    """Writes the configured <dataTarget> rasters at each output time.

    The event's snapshot is read once, chunk by chunk, north-first (a
    gathered snapshot is one chunk), and every target's rows go to its
    strip sink: TIFF and ASC files are written as the rows arrive; HFA
    rows are kept until the file is written at close.  A rank that does
    not write files reads the chunks all the same, and opens no sink."""

    def __init__(self, targets, target_dir, domain):
        """targets: list of dicts with keys value, format, target (filename
        mask with %t)."""
        import os
        self.targets = targets
        self.target_dir = target_dir
        self.domain = domain
        os.makedirs(target_dir, exist_ok=True)

    def _open_strip_writer(self, path, fmt, rows, cols):
        from ..io.raster import AscStripWriter, TiffStripWriter
        d = self.domain
        if fmt in ("asc", "aaigrid"):
            return AscStripWriter(path, cols, rows, xll=d.xll, yll=d.yll,
                                  cell_size=d.dx, nodata=NODATA)
        if fmt in ("tif", "tiff", "gtiff"):
            return TiffStripWriter(path, cols, rows, xll=d.xll, yll=d.yll,
                                   cell_size=d.dx, nodata=NODATA)
        if fmt in ("hfa", "img"):
            return _AssembleRows(path, fmt, d.xll, d.yll, d.dx)
        raise ValueError(f"unsupported raster output format '{fmt}'")

    def __call__(self, sim, t: float):
        from contextlib import ExitStack
        from pathlib import Path
        view = sim.output_view()
        d = view.domain
        # Each sink is a context: on an exception every sink already open
        # is closed (a TIFF's strips in flight waited out) before it rises.
        with ExitStack() as stack:
            sinks = [stack.enter_context(self._open_strip_writer(
                         Path(self.target_dir)
                         / tgt["target"].replace("%t", time_label(t)),
                         tgt.get("format", "tif").lower(), d.rows, d.cols))
                     for tgt in self.targets] if view.write_files else []
            # One pass over the chunks feeds every target.
            for _r0, st, sc in view.stream_chunks(reverse=True):
                for tgt, sink in zip(self.targets, sinks):
                    with span("hipims.output.derive"):
                        field = derive_field(tgt["value"], st, sc, d.dx,
                                             datum=d.datum)
                    sink.write_rows(field[::-1])
