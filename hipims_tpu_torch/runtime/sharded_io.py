"""Bounded-memory output and checkpoint I/O for large grids.

The reference writes each domain's raster from its own device
(src/Domain/Cartesian/CDomainCartesian.cpp:804-829) and never gathers the
grid anywhere.  This module is the port's large-grid path, the
counterpart of hipims_tpu/runtime/sharded_io.py; the gathered path
(``simulation._OutputSnapshot``), which copies every plane to the host
once per output event, reads through the same functions, its planes host
arrays read as one chunk:

* ``stream_rows`` iterates a plane as bounded row chunks, each copied
  straight to the host: a row slice of a tensor on its device, or, under
  a mesh, the owned cells of the blocks the rows cross
  (``parallel.halo_deep.OwnedPlane``).  Peak host memory is one chunk,
  never the grid.  ``host_cells`` reads a few cells the same way
  (gauges).  Across processes a mesh plane's read is collective: each
  rank copies the parts its blocks own, and one all-gather of the ranks'
  parts, padded to the largest (as JAX's ``process_allgather``), gives
  every rank the whole chunk, byte for byte, -0.0 and NaN included; so
  every rank drives the same reads, and only the writing rank writes.
* ``StreamingCheckpointWriter`` writes an ``np.load``-able .npz
  incrementally: each plane streams chunk by chunk into one stored
  (uncompressed) zip member, as ``np.savez`` stores them.

The rasters are written row by row by io/raster.py's ``AscStripWriter``
and ``TiffStripWriter``, which the gathered raster writers there feed one
block; runtime/output.py feeds them the chunks north-first, so streamed
and gathered raster files are the same bytes.
"""

from __future__ import annotations

import zipfile

import numpy as np
import torch


def chunk_rows_for(cols, n_fields=1, budget_mb=64):
    """Rows per chunk so one chunk set (all fields) stays under
    ``budget_mb`` of host memory, 8-row aligned.  Counts 4 bytes a value,
    as the JAX package does, so float64 chunk sets reach twice the budget
    and the chunk boundaries are the JAX package's."""
    bytes_per_row = max(1, cols * 4 * max(1, n_fields))
    rows = max(8, (budget_mb << 20) // bytes_per_row)
    return (rows // 8) * 8


def host_dtype(plane):
    """The numpy dtype of ``plane``'s host chunks."""
    if isinstance(plane, torch.Tensor):
        return torch.empty((), dtype=plane.dtype).numpy().dtype
    return np.dtype(plane.dtype)


def host_rows(plane, r0, n):
    """Rows [r0, r0 + n) of ``plane`` as a host numpy array: a tensor's
    row slice copied off its device, a host array's row slice, or a plane
    object's ``host_rows`` (the owned cells of a mesh's blocks)."""
    if isinstance(plane, torch.Tensor):
        return plane[r0:r0 + n].cpu().numpy()
    if isinstance(plane, np.ndarray):
        return plane[r0:r0 + n]
    return plane.host_rows(r0, n)


def host_cells(plane, rows, cols):
    """The (K,) values of ``plane`` at cells (rows[k], cols[k]) as a host
    array: indexed on the plane's device, only the K values copied."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    if isinstance(plane, torch.Tensor):
        ri = torch.as_tensor(rows, device=plane.device)
        ci = torch.as_tensor(cols, device=plane.device)
        return plane[ri, ci].cpu().numpy()
    if isinstance(plane, np.ndarray):
        return plane[rows, cols]
    return plane.host_cells(rows, cols)


def chunk_starts(rows, chunk_rows, reverse=False):
    """The first row of each chunk; the same boundaries in both
    directions."""
    starts = list(range(0, rows, chunk_rows))
    return starts[::-1] if reverse else starts


def stream_rows(plane, chunk_rows, reverse=False):
    """Yield ``(row0, host_chunk)`` covering rows [0, R) of ``plane`` in
    chunks of at most ``chunk_rows`` rows, in descending row order with
    ``reverse=True`` (rasters are written north-first, domain arrays are
    south-up).  The JAX package's ``stream_global_rows``."""
    rows = plane.shape[0]
    for r0 in chunk_starts(rows, chunk_rows, reverse):
        yield r0, host_rows(plane, r0, min(chunk_rows, rows - r0))


class StreamingCheckpointWriter:
    """Writes an ``np.load``-able .npz incrementally: one stored
    ``<key>.npy`` member per ``add_array`` or ``stream_array``, a plane's
    data arriving chunk by chunk so no plane is assembled on the host.
    Members are stored, not deflated, as in the port's gathered
    checkpoint (runtime/checkpoint.py)."""

    def __init__(self, path):
        self._zf = zipfile.ZipFile(path, "w", zipfile.ZIP_STORED)

    def add_array(self, key, value):
        arr = np.asarray(value)
        with self._zf.open(key + ".npy", "w", force_zip64=True) as f:
            np.lib.format.write_array(f, arr, allow_pickle=False)

    def stream_array(self, key, shape, dtype, chunks):
        """One array of ``shape`` from an iterable of row chunks in
        ascending row order."""
        dtype = np.dtype(dtype)
        with self._zf.open(key + ".npy", "w", force_zip64=True) as f:
            np.lib.format.write_array_header_2_0(
                f, dict(descr=np.lib.format.dtype_to_descr(dtype),
                        fortran_order=False, shape=tuple(shape)))
            written = 0
            for chunk in chunks:
                chunk = np.ascontiguousarray(np.asarray(chunk, dtype))
                f.write(chunk.tobytes())
                written += chunk.shape[0]
            if written != shape[0]:
                # A short member would fail np.load at resume: fail the
                # save instead (an exception, not an assert: python -O).
                raise ValueError(f"{key}: streamed {written} of "
                                 f"{shape[0]} rows")

    def close(self):
        self._zf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
