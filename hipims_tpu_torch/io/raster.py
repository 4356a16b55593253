"""Raster read/write without GDAL.

Formats:
  * ESRI ASCII grid (.asc)        — read + write (streaming-capable)
  * GeoTIFF (.tif/.tiff)          — read (classic + BigTIFF;
                                    uncompressed/deflate strips or tiles)
                                    + write (deflate-compressed float32
                                    strips, deflated on a pool of host
                                    threads and written in order,
                                    streaming-capable, auto-BigTIFF
                                    past 4 GB, GeoTIFF georeferencing
                                    + GDAL nodata tag)

  * Erdas Imagine HFA (.img)      — read (uncompressed and RLC blocks)
                                    + write (io/hfa.py)

A numpy-only copy of hipims_tpu/io/raster.py (the port never imports the
JAX package); ASC bodies are formatted by the native host codec where it
builds (native/), else by numpy.savetxt, to the same bytes.  Replaces the
reference's CRasterDataset GDAL wrapper
(src/Datasets/CRasterDataset.cpp:73-315 read, :101-290 write).
"""

from __future__ import annotations

import dataclasses
import os
import struct
import threading
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np

from ..utils.trace import span


@dataclasses.dataclass
class Raster:
    """A single-band georeferenced grid in map orientation (row 0 = north)."""

    data: np.ndarray
    xll: float = 0.0            # lower-left corner x
    yll: float = 0.0            # lower-left corner y
    cell_size: float = 1.0
    nodata: Optional[float] = -9999.0

    @property
    def rows(self):
        return self.data.shape[0]

    @property
    def cols(self):
        return self.data.shape[1]

    def to_domain_array(self) -> np.ndarray:
        """Domain orientation: row 0 = south (reference bottom-up flip,
        src/Datasets/CRasterDataset.cpp applyDataToDomain)."""
        return np.ascontiguousarray(self.data[::-1, :])

    @classmethod
    def from_domain_array(cls, arr, xll=0.0, yll=0.0, cell_size=1.0,
                          nodata=-9999.0) -> "Raster":
        return cls(data=np.ascontiguousarray(np.asarray(arr)[::-1, :]),
                   xll=xll, yll=yll, cell_size=cell_size, nodata=nodata)


# ---------------------------------------------------------------- ASC ----

def _read_asc(path: Path) -> Raster:
    header = {}
    data_start = 0
    with open(path) as f:
        lines = f.readlines()
    for i, line in enumerate(lines):
        parts = line.split()
        if len(parts) == 2 and parts[0].lower() in (
                "ncols", "nrows", "xllcorner", "yllcorner", "cellsize",
                "nodata_value", "xllcenter", "yllcenter"):
            header[parts[0].lower()] = float(parts[1])
        else:
            data_start = i
            break
    rows = int(header["nrows"])
    cols = int(header["ncols"])
    data = np.loadtxt(lines[data_start:]).reshape(rows, cols)
    cs = header.get("cellsize", 1.0)
    xll = header.get("xllcorner", header.get("xllcenter", 0.0)
                    - cs / 2 if "xllcenter" in header else 0.0)
    yll = header.get("yllcorner", header.get("yllcenter", 0.0)
                    - cs / 2 if "yllcenter" in header else 0.0)
    return Raster(data=data, xll=xll, yll=yll, cell_size=cs,
                  nodata=header.get("nodata_value", -9999.0))


class AscStripWriter:
    """Incremental ESRI ASCII grid writer: rows stream in (top-down, map
    orientation) and are formatted as they arrive, by the native host
    codec where it builds, else ``np.savetxt`` (the same bytes); the
    gathered writer is this one fed a single block, so streamed and
    gathered files are the same bytes (runtime/sharded_io.py)."""

    def __init__(self, path, width, height, xll=0.0, yll=0.0,
                 cell_size=1.0, nodata=-9999.0):
        self.width, self.height = int(width), int(height)
        self._rows_in = 0
        self._f = open(path, "wb")
        self._f.write((f"ncols {width}\n"
                       f"nrows {height}\n"
                       f"xllcorner {xll}\n"
                       f"yllcorner {yll}\n"
                       f"cellsize {cell_size}\n"
                       f"NODATA_value {nodata}\n").encode())

    def write_rows(self, block):
        from ..native import asc_format_native
        with span("hipims.output.encode"):
            block = np.asarray(block, np.float64)
            if block.ndim == 1:
                block = block[None, :]
            self._rows_in += block.shape[0]
            body = asc_format_native(block)
            if body is not None:
                self._f.write(body)
            else:
                np.savetxt(self._f, block, fmt="%.6f")

    def close(self):
        self._f.close()
        if self._rows_in != self.height:
            raise ValueError(f"wrote {self._rows_in} of {self.height} "
                             "rows; refusing to emit a truncated grid")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()
        else:
            self._f.close()


def _write_asc(path: Path, raster: Raster):
    with AscStripWriter(path, raster.cols, raster.rows, xll=raster.xll,
                        yll=raster.yll, cell_size=raster.cell_size,
                        nodata=raster.nodata) as w:
        w.write_rows(raster.data)


# ------------------------------------------------------------- GeoTIFF ----

_TIFF_TYPES = {1: ("B", 1), 2: ("s", 1), 3: ("H", 2), 4: ("I", 4),
               5: ("II", 8), 11: ("f", 4), 12: ("d", 8), 16: ("Q", 8),
               17: ("q", 8), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8)}

TAG_WIDTH, TAG_HEIGHT = 256, 257
TAG_BITS, TAG_COMPRESSION, TAG_PHOTOMETRIC = 258, 259, 262
TAG_STRIP_OFFSETS, TAG_SAMPLES_PER_PIXEL = 273, 277
TAG_ROWS_PER_STRIP, TAG_STRIP_BYTECOUNTS = 278, 279
TAG_PLANAR = 284
TAG_PREDICTOR = 317
TAG_TILE_WIDTH, TAG_TILE_HEIGHT = 322, 323
TAG_TILE_OFFSETS, TAG_TILE_BYTECOUNTS = 324, 325
TAG_SAMPLE_FORMAT = 339
TAG_MODEL_PIXEL_SCALE, TAG_MODEL_TIEPOINT = 33550, 33922
TAG_GDAL_NODATA = 42113


def _read_tiff(path: Path) -> Raster:
    buf = open(path, "rb").read()
    endian = buf[:2]
    if endian == b"II":
        e = "<"
    elif endian == b"MM":
        e = ">"
    else:
        raise ValueError(f"{path}: not a TIFF")
    (magic,) = struct.unpack(e + "H", buf[2:4])
    if magic == 42:                       # classic TIFF
        big = False
        (ifd_off,) = struct.unpack(e + "I", buf[4:8])
    elif magic == 43:                     # BigTIFF
        big = True
        osize, zero, ifd_off = struct.unpack(e + "HHQ", buf[4:16])
        if osize != 8 or zero != 0:
            raise ValueError(f"{path}: malformed BigTIFF header")
    else:
        raise ValueError(f"{path}: unsupported TIFF magic {magic}")

    tags = {}
    if big:
        (n_entries,) = struct.unpack(e + "Q", buf[ifd_off:ifd_off + 8])
        ent0, ent_size, inline = ifd_off + 8, 20, 8
    else:
        (n_entries,) = struct.unpack(e + "H", buf[ifd_off:ifd_off + 2])
        ent0, ent_size, inline = ifd_off + 2, 12, 4
    for i in range(n_entries):
        off = ent0 + i * ent_size
        if big:
            tag, typ, count = struct.unpack(e + "HHQ", buf[off:off + 12])
        else:
            tag, typ, count = struct.unpack(e + "HHI", buf[off:off + 8])
        fmt, size = _TIFF_TYPES.get(typ, ("B", 1))
        total = size * count
        val_off = off + (12 if big else 8)
        if total <= inline:
            raw = buf[val_off:val_off + total]
        else:
            (ptr,) = struct.unpack(e + ("Q" if big else "I"),
                                   buf[val_off:val_off + inline])
            raw = buf[ptr:ptr + total]
        if typ == 2:
            tags[tag] = raw.rstrip(b"\0").decode("ascii", "replace")
        elif typ in (5, 10):
            vals = struct.unpack(e + "II" * count, raw)
            tags[tag] = [vals[2 * k] / max(vals[2 * k + 1], 1)
                         for k in range(count)]
        else:
            tags[tag] = list(struct.unpack(e + fmt * count, raw))

    width = tags[TAG_WIDTH][0]
    height = tags[TAG_HEIGHT][0]
    bits = tags.get(TAG_BITS, [32])[0]
    comp = tags.get(TAG_COMPRESSION, [1])[0]
    fmt_code = tags.get(TAG_SAMPLE_FORMAT, [3])[0]
    if tags.get(TAG_SAMPLES_PER_PIXEL, [1])[0] != 1:
        raise ValueError("only single-band TIFFs supported")

    if fmt_code == 3:
        dt = {32: np.float32, 64: np.float64}[bits]
    elif fmt_code == 2:
        dt = {8: np.int8, 16: np.int16, 32: np.int32}[bits]
    else:
        dt = {8: np.uint8, 16: np.uint16, 32: np.uint32}[bits]
    dt = np.dtype(dt).newbyteorder(e)

    def decode(chunk):
        if comp == 1:
            return chunk
        if comp in (8, 32946):          # deflate
            return zlib.decompress(chunk)
        raise ValueError(f"unsupported TIFF compression {comp}")

    if TAG_TILE_OFFSETS in tags:
        tw = tags[TAG_TILE_WIDTH][0]
        th = tags[TAG_TILE_HEIGHT][0]
        data = np.zeros((height, width), dtype=dt)
        tiles_x = -(-width // tw)
        offs = tags[TAG_TILE_OFFSETS]
        cnts = tags[TAG_TILE_BYTECOUNTS]
        for idx, (o, c) in enumerate(zip(offs, cnts)):
            ty, tx = divmod(idx, tiles_x)
            tile = np.frombuffer(decode(buf[o:o + c]), dtype=dt)
            tile = tile[:tw * th].reshape(th, tw)
            y0, x0 = ty * th, tx * tw
            data[y0:y0 + th, x0:x0 + tw] = tile[
                :min(th, height - y0), :min(tw, width - x0)]
    else:
        rps = tags.get(TAG_ROWS_PER_STRIP, [height])[0]
        offs = tags[TAG_STRIP_OFFSETS]
        cnts = tags.get(TAG_STRIP_BYTECOUNTS,
                        [width * rps * dt.itemsize] * len(offs))
        parts = []
        for o, c in zip(offs, cnts):
            parts.append(np.frombuffer(decode(buf[o:o + c]), dtype=dt))
        data = np.concatenate(parts)[:height * width].reshape(height, width)

    if tags.get(TAG_PREDICTOR, [1])[0] != 1:
        raise ValueError("TIFF predictor not supported")

    cell = tags.get(TAG_MODEL_PIXEL_SCALE, [1.0, 1.0])[0]
    tie = tags.get(TAG_MODEL_TIEPOINT, [0.0] * 6)
    # Tiepoint maps raster (0,0) [top-left] to world (tie[3], tie[4]).
    xul, yul = tie[3], tie[4]
    nodata = tags.get(TAG_GDAL_NODATA)
    nodata = float(nodata) if nodata is not None else None
    return Raster(data=np.ascontiguousarray(data.astype(data.dtype.newbyteorder("="))),
                  xll=xul, yll=yul - height * cell, cell_size=cell,
                  nodata=nodata)


# ------------------------------------------------------ deflate pool ----
#
# A GeoTIFF's strips are independent deflate streams and zlib releases the
# GIL, so TiffStripWriter compresses them on one process-wide pool of host
# threads and writes them in strip order: the bytes of compressing them
# one after another.

_lock = threading.Lock()
_pool = None        # the deflate pool, made at first use
_pool_size = 0
_counts = {"pool": 0, "in_flight": 0, "most_in_flight": 0}
_CGROUP = "/proc/self/cgroup"
_CGROUP_ROOT = "/sys/fs/cgroup"


def _deflate(raw):
    return zlib.compress(raw, 6)


def _usable_cores() -> int:
    """The cores this process may run on: its affinity mask, capped by the
    tightest cgroup v2 ``cpu.max`` quota of its cgroup and the cgroup's
    ancestors, where those files can be read (cgroup v1 quotas are not
    read)."""
    cores = len(os.sched_getaffinity(0))
    try:
        with open(_CGROUP) as f:
            group = next((line.strip()[3:] for line in f
                          if line.startswith("0::")), None)
    except OSError:
        group = None
    if group is None:
        return cores
    parts = [p for p in group.split("/") if p]
    for depth in range(len(parts), -1, -1):
        try:
            with open("/".join([_CGROUP_ROOT, *parts[:depth], "cpu.max"])) as f:
                quota, period = f.read().split()
            if quota != "max":
                cores = min(cores, max(1, -(-int(quota) // int(period))))
        except (OSError, ValueError):
            pass
    return cores


def _deflate_pool():
    """(the process's deflate pool, its size): one worker per usable
    core."""
    global _pool, _pool_size
    with _lock:
        if _pool is None:
            _pool_size = max(1, _usable_cores())
            _pool = ThreadPoolExecutor(_pool_size,
                                       thread_name_prefix="tiff-deflate")
        return _pool, _pool_size


def _count(**delta):
    with _lock:
        for key, n in delta.items():
            _counts[key] += n
        _counts["most_in_flight"] = max(_counts["most_in_flight"],
                                        _counts["in_flight"])


def deflate_counts() -> dict:
    """This process's GeoTIFF strips deflated on the pool (``pool``), the
    strips handed to the pool and not yet written (``in_flight``), and the
    most of them at once (``most_in_flight``)."""
    with _lock:
        return dict(_counts)


class TiffStripWriter:
    """Incremental single-band GeoTIFF writer: rows stream in (top-down,
    map orientation), each completed strip is deflated on the process's
    pool of host threads, the strips are written in order as they are
    done, and the IFD is appended at close.  A writer holds at most twice
    the pool's size of strips in flight, so peak memory is that many
    strips, raw and compressed, never the full grid (the sharded-output
    path feeds this with bounded row chunks; see runtime/sharded_io.py).
    A writer that raises is closed, its strips in flight waited out.

    Replaces the GDAL-backed writes of the reference
    (src/Datasets/CRasterDataset.cpp:101-290) including their deflate
    compression; ``bigtiff=None`` auto-switches to BigTIFF when the
    uncompressed payload could exceed the classic 4 GB offset space."""

    def __init__(self, path, width, height, xll=0.0, yll=0.0,
                 cell_size=1.0, nodata=-9999.0, compress="deflate",
                 rows_per_strip=None, bigtiff=None):
        self.width, self.height = int(width), int(height)
        self.cell_size, self.xll, self.yll = cell_size, xll, yll
        self.nodata = nodata
        self.compress = compress
        if rows_per_strip is None:
            # ~2 MB of uncompressed f32 per strip.
            rows_per_strip = max(1, (2 << 20) // max(self.width * 4, 1))
        self.rows_per_strip = min(rows_per_strip, self.height)
        self._pool, size = _deflate_pool()
        self.max_in_flight = 2 * size
        self._in_flight = deque()
        payload = self.width * self.height * 4
        if bigtiff is None:
            bigtiff = payload > (1 << 32) - (1 << 24)
        self.big = bool(bigtiff)
        self._f = open(path, "wb")
        if self.big:
            self._f.write(b"II" + struct.pack("<HHHQ", 43, 8, 0, 0))
        else:
            self._f.write(b"II" + struct.pack("<HI", 42, 0))
        self._pos = self._f.tell()
        self._pending = np.empty((0, self.width), np.float32)
        self._offsets = []
        self._counts = []
        self._rows_in = 0

    def write_rows(self, block):
        """Append rows (map orientation: first call holds the NORTHERNMOST
        rows)."""
        with span("hipims.output.encode"):
            try:
                self._write_rows(block)
            except BaseException:
                self._abort()
                raise

    def _write_rows(self, block):
        block = np.ascontiguousarray(np.asarray(block, np.float32))
        if block.ndim == 1:
            block = block[None, :]
        # Real exceptions, not asserts: a short/wide-fed writer must fail
        # loudly (python -O would strip asserts and emit a corrupt file).
        if block.shape[1] != self.width:
            raise ValueError(f"row width {block.shape[1]} != declared "
                             f"{self.width}")
        self._rows_in += block.shape[0]
        if self._rows_in > self.height:
            raise ValueError(f"received {self._rows_in} rows for a "
                             f"{self.height}-row raster")
        self._pending = (block if not self._pending.size
                         else np.concatenate([self._pending, block]))
        rps = self.rows_per_strip
        while (self._pending.shape[0] >= rps
               or (self._rows_in == self.height and self._pending.size)):
            strip, self._pending = self._pending[:rps], self._pending[rps:]
            # A copy: the caller may reuse its block once this returns.
            self._put(strip.tobytes())
        self._write_done(wait=False)

    def _put(self, raw):
        if self.compress != "deflate":
            self._write_strip(raw)
            return
        if len(self._in_flight) >= self.max_in_flight:
            self._write_strip(self._take())
        self._in_flight.append(self._pool.submit(_deflate, raw))
        _count(pool=1, in_flight=1)

    def _take(self):
        """The oldest strip in flight's compressed bytes, waited for."""
        future = self._in_flight.popleft()
        _count(in_flight=-1)
        return future.result()

    def _write_done(self, wait):
        """Write the strips in flight that are done (all, with ``wait``)
        up to the first that is not."""
        while self._in_flight and (wait or self._in_flight[0].done()):
            self._write_strip(self._take())

    def _write_strip(self, raw):
        self._offsets.append(self._pos)
        self._counts.append(len(raw))
        self._f.write(raw)
        self._pos += len(raw)
        if self._pos % 2:
            # TIFF 6.0: all offsets must be word-aligned; compressed
            # strip lengths are arbitrary, so pad (byte counts keep
            # the true strip length).
            self._f.write(b"\0")
            self._pos += 1

    def _abort(self):
        """Wait out the strips in flight, unwritten, and close the file."""
        while self._in_flight:
            future = self._in_flight.popleft()
            _count(in_flight=-1)
            if not future.cancel():
                future.exception()
        self._f.close()

    def close(self):
        """Wait for every strip, write them and the IFD, and close the
        file."""
        with span("hipims.output.encode"):
            try:
                self._close()
            except BaseException:
                self._abort()
                raise

    def _close(self):
        if self._rows_in != self.height:
            raise ValueError(f"wrote {self._rows_in} of {self.height} "
                             "rows; refusing to emit a truncated TIFF")
        self._write_done(wait=True)
        e = "<"
        big = self.big
        off_t, off_fmt = (16, "Q") if big else (4, "I")
        nodata_s = (f"{self.nodata}".encode() + b"\0"
                    if self.nodata is not None else None)
        n_strips = len(self._offsets)

        entries = []                      # (tag, typ, count, packed-values)

        def add(tag, typ, fmt, values):
            entries.append((tag, typ, len(values),
                            struct.pack(e + fmt * len(values), *values)))

        add(TAG_WIDTH, 4, "I", [self.width])
        add(TAG_HEIGHT, 4, "I", [self.height])
        add(TAG_BITS, 3, "H", [32])
        add(TAG_COMPRESSION, 3, "H",
            [8 if self.compress == "deflate" else 1])
        add(TAG_PHOTOMETRIC, 3, "H", [1])
        add(TAG_STRIP_OFFSETS, off_t, off_fmt, self._offsets)
        add(TAG_SAMPLES_PER_PIXEL, 3, "H", [1])
        add(TAG_ROWS_PER_STRIP, 4, "I", [self.rows_per_strip])
        add(TAG_STRIP_BYTECOUNTS, off_t, off_fmt, self._counts)
        add(TAG_SAMPLE_FORMAT, 3, "H", [3])
        yul = self.yll + self.height * self.cell_size
        add(TAG_MODEL_PIXEL_SCALE, 12, "d",
            [self.cell_size, self.cell_size, 0.0])
        add(TAG_MODEL_TIEPOINT, 12, "d",
            [0.0, 0.0, 0.0, self.xll, yul, 0.0])
        if nodata_s:
            entries.append((TAG_GDAL_NODATA, 2, len(nodata_s), nodata_s))
        entries.sort(key=lambda t: t[0])

        ifd_off = self._pos
        inline = 8 if big else 4
        ent_size = 20 if big else 12
        head = (struct.pack(e + "Q", len(entries)) if big
                else struct.pack(e + "H", len(entries)))
        ifd_size = len(head) + len(entries) * ent_size + (8 if big else 4)
        extra = b""
        out = bytearray(head)
        for tag, typ, count, payload in entries:
            if big:
                out += struct.pack(e + "HHQ", tag, typ, count)
            else:
                out += struct.pack(e + "HHI", tag, typ, count)
            if len(payload) <= inline:
                out += payload.ljust(inline, b"\0")
            else:
                ptr = ifd_off + ifd_size + len(extra)
                # Even-length payloads keep every value offset
                # word-aligned (TIFF 6.0).
                extra += payload + (b"\0" if len(payload) % 2 else b"")
                out += struct.pack(e + off_fmt, ptr)
        out += struct.pack(e + off_fmt, 0)          # next IFD
        self._f.write(out + extra)
        # Patch the header's first-IFD pointer.
        self._f.seek(8 if big else 4)
        self._f.write(struct.pack(e + off_fmt, ifd_off))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()
        else:
            self._abort()


def _write_tiff(path: Path, raster: Raster):
    data = np.asarray(raster.data)
    w = TiffStripWriter(path, data.shape[1], data.shape[0],
                        xll=raster.xll, yll=raster.yll,
                        cell_size=raster.cell_size, nodata=raster.nodata)
    w.write_rows(data)
    w.close()


# ------------------------------------------------------------ dispatch ----

def read_raster(path) -> Raster:
    """Read a raster, dispatching on magic bytes first, then extension
    (an ``.img`` name may hold GeoTIFF bytes)."""
    path = Path(path)
    with open(path, "rb") as f:
        magic = f.read(16)
    if magic.startswith(b"EHFA_HEADER_TAG"):
        from .hfa import read_hfa
        return read_hfa(path)
    if magic[:2] in (b"II", b"MM") and magic[2:3] in (b"*", b"\x00"):
        return _read_tiff(path)
    suffix = path.suffix.lower()
    if suffix in (".tif", ".tiff"):
        return _read_tiff(path)
    if suffix == ".img":
        from .hfa import read_hfa
        return read_hfa(path)
    return _read_asc(path)


def write_raster(path, raster: Raster, fmt: Optional[str] = None):
    path = Path(path)
    fmt = (fmt or path.suffix.lstrip(".")).lower()
    if fmt in ("asc", "aaigrid"):
        _write_asc(path, raster)
    elif fmt in ("tif", "tiff", "gtiff"):
        _write_tiff(path, raster)
    elif fmt in ("hfa", "img"):
        from .hfa import write_hfa
        write_hfa(path, raster)
    else:
        raise ValueError(f"unsupported raster output format '{fmt}'")
