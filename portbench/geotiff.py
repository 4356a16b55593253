"""The benchmark's own single-band float32 GeoTIFF reader and writer.

The benchmark writes each model's DEM and initial depth with ``write``
(uncompressed strips, so the program's loader reads them with one copy
per strip) and reads the program's output rasters back with ``read``
(uncompressed or deflate strips, as GDAL and the program write them).
Both sides of the comparison read the same files; neither uses the
program's raster code.  Arrays are in map orientation: row 0 is north.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_WIDTH, _HEIGHT, _BITS, _COMPRESSION, _PHOTOMETRIC = 256, 257, 258, 259, 262
_STRIP_OFFSETS, _SAMPLES, _ROWS_PER_STRIP, _STRIP_COUNTS = 273, 277, 278, 279
_SAMPLE_FORMAT, _PREDICTOR = 339, 317
_PIXEL_SCALE, _TIEPOINT, _GDAL_NODATA = 33550, 33922, 42113
_TYPES = {1: ("B", 1), 2: ("s", 1), 3: ("H", 2), 4: ("I", 4), 12: ("d", 8),
          16: ("Q", 8)}


def write(path, data, cell_size, xll=0.0, yll=0.0, nodata=-9999.0):
    """Write ``data`` (map orientation) as an uncompressed float32
    GeoTIFF with ~2 MB strips."""
    data = np.ascontiguousarray(np.asarray(data, dtype="<f4"))
    height, width = data.shape
    rps = max(1, min(height, (2 << 20) // (width * 4)))
    strips = [data[r:r + rps].tobytes() for r in range(0, height, rps)]
    offsets, pos = [], 8
    for s in strips:
        offsets.append(pos)
        pos += len(s)
    nodata_s = f"{nodata}".encode() + b"\0"
    entries = [
        (_WIDTH, 4, [width]), (_HEIGHT, 4, [height]), (_BITS, 3, [32]),
        (_COMPRESSION, 3, [1]), (_PHOTOMETRIC, 3, [1]),
        (_STRIP_OFFSETS, 4, offsets), (_SAMPLES, 3, [1]),
        (_ROWS_PER_STRIP, 4, [rps]),
        (_STRIP_COUNTS, 4, [len(s) for s in strips]),
        (_SAMPLE_FORMAT, 3, [3]),
        (_PIXEL_SCALE, 12, [cell_size, cell_size, 0.0]),
        (_TIEPOINT, 12, [0.0, 0.0, 0.0, xll, yll + height * cell_size, 0.0]),
        (_GDAL_NODATA, 2, nodata_s),
    ]
    ifd_off = pos + (pos % 2)
    ifd_size = 2 + 12 * len(entries) + 4
    head, extra = bytearray(struct.pack("<H", len(entries))), bytearray()
    for tag, typ, vals in entries:
        payload = (vals if typ == 2 else
                   struct.pack("<" + _TYPES[typ][0] * len(vals), *vals))
        head += struct.pack("<HHI", tag, typ, len(vals))
        if len(payload) <= 4:
            head += payload.ljust(4, b"\0")
        else:
            head += struct.pack("<I", ifd_off + ifd_size + len(extra))
            extra += payload + (b"\0" if len(payload) % 2 else b"")
    head += struct.pack("<I", 0)
    with open(path, "wb") as f:
        f.write(b"II" + struct.pack("<HI", 42, ifd_off))
        for s in strips:
            f.write(s)
        f.write(b"\0" * (ifd_off - pos))
        f.write(bytes(head) + bytes(extra))


def _tags(buf, path):
    """{tag: values} of the first image directory of the TIFF ``buf``."""
    if buf[:4] != b"II*\0":
        raise ValueError(f"{path}: not a little-endian classic TIFF")
    (ifd,) = struct.unpack("<I", buf[4:8])
    (count,) = struct.unpack("<H", buf[ifd:ifd + 2])
    tags = {}
    for i in range(count):
        off = ifd + 2 + 12 * i
        tag, typ, n = struct.unpack("<HHI", buf[off:off + 8])
        fmt, size = _TYPES.get(typ, ("B", 1))
        raw = buf[off + 8:off + 12]
        if size * n > 4:
            (ptr,) = struct.unpack("<I", raw)
            raw = buf[ptr:ptr + size * n]
        tags[tag] = (raw[:n].rstrip(b"\0").decode() if typ == 2 else
                     struct.unpack("<" + fmt * n, raw[:size * n]))
    return tags


def lower_left(path):
    """(x, y) of the lower-left corner of a GeoTIFF's grid, from its tie
    point (the upper-left corner) and its height in cells."""
    tags = _tags(Path(path).read_bytes(), path)
    tie, scale = tags[_TIEPOINT], tags[_PIXEL_SCALE]
    return tie[3], tie[4] - tags[_HEIGHT][0] * scale[1]


def read(path):
    """(data, cell_size, nodata) of a single-band float GeoTIFF, data in
    map orientation."""
    buf = Path(path).read_bytes()
    tags = _tags(buf, path)
    width, height = tags[_WIDTH][0], tags[_HEIGHT][0]
    comp = tags.get(_COMPRESSION, (1,))[0]
    if tags.get(_PREDICTOR, (1,))[0] != 1 or comp not in (1, 8):
        raise ValueError(f"{path}: unsupported compression or predictor")
    dtype = {32: "<f4", 64: "<f8"}[tags.get(_BITS, (32,))[0]]
    parts = []
    for o, c in zip(tags[_STRIP_OFFSETS], tags[_STRIP_COUNTS]):
        chunk = buf[o:o + c]
        parts.append(np.frombuffer(zlib.decompress(chunk) if comp == 8
                                   else chunk, dtype=dtype))
    data = np.concatenate(parts)[:width * height].reshape(height, width)
    nodata = tags.get(_GDAL_NODATA)
    return (data.astype(np.float64), tags[_PIXEL_SCALE][0],
            float(nodata) if nodata else None)
