"""The benchmark's own ESRI ASCII grid (.asc) writer and reader, for the
gridded rain frames: the program reads them through its own raster
code, the reference through ``read``.  Values are written as Python's
shortest round-trip decimals, so both sides read the same float64
numbers.  Arrays are in map orientation: row 0 is north.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

HEADER = ("ncols", "nrows", "xllcorner", "yllcorner", "cellsize",
          "nodata_value")


def write(path, data, cell_size, xll=0.0, yll=0.0, nodata=-9999.0):
    """Write ``data`` (map orientation) with its lower-left corner at
    (``xll``, ``yll``)."""
    data = np.asarray(data, dtype=np.float64)
    rows, cols = data.shape
    head = (f"ncols {cols}\nnrows {rows}\nxllcorner {xll!r}\n"
            f"yllcorner {yll!r}\ncellsize {float(cell_size)!r}\n"
            f"NODATA_value {float(nodata)!r}\n")
    body = "".join(" ".join(repr(float(v)) for v in row) + "\n"
                   for row in data)
    Path(path).write_text(head + body)


def read(path):
    """(data, cell_size, xll, yll) of an ASC grid, data in map
    orientation."""
    lines = Path(path).read_text().splitlines()
    head, k = {}, 0
    while k < len(lines):
        parts = lines[k].split()
        if len(parts) != 2 or parts[0].lower() not in HEADER:
            break
        head[parts[0].lower()] = float(parts[1])
        k += 1
    rows, cols = int(head["nrows"]), int(head["ncols"])
    data = np.array(" ".join(lines[k:]).split(), dtype=np.float64)
    return (data.reshape(rows, cols), head["cellsize"],
            head.get("xllcorner", 0.0), head.get("yllcorner", 0.0))
