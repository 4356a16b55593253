"""The native host codec: the RLC block decoder of HFA rasters and the ESRI
ASCII grid formatter, in C++ (``raster_codec.cpp``), loaded with ctypes.

Host I/O, not a device kernel.  The library is built with g++ at first use
into the gitignored ``native/build/<hash>/``, keyed by a hash of the
source and flags, as the CUDA kernels are built into ``csrc/build/``.  A
machine without g++ (or where the build fails) keeps the numpy versions of
both: each caller tries the native entry point and falls back when it
returns None.  Which of the two ran is logged once per process.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import struct
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

log = logging.getLogger("hipims_tpu_torch.native")

SOURCE = Path(__file__).resolve().parent / "raster_codec.cpp"
BUILD_DIR = SOURCE.parent / "build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _build():
    """Path of the built library, or None (no g++, or the build failed)."""
    gxx = shutil.which("g++")
    if gxx is None:
        log.info("native codec: no g++ on PATH; the numpy versions run")
        return None
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    out_dir = BUILD_DIR / h.hexdigest()[:16]
    lib_path = out_dir / "libhipims_raster.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    # Build to a private name, then rename: a concurrent build never loads
    # a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", tmp],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        os.unlink(tmp)
        log.warning("native codec: g++ build failed (%s); the numpy "
                    "versions run", e)
        return None
    os.replace(tmp, lib_path)
    return lib_path


def get_lib():
    """The loaded native library, or None if it is unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            log.warning("native codec: cannot load %s (%s); the numpy "
                        "versions run", path, e)
            return None
        lib.hfa_decode_rlc.restype = ctypes.c_int
        lib.hfa_decode_rlc.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint32)]
        lib.asc_format.restype = ctypes.c_int64
        lib.asc_format.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int, ctypes.c_char_p,
            ctypes.c_int64]
        log.info("native codec: loaded %s", path)
        _LIB = lib
        return _LIB


def decode_rlc_native(block: bytes, expected: int):
    """One RLC block decoded by the native library, or None (the caller
    then runs the numpy version, which raises on a malformed block)."""
    lib = get_lib()
    if lib is None or len(block) < 13:
        return None
    # The library reads the run values without a bound: hand it only
    # blocks that hold all of them.
    nruns, doff = struct.unpack("<ii", block[4:12])
    nbits = block[12]
    if nruns == -1:
        nruns, doff = expected, 13
    if nruns < 0 or doff < 13 or len(block) < doff + -(-nruns * nbits // 8):
        return None
    out = np.empty(expected, dtype=np.uint32)
    rc = lib.hfa_decode_rlc(
        block, len(block), expected,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    if rc != 0:
        return None
    return out


def asc_format_native(data: np.ndarray, decimals: int = 6):
    """The body of an ESRI ASCII grid ("%.6f" values, one row per line)
    formatted by the native library, or None (the caller then runs
    numpy.savetxt, which writes the same bytes)."""
    lib = get_lib()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.float64)
    rows, cols = data.shape
    cap = rows * cols * (decimals + 16) + rows + 16
    buf = ctypes.create_string_buffer(cap)
    n = lib.asc_format(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rows, cols, decimals, buf, cap)
    if n < 0:
        return None
    return buf.raw[:n]
