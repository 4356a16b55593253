"""GeoTIFF strips deflated on the process's pool of host threads
(``hipims_tpu_torch/io/raster.py``): the same bytes as deflating them one
after another, errors raised on the calling thread, the file closed and
nothing left in flight, a bounded number of strips held, no thread leak,
and the counters of the strips deflated and in flight."""

import struct
import sys
import threading
import time
import types
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from hipims_tpu.io import raster as j_raster
from hipims_tpu_torch.io import raster
from hipims_tpu_torch.io.raster import (TiffStripWriter, deflate_counts,
                                        read_raster)
from hipims_tpu_torch.runtime import output
from hipims_tpu_torch.runtime.output import RasterOutputWriter, derive_field
from tests.test_torch_trace import program_events


def depth_like(rows, cols, seed=0):
    """A dam break's depth raster in float32: a wet lobe of smooth depths
    with a little noise, dry cells at the nodata value."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:rows, 0:cols]
    h = 30.0 * np.exp(-((x - 0.3 * cols) ** 2 + (y - 0.5 * rows) ** 2)
                      / (0.1 * rows * cols))
    h += rng.uniform(0.0, 1e-3, h.shape)
    return np.where(h > 0.5, h, -9999.0).astype(np.float32)


def serial_strips(data, rows_per_strip):
    """Each strip's deflate stream, one after another on this thread."""
    return [zlib.compress(data[r:r + rows_per_strip].tobytes(), 6)
            for r in range(0, data.shape[0], rows_per_strip)]


def strip_table(buf):
    """(offsets, byte counts) of the strips, read from a little-endian
    TIFF's or BigTIFF's IFD."""
    big = buf[2] == 43
    entry, word = ("<HHQ", "Q") if big else ("<HHI", "I")
    size = struct.calcsize("<" + word)
    (ifd,) = struct.unpack("<" + word, buf[size:2 * size])
    head = "<Q" if big else "<H"
    (n,) = struct.unpack(head, buf[ifd:ifd + struct.calcsize(head)])
    tags = {}
    for i in range(n):
        off = ifd + struct.calcsize(head) + (20 if big else 12) * i
        tag, _typ, count = struct.unpack(entry,
                                         buf[off:off + struct.calcsize(entry)])
        at = off + struct.calcsize(entry)
        if count > 1:
            (at,) = struct.unpack("<" + word, buf[at:at + size])
        tags[tag] = buf[at:at + count * size]
    return [struct.unpack(f"<{len(tags[t]) // size}{word}", tags[t])
            for t in (273, 279)]


def serial_file(path, data, **kw):
    """The file of the JAX package's writer, which deflates each strip on
    the calling thread as it completes."""
    ref = j_raster.TiffStripWriter(path, data.shape[1], data.shape[0],
                                   xll=1000.5, yll=-20.0, cell_size=2.5, **kw)
    ref.write_rows(data)
    ref.close()
    return Path(path).read_bytes()


@pytest.fixture
def fresh(monkeypatch):
    """A pool of ``n`` workers and counters of this test alone, in place of
    the process's."""
    pools = []

    def install(n):
        pool = ThreadPoolExecutor(n)
        pools.append(pool)
        monkeypatch.setattr(raster, "_pool", pool)
        monkeypatch.setattr(raster, "_pool_size", n)
        monkeypatch.setattr(raster, "_counts", dict.fromkeys(
            ("pool", "in_flight", "most_in_flight"), 0))
        return pool

    yield install
    for pool in pools:
        pool.shutdown(wait=True)


def write(path, data, chunks=None, **kw):
    w = TiffStripWriter(path, data.shape[1], data.shape[0], xll=1000.5,
                        yll=-20.0, cell_size=2.5, **kw)
    edges = np.cumsum([0] + list(chunks or [data.shape[0]]))
    for r0, r1 in zip(edges[:-1], edges[1:]):
        w.write_rows(data[r0:r1])
    w.close()
    return w


@pytest.mark.parametrize("shape,chunks,bigtiff,workers", [
    ((13, 21), None, None, 4),                        # one strip
    ((1024, 1792), None, None, 4),                    # 292, 292, 292, 148
    ((1024, 1792), [100, 300, 7, 500, 117], None, 4),  # streamed chunks
    ((1024, 1792), None, True, 4),
    ((1024, 1792), None, None, 1),                    # one-worker pool
], ids=["one_strip", "dambreak", "dambreak_chunked", "bigtiff",
        "one_worker"])
def test_pooled_strips_equal_serial(tmp_path, fresh, shape, chunks, bigtiff,
                                    workers):
    fresh(workers)
    data = depth_like(*shape)
    w = write(tmp_path / "pool.tif", data, chunks, bigtiff=bigtiff)
    buf = (tmp_path / "pool.tif").read_bytes()
    rps = w.rows_per_strip
    assert rps == min(shape[0], (2 << 20) // (shape[1] * 4))
    strips = serial_strips(data, rps)
    offsets, counts = strip_table(buf)
    assert list(counts) == [len(s) for s in strips]
    pos = 16 if bigtiff else 8
    for off, strip in zip(offsets, strips):
        assert off == pos
        assert buf[off:off + len(strip)] == strip
        pos += len(strip) + len(strip) % 2
    # The whole file, header and IFD too, is the serial writer's.
    assert buf == serial_file(tmp_path / "ref.tif", data, bigtiff=bigtiff)
    np.testing.assert_array_equal(read_raster(tmp_path / "pool.tif").data,
                                  data)
    assert deflate_counts()["in_flight"] == 0


def dam_view(rows, cols, chunks):
    """A stand-in for an output event's snapshot (``output_view``): a
    dam-break state streamed north-first in ``chunks`` of rows."""
    rng = np.random.default_rng(3)
    zb = np.linspace(0.0, 5.0, cols)[None, :] + np.zeros((rows, 1))
    h = np.where(np.arange(cols)[None, :] < cols // 3, 10.0, 0.0) \
        + np.zeros((rows, 1)) + rng.uniform(0.0, 0.01, (rows, cols))
    z = zb + h
    domain = types.SimpleNamespace(rows=rows, cols=cols, dx=10.0, datum=0.0,
                                   xll=0.0, yll=0.0)
    edges = np.cumsum([0] + chunks)

    def stream_chunks(reverse=False):
        spans = list(zip(edges[:-1], edges[1:]))
        for r0, r1 in (reversed(spans) if reverse else spans):
            st = types.SimpleNamespace(z=z[r0:r1], zmax=z[r0:r1] + 0.5,
                                       qx=h[r0:r1], qy=h[r0:r1])
            yield r0, st, types.SimpleNamespace(zb=zb[r0:r1])

    view = types.SimpleNamespace(domain=domain, write_files=True,
                                 stream_chunks=stream_chunks)
    state = types.SimpleNamespace(z=z, zmax=z + 0.5, qx=h, qy=h)
    return view, state, types.SimpleNamespace(zb=zb), domain


@pytest.mark.parametrize("chunks", [[600], [250, 101, 249]])
def test_output_writer_equals_serial_writer(tmp_path, fresh, chunks):
    """Depth and maxdepth of one state through RasterOutputWriter, on a
    pool, are the serial writer's files, and every strip went to the
    pool."""
    fresh(4)
    view, state, static, domain = dam_view(600, 2048, chunks)
    targets = [{"value": v, "format": "tif", "target": f"{v}_%t.tif"}
               for v in ("depth", "maxdepth")]
    sim = types.SimpleNamespace(output_view=lambda: view)
    RasterOutputWriter(targets, str(tmp_path / "out"), domain)(sim, 600.0)
    for v in ("depth", "maxdepth"):
        field = derive_field(v, state, static, domain.dx)
        j_raster.write_raster(tmp_path / f"ref_{v}.tif", j_raster.Raster(
            data=field[::-1], xll=0.0, yll=0.0, cell_size=10.0,
            nodata=-9999.0))
        assert (tmp_path / "out" / f"{v}_600.tif").read_bytes() == \
            (tmp_path / f"ref_{v}.tif").read_bytes()
    counts = deflate_counts()
    assert counts["pool"] == 2 * 3
    assert counts["in_flight"] == 0 and counts["most_in_flight"] >= 2


def test_output_writer_closes_its_sinks_when_a_derive_raises(
        tmp_path, fresh, monkeypatch):
    """A derive that raises mid-event closes every TIFF sink already open,
    their strips in flight waited out, before the error rises."""
    fresh(2)
    opened = []

    class Recorded(TiffStripWriter):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            opened.append(self)

    def slow(raw):
        time.sleep(0.01)
        return zlib.compress(raw, 6)

    calls = []

    def derive(value, *args, **kw):
        calls.append(value)
        if len(calls) == 4:             # maxdepth of the second chunk
            raise RuntimeError("derive failed")
        return derive_field(value, *args, **kw)

    monkeypatch.setattr(raster, "TiffStripWriter", Recorded)
    monkeypatch.setattr(raster, "_deflate", slow)
    monkeypatch.setattr(output, "derive_field", derive)
    # 8192 columns: 64-row strips, so depth has a strip in flight at
    # the second chunk (north-first: 40, 40, 16 rows).
    view, _state, _static, domain = dam_view(96, 8192, [16, 40, 40])
    targets = [{"value": v, "format": "tif", "target": f"{v}_%t.tif"}
               for v in ("depth", "maxdepth")]
    writer = RasterOutputWriter(targets, str(tmp_path / "out"), domain)
    with pytest.raises(RuntimeError, match="derive failed"):
        writer(types.SimpleNamespace(output_view=lambda: view), 60.0)
    assert len(opened) == 2
    assert all(w._f.closed and not w._in_flight for w in opened)
    counts = deflate_counts()
    assert counts["pool"] > 0 and counts["in_flight"] == 0


@pytest.mark.parametrize("cgroup,files,expect", [
    ("0::/a/b\n", {"a/b/cpu.max": "150000 100000"}, 2),
    ("0::/a/b\n", {"a/b/cpu.max": "max 100000"}, None),
    ("0::/a/b\n", {"a/b/cpu.max": "max 100000",
                   "a/cpu.max": "100000 100000"}, 1),
    ("0::/\n", {"cpu.max": "250000 100000"}, 3),
    ("0::/a/b\n", {}, None),
    ("4:cpu,cpuacct:/a\n1:name=systemd:/a\n", {"a/cpu.max": "1 100000"},
     None),
], ids=["leaf_quota", "leaf_max", "ancestor_quota", "root_quota",
        "no_file", "cgroup_v1"])
def test_usable_cores_reads_cgroup_quotas(tmp_path, monkeypatch, cgroup,
                                          files, expect):
    """The pool's size: the affinity mask, capped by the tightest cgroup v2
    ``cpu.max`` quota of the process's cgroup and its ancestors, rounded
    up; no quota (or cgroup v1) leaves the affinity count."""
    (tmp_path / "cgroup").write_text(cgroup)
    for name, text in files.items():
        (tmp_path / "fs" / name).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / "fs" / name).write_text(text + "\n")
    monkeypatch.setattr(raster, "_CGROUP", str(tmp_path / "cgroup"))
    monkeypatch.setattr(raster, "_CGROUP_ROOT", str(tmp_path / "fs"))
    monkeypatch.setattr(raster.os, "sched_getaffinity",
                        lambda pid: set(range(6)))
    assert raster._usable_cores() == (6 if expect is None else expect)


def test_short_feed_raises_and_leaves_nothing_in_flight(tmp_path, fresh):
    fresh(2)
    data = depth_like(1024, 1792)
    w = TiffStripWriter(tmp_path / "s.tif", 1792, 1024)
    w.write_rows(data[:900])
    with pytest.raises(ValueError, match="wrote 900 of 1024 rows"):
        w.close()
    assert w._f.closed and not w._in_flight
    assert deflate_counts()["in_flight"] == 0


@pytest.mark.parametrize("workers", [2, 1])
def test_deflate_error_raised_on_calling_thread(tmp_path, fresh, monkeypatch,
                                                workers):
    """A strip whose deflate raises fails the writer on the calling thread,
    at a later write_rows or at close; the file is closed and no strip is
    left in flight."""
    fresh(workers)
    calls = []

    def deflate(raw):
        calls.append(raw)
        if len(calls) == 2:
            raise RuntimeError("deflate failed")
        return zlib.compress(raw, 6)

    monkeypatch.setattr(raster, "_deflate", deflate)
    data = depth_like(64, 32)
    w = TiffStripWriter(tmp_path / "e.tif", 32, 64, rows_per_strip=8)
    with pytest.raises(RuntimeError, match="deflate failed"):
        for r in range(0, 64, 8):
            w.write_rows(data[r:r + 8])
        w.close()
    assert w._f.closed and not w._in_flight
    assert deflate_counts()["in_flight"] == 0
    with pytest.raises(RuntimeError):
        with TiffStripWriter(tmp_path / "x.tif", 32, 64,
                             rows_per_strip=8) as w2:
            w2.write_rows(data[:8])
            raise RuntimeError("caller failed")
    assert w2._f.closed and not w2._in_flight


def test_no_thread_leak_over_writers(tmp_path):
    """A hundred writers on the process's own pool leave it at its size."""
    data = depth_like(64, 32)
    for i in range(100):
        write(tmp_path / f"{i % 3}.tif", data, rows_per_strip=8)
    pool, size = raster._deflate_pool()
    threads = [t for t in threading.enumerate()
               if t.name.startswith("tiff-deflate")]
    assert size == raster._usable_cores() >= 1
    assert len(threads) <= size and len(pool._threads) <= size


def test_counters_and_in_flight_cap(tmp_path, fresh, monkeypatch):
    fresh(2)
    data = depth_like(64, 32)
    write(tmp_path / "eight.tif", data, rows_per_strip=8)
    assert deflate_counts()["pool"] == 8
    write(tmp_path / "one.tif", depth_like(13, 21))
    assert deflate_counts()["pool"] == 9
    assert deflate_counts()["in_flight"] == 0

    fresh(2)

    def slow(raw):
        time.sleep(0.002)
        return zlib.compress(raw, 6)

    monkeypatch.setattr(raster, "_deflate", slow)
    data = depth_like(200, 8)
    w = TiffStripWriter(tmp_path / "many.tif", 8, 200, xll=1000.5,
                        yll=-20.0, cell_size=2.5, rows_per_strip=1)
    assert w.max_in_flight == 4
    for r in range(200):
        w.write_rows(data[r])
        assert len(w._in_flight) <= w.max_in_flight
    w.close()
    counts = deflate_counts()
    assert counts["pool"] == 200 and counts["in_flight"] == 0
    assert 2 <= counts["most_in_flight"] <= w.max_in_flight
    assert (tmp_path / "many.tif").read_bytes() == \
        serial_file(tmp_path / "ref.tif", data, rows_per_strip=1)


def test_writers_on_many_threads_share_the_pool(tmp_path, fresh):
    """Twelve threads write rasters at once through one two-worker pool
    with a short switch interval: every file is its serial bytes and every
    strip is counted once."""
    fresh(2)
    data = [depth_like(48, 40, seed=k) for k in range(12)]
    errors = []

    def work(k):
        try:
            for rep in range(3):
                write(tmp_path / f"t{k}_{rep}.tif", data[k], [5, 20, 23],
                      rows_per_strip=4)
        except Exception as exc:        # reported by the assert below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    for k in range(12):
        ref = serial_file(tmp_path / f"ref{k}.tif", data[k], rows_per_strip=4)
        for rep in range(3):
            assert (tmp_path / f"t{k}_{rep}.tif").read_bytes() == ref
    counts = deflate_counts()
    assert counts["pool"] == 12 * 3 * 12 and counts["in_flight"] == 0


def test_encode_span_covers_the_waits(tmp_path, fresh, monkeypatch):
    """Under a profiler the calling thread's ``hipims.output.encode`` spans
    cover its waits on the pool, at the in-flight cap and in close's
    drain, and the pool's threads record none."""
    fresh(2)

    def slow(raw):
        time.sleep(0.02)
        return zlib.compress(raw, 6)

    monkeypatch.setattr(raster, "_deflate", slow)
    data = depth_like(64, 32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter_ns()
        write(tmp_path / "s.tif", data, [40, 24], rows_per_strip=4)
        wall = time.perf_counter_ns() - t0
    spans = program_events(prof)
    assert {n for n, *_ in spans} == {"hipims.output.encode"}
    assert len(spans) == 3                  # two write_rows, one close
    # 16 strips of 20 ms on 2 workers: >= 160 ms of waiting, all inside.
    assert sum(e - s for _, _, s, e in spans) >= 0.95 * wall >= 0.15e9
