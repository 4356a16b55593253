"""The port's host I/O and embedding API against the JAX package's, on the
CPU: HFA (.img) files byte for byte, the RLC block decoder at every bit
width it supports, the native codec against its numpy versions, gauge
CSVs row for row, and the embedding API's lifecycle (the cases of
tests/test_runtime_extras.py)."""

import struct
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import hipims_tpu_torch.native as native
from hipims_tpu.cli import main as jax_main
from hipims_tpu.io import hfa as jhfa
from hipims_tpu.io import raster as j_raster
from hipims_tpu_torch import api
from hipims_tpu_torch.cli import main as torch_main
from hipims_tpu_torch.io import hfa
from hipims_tpu_torch.io import raster as t_raster
from hipims_tpu_torch.io.xml_config import load_config
from hipims_tpu_torch.runtime.output import (VALUE_NAMES, GaugeOutputWriter,
                                             derive_field, read_gauge_map)

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(1, 1), (64, 64), (70, 131)])
def test_write_hfa_byte_equal_and_reads_back(tmp_path, dtype, shape):
    rng = np.random.default_rng(sum(shape))
    data = rng.uniform(-5.0, 80.0, shape).astype(dtype)
    data.flat[::7] = -9999.0
    rast = dict(data=data, xll=531200.0, yll=-12.5, cell_size=2.0,
                nodata=-9999.0)
    hfa.write_hfa(tmp_path / "t.img", t_raster.Raster(**rast))
    jhfa.write_hfa(tmp_path / "j.img", j_raster.Raster(**rast))
    assert (tmp_path / "t.img").read_bytes() == \
        (tmp_path / "j.img").read_bytes()
    back = t_raster.read_raster(tmp_path / "j.img")    # by magic
    want = jhfa.read_hfa(tmp_path / "j.img")
    assert back.data.dtype == want.data.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(back.data, want.data)
    np.testing.assert_array_equal(back.data, data)
    assert (back.xll, back.yll, back.cell_size, back.nodata) == \
        (want.xll, want.yll, want.cell_size, want.nodata) == \
        (531200.0, -12.5, 2.0, -9999.0)


def _varint(count):
    """An RLC run count: big-endian, its byte length - 1 in the top two
    bits of the first byte."""
    for n in range(4):
        if count < 1 << (6 + 8 * n):
            raw = count.to_bytes(n + 1, "big")
            return bytes([raw[0] | (n << 6)]) + raw[1:]
    raise ValueError(count)


def _pack(raw, nbits):
    """Run values at ``nbits`` each: big-endian words, or sub-byte values
    packed from the low bits of each byte up."""
    raw = np.asarray(raw, np.uint64)
    if nbits in (8, 16, 32):
        return raw.astype(f">u{nbits // 8}").tobytes()
    if nbits == 0:
        return b""
    per = 8 // nbits
    padded = np.zeros(-(-len(raw) // per) * per, np.uint64)
    padded[:len(raw)] = raw
    shifts = (np.arange(per) * nbits).astype(np.uint64)
    return (padded.reshape(-1, per) << shifts).sum(1).astype(np.uint8) \
        .tobytes()


def rlc_block(dmin, raw, nbits, counts=None):
    """One ESRI RLC block (io/hfa.py format notes): the 13-byte header,
    then run counts (none when ``counts`` is None: the values are not
    run-length encoded), then the values."""
    if counts is None:
        return (struct.pack("<Iii", dmin, -1, 13) + bytes([nbits])
                + _pack(raw, nbits))
    runs = b"".join(_varint(int(c)) for c in counts)
    return (struct.pack("<Iii", dmin, len(counts), 13 + len(runs))
            + bytes([nbits]) + runs + _pack(raw, nbits))


RLC_CASES = [  # (nbits, pixel dtype, dmin)
    (0, "<i4", 7), (1, "u1", 3), (2, "<u2", 100), (4, "<i2", 0),
    (8, "<u4", 1000), (16, "<i4", 5), (32, "<u4", 0), (32, "<f4", 0)]


@pytest.mark.parametrize("encoded", [False, True])
@pytest.mark.parametrize("nbits,dtype,dmin", RLC_CASES)
def test_rlc_decoder_matches_jax(nbits, dtype, dmin, encoded, monkeypatch):
    """Blocks built at every bit width, with and without run-length
    encoding, decoded by the port (native codec, then its numpy version)
    and by JAX's decoder: the same pixels, and the ones the block
    encodes.  The runs span all four run-count lengths."""
    rng = np.random.default_rng(nbits + 17 * encoded)
    count = 64 * 64
    dtype = np.dtype(dtype)
    if dtype == np.dtype("<f4"):
        pixels = rng.uniform(-3.0, 40.0, 9).astype("<f4").view("<u4")
        raw = pixels.astype(np.uint64)
    else:
        raw = rng.integers(0, 1 << nbits, 9) if nbits else np.zeros(9, int)
    if encoded:
        # Run counts of 1, 2, 3 and 4 bytes; the last two runs overrun the
        # block, which ends at its pixel count.
        counts = np.array([1, 63, 64, 300, 0, 1000, 5, 16384, 1 << 22])
        block = rlc_block(dmin, raw, nbits, counts)
        want_raw = np.repeat(raw, counts)[:count]
    else:
        raw = rng.integers(0, 1 << nbits, count) if nbits \
            else np.zeros(count, int)
        if dtype == np.dtype("<f4"):
            raw = rng.uniform(-3.0, 40.0, count).astype("<f4").view(
                "<u4").astype(np.uint64)
        block = rlc_block(dmin, raw, nbits)
        want_raw = raw
    want = (np.asarray(want_raw, np.uint64) + dmin)
    want = (want.astype(np.uint32).view(np.float32)
            if dtype == np.dtype("<f4") else want.astype(dtype))
    jax_out = jhfa._decode_rlc(block, dtype, count)
    assert native.get_lib() is not None         # g++ builds it here
    got_native = hfa._decode_rlc(block, dtype, count)
    monkeypatch.setattr(native, "decode_rlc_native", lambda *a: None)
    got_numpy = hfa._decode_rlc(block, dtype, count)
    for got in (jax_out, got_native, got_numpy):
        assert got.dtype == dtype
        np.testing.assert_array_equal(got, want)


def test_native_decoder_refuses_a_short_block():
    """A block too short for its run values never reaches the library,
    which reads them without a bound; the numpy version then raises."""
    raw = np.arange(100, dtype=np.uint64)
    for counts in (None, np.full(100, 2)):
        block = rlc_block(0, raw, 32, counts)[:-8]
        assert native.decode_rlc_native(block, 200) is None
        with pytest.raises(ValueError):
            hfa._decode_rlc(block, np.dtype("<u4"), 200)


def test_native_asc_formatter_matches_numpy(tmp_path, monkeypatch):
    """The ASC body from the native formatter is numpy.savetxt's, byte for
    byte; the library is built into the gitignored native/build/."""
    rng = np.random.default_rng(3)
    data = rng.uniform(-100.0, 100.0, (37, 53))
    data[::5, ::3] = -9999.0
    data[1, 1] = 1e-7
    rast = t_raster.Raster(data=data, xll=10.0, yll=20.0, cell_size=2.0)
    t_raster.write_raster(tmp_path / "native.asc", rast)
    lib = native.get_lib()
    assert lib is not None and native.BUILD_DIR in Path(lib._name).parents
    monkeypatch.setattr(native, "asc_format_native", lambda *a: None)
    t_raster.write_raster(tmp_path / "numpy.asc", rast)
    assert (tmp_path / "native.asc").read_bytes() == \
        (tmp_path / "numpy.asc").read_bytes()


GAUGE_XML = """<?xml version="1.0"?>
<configuration><metadata><name>Gauges</name></metadata>
<simulation>
  <parameter name="duration" value="{duration}" />
  <parameter name="outputFrequency" value="{outfreq}" />
  <parameter name="floatingPointPrecision" value="double-strict" />
  <domainSet><domain type="cartesian">
    <data sourceDir="." targetDir="out/">
      <dataSource type="raster" value="depth" source="h.asc" />
      <dataSource type="constant" value="manningCoefficient" source="0.03"/>
      <dataSource type="raster" value="structure,dem" source="dem.asc"/>
      {targets}
    </data>
    <scheme name="Godunov" />
  </domain></domainSet></simulation></configuration>"""
RASTER_TARGET = ('<dataTarget type="raster" value="depth" format="GTiff" '
                 'target="depth_%t.tif" />')
GAUGE_TARGETS = "".join(
    f'<dataTarget type="timeseries" value="{v}" source="gauges.csv" '
    f'target="gauge_{v}.csv" />' for v in ("depth", "velocityx", "fsl"))


def _gauge_model(tmp_path, duration=6, outfreq=2, targets=None):
    rng = np.random.default_rng(8)
    yy, xx = np.mgrid[0:16, 0:24]
    zb = 10.0 + 0.02 * xx + rng.uniform(0.0, 0.01, (16, 24))
    t_raster.write_raster(tmp_path / "dem.asc",
                          t_raster.Raster.from_domain_array(zb,
                                                            cell_size=2.0))
    t_raster.write_raster(tmp_path / "h.asc", t_raster.Raster.from_domain_array(
        np.where(xx < 8, 0.5, 0.0), cell_size=2.0))
    # A named gauge in the pool, one on the dry slope (nodata -> 0), an
    # unnamed one, and one off the grid (dropped).
    (tmp_path / "gauges.csv").write_text(
        "x,y,name\n5.0,9.0,Pool\n40.0,20.0,Slope\n15.5,3.0\n"
        "100.0,9.0,Far\n")
    xml = tmp_path / "m.xml"
    xml.write_text(GAUGE_XML.format(
        duration=duration, outfreq=outfreq,
        targets=RASTER_TARGET + GAUGE_TARGETS if targets is None
        else targets))
    return xml


def test_gauge_csvs_equal_jax(tmp_path):
    """Gauge targets of depth, velocity and level through both CLIs in
    float64: the same CSV files, row for row."""
    for pkg, run in (("jax", lambda x: jax_main(["-c", str(x), "-q",
                                                 "--platform", "cpu"])),
                     ("torch", lambda x: torch_main(["-c", str(x), "-q",
                                                     "--platform", "cpu"]))):
        (tmp_path / pkg).mkdir()
        assert run(_gauge_model(tmp_path / pkg)) == 0
    for v in ("depth", "velocityx", "fsl"):
        got = (tmp_path / "torch" / "out" / f"gauge_{v}.csv").read_text()
        want = (tmp_path / "jax" / "out" / f"gauge_{v}.csv").read_text()
        assert got.splitlines() == want.splitlines()
        lines = got.splitlines()
        assert lines[0] == "Time (s),Pool,Slope,G3" and len(lines) == 4
    # The last depth row: t, the pool's depth, the dry slope's 0.
    rows = (tmp_path / "torch" / "out" / "gauge_depth.csv").read_text()
    t, pool, slope, _ = (float(v) for v in rows.splitlines()[-1].split(","))
    assert (t, slope) == (6.0, 0.0) and pool > 0.1
    assert sorted(p.name for p in (tmp_path / "torch" / "out").glob(
        "*.tif")) == ["depth_2.tif", "depth_4.tif", "depth_6.tif"]


def _wait(done, seconds=120.0):
    deadline = time.monotonic() + seconds
    while not done():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.005)


@pytest.mark.parametrize("value", VALUE_NAMES)
def test_gauge_values_equal_the_full_field(tmp_path, value):
    """The gauge writer derives each field on its cells alone: the row it
    writes is the full field's value at each gauge cell."""
    sim = load_config(_gauge_model(tmp_path)).simulation(device="cpu")
    sim.run_to(2.0)
    writer = GaugeOutputWriter(value, read_gauge_map(tmp_path / "gauges.csv"),
                               tmp_path / "g.csv", sim.domain)
    writer(sim, 2.0)
    row = (tmp_path / "g.csv").read_text().splitlines()[1].split(",")
    field = derive_field(value, sim.state_logical, sim.static_logical,
                         sim.domain.dx, datum=sim.domain.datum)
    want = [field[r, c] for r, c in writer.cells]
    assert len(want) == 3
    assert row[1:] == [f"{0.0 if v == -9999.0 else v:.6f}" for v in want]


def test_api_blocking_run_and_domain_info(tmp_path):
    handle = api.simulation_load(_gauge_model(tmp_path), device="cpu")
    info = handle.domain_info()
    assert (info.rows, info.cols, info.resolution) == (16, 24, 2.0)
    assert (info.cell_count, info.scheme, info.precision) == \
        (384, "godunov", "float64")
    handle.launch(blocking=True)
    assert handle.progress == pytest.approx(1.0, abs=1e-4)
    assert handle.time == pytest.approx(6.0, abs=1e-6)
    depth = handle.field("depth")
    assert depth.shape == (16, 24) and not handle.running
    assert handle.error is None
    assert api.device_count() == torch.cuda.device_count()
    handle.close()


def test_api_callbacks_and_field_snapshot(tmp_path):
    """on_progress fires per batch; on_output at every output time, with
    field() reading the event's snapshot; files are still written."""
    frames, ticks = [], []
    handle = api.simulation_load(_gauge_model(tmp_path), device="cpu")
    handle.on_output(lambda h, t: frames.append((t, h.field("depth"),
                                                 h._snapshot)))
    handle.on_progress(lambda h, t, el: ticks.append(t))
    handle.launch(blocking=False)
    _wait(lambda: not handle.running)
    assert handle.error is None
    assert [t for t, _, _ in frames] == [2.0, 4.0, 6.0]
    assert all(f.shape == (16, 24) for _, f, _ in frames)
    # The field came from the event's host copy, not a new one.
    snap = frames[-1][2]
    np.testing.assert_array_equal(
        frames[-1][1], np.where(snap.state_logical.z
                                - snap.static_logical.zb > 1e-8,
                                snap.state_logical.z
                                - snap.static_logical.zb, -9999.0))
    assert handle._snapshot is None and len(ticks) >= 1
    assert sorted(p.name for p in (tmp_path / "out").glob("*.tif")) == \
        ["depth_2.tif", "depth_4.tif", "depth_6.tif"]
    handle.close()


def test_api_abort_between_batches(tmp_path):
    """abort() stops a background run at the next batch boundary, without
    an error; the run did not reach its end."""
    xml = _gauge_model(tmp_path, duration=3600, outfreq=3600, targets="")
    handle = api.simulation_load(xml, device="cpu")
    handle.simulation.config.batch_auto = False
    handle.simulation._batch_size = 8
    started = []
    handle.on_progress(lambda h, t, el: started.append(t))
    handle.launch(blocking=False)
    _wait(lambda: started)
    handle.abort()
    assert not handle.running and handle.error is None
    assert 0.0 < handle.time < 3600.0


def test_api_surfaces_a_thread_error(tmp_path):
    """An exception on the background thread is kept in .error."""
    handle = api.simulation_load(_gauge_model(tmp_path, targets=""),
                                 device="cpu")
    sim = handle.simulation
    z = sim.state.z.clone()
    z[8, 4] = float("nan")
    sim.state = sim.state._replace(z=z)
    handle.launch(blocking=False)
    _wait(lambda: not handle.running)
    assert isinstance(handle.error, RuntimeError)
    assert "diverged" in str(handle.error)


def test_api_default_device_needs_cuda(tmp_path, monkeypatch):
    """device=None is the first CUDA device; without CUDA it raises and
    does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.simulation_load(_gauge_model(tmp_path))
