"""Streamed (bounded-memory) output and checkpoint I/O in the port, on the
CPU, against its own gathered path and the JAX package's streamed path
(tests/test_sharded_io.py holds the JAX package to the same bars).

Every model here is a circular dam on a 61 x 67 grid at 2 m with an
undulating bed, run with ``io_chunk_mb=0`` so a chunk is 8 rows and the
chunks cross the blocks of the meshes: one device, a 2x2 CPU mesh and the
ragged (2, 4) mesh, all lock-step, so a mesh run equals the one-device run.
Bars: the port's streamed TIFF, ASC and HFA files, checkpoints and gauge
CSVs are byte-equal (``np.load``-equal) to its gathered ones; its rasters
equal the JAX package's streamed rasters to atol 1e-5 (the CLI tests' bar),
its gauge rows the JAX package's text in float64; its volume, a float64
sum on the device, the host sum to rel 1e-12 and the JAX package's
streamed volume to rel 1e-6; an f32c resume from a streamed checkpoint is
bit-equal to the uninterrupted run, and the resume from a JAX streamed
(deflated) checkpoint within 1e-12 of the resume from the port's own.
"""

import numpy as np
import pytest
import torch

from hipims_tpu.domain import Domain as JDomain
from hipims_tpu.runtime import Simulation as JSimulation
from hipims_tpu.runtime import SimulationConfig as JConfig
from hipims_tpu.runtime import checkpoint as jck
from hipims_tpu.runtime import output as jout
from hipims_tpu.runtime import sharded_io as jio
from hipims_tpu.runtime.simulation import \
    _StreamingSnapshot as JStreamingSnapshot
from hipims_tpu_torch.domain import Domain
from hipims_tpu_torch.io.raster import (AscStripWriter, Raster, read_raster,
                                       write_raster)
from hipims_tpu_torch.io.xml_config import load_config
from hipims_tpu_torch.parallel import halo_deep, make_mesh
from hipims_tpu_torch.runtime import Simulation, SimulationConfig
from hipims_tpu_torch.runtime import checkpoint as ck
from hipims_tpu_torch.runtime import output as out
from hipims_tpu_torch.runtime import sharded_io as sio
from hipims_tpu_torch.runtime import simulation as simulation_mod
from hipims_tpu_torch.runtime.simulation import (_OutputSnapshot,
                                                 _StreamingSnapshot)

torch.set_num_threads(1)
ROWS, COLS = 61, 67
MESHES = [None, (2, 2), (2, 4)]
TARGETS = [dict(value="depth", format="tif", target="depth_%t.tif"),
           dict(value="fsl", format="asc", target="fsl_%t.asc"),
           dict(value="velocityx", format="tif", target="vx_%t.tif"),
           dict(value="maxdepth", format="hfa", target="maxdepth_%t.img")]
GAUGES = [(40.0, 40.0, "G1"), (96.0, 100.0, "G2"), (10.0, 110.0, "G3"),
          (500.0, 10.0, "off-grid")]


def _domain(cls):
    yy, xx = np.mgrid[0:ROWS, 0:COLS]
    zb = 0.3 * np.sin(yy / 5.0) * np.cos(xx / 7.0)
    d = cls(zb=zb, manning=0.02, dx=2.0, dy=2.0)
    r = np.hypot((yy - ROWS / 2) * 2.0, (xx - COLS / 2) * 2.0)
    d.set_initial_depth(np.where(r <= ROWS / 2.5, 1.5, 0.1))
    return d


def _cfg(cls, io_mode, dtype, **kw):
    return cls(**{**dict(scheme="godunov", duration=8.0,
                         output_frequency=4.0, dtype=dtype, batch_size=8,
                         batch_auto=False, io_mode=io_mode, io_chunk_mb=0),
                  **kw})


def _sim(io_mode="gather", mesh=None, dtype="float64", writer=None):
    m = None if mesh is None else make_mesh(
        shape=mesh, devices=["cpu"] * (mesh[0] * mesh[1]))
    return Simulation(_domain(Domain), _cfg(SimulationConfig, io_mode, dtype),
                      output_writer=writer, device=None if m else "cpu",
                      mesh=m)


def _jsim(dtype="float64", writer=None):
    return JSimulation(_domain(JDomain), _cfg(JConfig, "stream", dtype),
                       output_writer=writer)


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.fixture(scope="module")
def jax_rasters(tmp_path_factory):
    """The JAX package's streamed rasters of the model, decoded."""
    d = tmp_path_factory.mktemp("jax_rasters")
    jsim = _jsim()
    jsim.output_writer = jout.RasterOutputWriter(TARGETS, str(d),
                                                 jsim.domain)
    jsim.run()
    return {p.name: read_raster(p).data for p in d.iterdir()}


# ---------------------------------------------------------------------------
# sharded_io


@pytest.mark.parametrize("cols", [1, 67, 4096, 100_000])
@pytest.mark.parametrize("n_fields,budget_mb", [(1, 64), (6, 64), (6, 0),
                                                (4, 7)])
def test_chunk_rows_for_equals_jax(cols, n_fields, budget_mb):
    got = sio.chunk_rows_for(cols, n_fields=n_fields, budget_mb=budget_mb)
    assert got == jio.chunk_rows_for(cols, n_fields=n_fields,
                                     budget_mb=budget_mb)
    assert got % 8 == 0 and got >= 8


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("reverse", [False, True])
def test_stream_rows_round_trip(mesh, reverse):
    """Chunks of a plane (a tensor, or a mesh's OwnedPlane) re-assemble to
    the plane, in ascending or descending order, with the chunk
    boundaries of the JAX package's stream_global_rows on the same
    array."""
    import jax.numpy as jnp

    sim = _sim(mesh=mesh)
    sim.run_to(4.0)
    want = sim.state.z.numpy()
    plane = _StreamingSnapshot(sim).plane("z")
    got = np.full_like(want, np.nan)
    spans = []
    for r0, chunk in sio.stream_rows(plane, 24, reverse=reverse):
        assert chunk.shape[0] <= 24
        got[r0:r0 + chunk.shape[0]] = chunk
        spans.append((r0, chunk.shape[0]))
    np.testing.assert_array_equal(got, want)
    jspans = [(r0, c.shape[0]) for r0, c in jio.stream_global_rows(
        jnp.asarray(want), 24, reverse=reverse)]
    assert spans == jspans
    assert [r0 for r0, _ in spans] == sorted((r0 for r0, _ in spans),
                                             reverse=reverse)


def test_checkpoint_writer_refuses_a_short_member(tmp_path):
    with sio.StreamingCheckpointWriter(tmp_path / "c.npz") as zw:
        with pytest.raises(ValueError, match="streamed 8 of 10 rows"):
            zw.stream_array("z", (10, 3), np.float32,
                            [np.zeros((8, 3), np.float32)])


def test_asc_writer_refuses_a_short_grid(tmp_path):
    w = AscStripWriter(tmp_path / "a.asc", 3, 4)
    w.write_rows(np.zeros((3, 3)))
    with pytest.raises(ValueError, match="wrote 3 of 4 rows"):
        w.close()


def test_asc_strips_equal_the_gathered_writer(tmp_path):
    """ASC rows written in strips of any height are the gathered writer's
    bytes."""
    data = np.random.default_rng(0).uniform(-9999.0, 50.0, (13, 7))
    write_raster(tmp_path / "g.asc", Raster(data, xll=1.5, yll=-2.0,
                                            cell_size=0.5))
    w = AscStripWriter(tmp_path / "s.asc", 7, 13, xll=1.5, yll=-2.0,
                           cell_size=0.5)
    for r0 in range(0, 13, 5):
        w.write_rows(data[r0:r0 + 5])
    w.close()
    assert (tmp_path / "s.asc").read_bytes() == \
        (tmp_path / "g.asc").read_bytes()


# ---------------------------------------------------------------------------
# Rasters, gauges, volume


@pytest.mark.parametrize("mesh", MESHES)
def test_streamed_rasters_equal_gathered_bytes(tmp_path, mesh, jax_rasters):
    """TIFF, ASC and HFA: streamed files byte-equal to the gathered ones
    (two events x four targets), and their values equal to the JAX
    package's streamed rasters to atol 1e-5."""
    files = {}
    for mode in ("gather", "stream"):
        sim = _sim(io_mode=mode, mesh=mesh)
        sim.output_writer = out.RasterOutputWriter(TARGETS,
                                                   str(tmp_path / mode),
                                                   sim.domain)
        sim.run()
        files[mode] = _files(tmp_path / mode)
    assert len(files["gather"]) == 8
    assert files["gather"] == files["stream"]
    assert set(files["stream"]) == set(jax_rasters)
    for name in files["stream"]:
        got = read_raster(tmp_path / "stream" / name).data
        assert got.shape == (ROWS, COLS)
        np.testing.assert_allclose(got, jax_rasters[name], rtol=0,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("mesh", [None, (2, 4)])
def test_streamed_gauge_rows_equal_gathered_and_jax(tmp_path, mesh):
    """The gauge CSV of a streamed run is the gathered run's text, and the
    JAX package's streamed run's, in float64."""
    text = {}
    for mode in ("gather", "stream"):
        sim = _sim(io_mode=mode, mesh=mesh)
        sim.output_writer = out.GaugeOutputWriter(
            "depth", GAUGES, tmp_path / f"{mode}.csv", sim.domain)
        sim.run()
        text[mode] = (tmp_path / f"{mode}.csv").read_text()
    jsim = _jsim()
    jsim.output_writer = jout.GaugeOutputWriter(
        "depth", GAUGES, tmp_path / "jax.csv", jsim.domain)
    jsim.run()
    assert text["gather"].count("\n") == 3
    assert text["stream"] == text["gather"]
    assert text["stream"] == (tmp_path / "jax.csv").read_text()


def _host_volume(sim):
    """The volume as a float64 sum on the host copy of the state (the
    JAX package's gathered ``domain_volume``)."""
    st, zb = sim.state_logical, sim.static_logical.zb
    h = np.maximum(st.z.astype(np.float64) - zb.astype(np.float64), 0.0)
    h[st.zmax <= -9999.0] = 0.0
    return float(h.sum() * sim.domain.dx * sim.domain.dy)


@pytest.mark.parametrize("mesh", [None, (2, 4)])
def test_volume_on_device_equals_host_sum_and_jax(mesh):
    """The volume, a float64 sum on the device (under a mesh, over each
    block's owned cells), equals the float64 host sum of the gathered
    state to rel 1e-12, the JAX package's gathered volume to rel 1e-12
    and its streamed (state-dtype) volume to rel 1e-6; both snapshots
    read the simulation's."""
    sim = _sim(io_mode="stream", mesh=mesh)
    sim.run_to(4.0)
    v = sim.volume()
    assert v > 0.0
    assert v == pytest.approx(_host_volume(sim), rel=1e-12, abs=0)
    assert _StreamingSnapshot(sim).volume() == v
    assert _OutputSnapshot(sim).volume() == v
    jsim = _jsim()
    jsim.run_to(4.0)
    assert v == pytest.approx(jout.domain_volume(jsim, jsim.domain),
                              rel=1e-12, abs=0)
    v_jax = jout.domain_volume(JStreamingSnapshot(jsim), jsim.domain)
    assert v == pytest.approx(v_jax, rel=1e-6, abs=0)


@pytest.mark.parametrize("mesh", MESHES)
def test_gathered_snapshot_reads_as_one_chunk(mesh):
    """The gathered snapshot answers the streamed snapshot's reads: its
    host copy as one chunk, equal to the streamed chunks, and the same
    sampled cells."""
    sim = _sim(io_mode="stream", mesh=mesh)
    sim.run_to(4.0)
    gathered, streamed = _OutputSnapshot(sim), _StreamingSnapshot(sim)
    (r0, st, sc), = gathered.stream_chunks()
    assert r0 == 0 and st.z.shape == (ROWS, COLS)
    chunks = list(streamed.stream_chunks())
    assert len(chunks) == -(-ROWS // streamed.chunk_rows)
    for k, name in enumerate(st._fields):
        np.testing.assert_array_equal(
            np.concatenate([c[1][k] for c in chunks]), st[k], err_msg=name)
    rows, cols = [0, 30, 31, 60], [66, 33, 34, 0]
    for a, b in zip(gathered.sample_cells(rows, cols),
                    streamed.sample_cells(rows, cols)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", ["state_logical", "static_logical",
                                  "state_full", "static_full", "comp_full"])
def test_streaming_snapshot_guards_the_full_grid(name):
    snap = _StreamingSnapshot(_sim(io_mode="stream"))
    with pytest.raises(AttributeError, match="streaming"):
        getattr(snap, name)
    assert snap.domain is snap._sim.domain        # the rest delegates


# ---------------------------------------------------------------------------
# Checkpoints


@pytest.mark.parametrize("mesh", [None, (2, 2)])
def test_streamed_checkpoint_members_equal_gathered(tmp_path, mesh):
    sim = _sim(io_mode="stream", mesh=mesh, dtype="float32c")
    sim.run_to(4.0)
    ck.save_checkpoint(tmp_path / "g.npz", sim, snapshot=_OutputSnapshot(sim))
    ck.save_checkpoint(tmp_path / "s.npz", sim,
                       snapshot=_StreamingSnapshot(sim))
    with np.load(tmp_path / "g.npz") as g, np.load(tmp_path / "s.npz") as s:
        assert g.files == s.files and "comp" in s.files
        for k in g.files:
            assert g[k].dtype == s[k].dtype, k
            np.testing.assert_array_equal(g[k], s[k], err_msg=k)
    assert not (tmp_path / "s.npz.part").exists()


def test_streamed_checkpoint_resumes_bit_equal(tmp_path):
    """An f32c run checkpointed by its streamed output event at 4 s and
    resumed equals the uninterrupted run bit for bit."""
    a = _sim(io_mode="stream", dtype="float32c")
    a.checkpoint_path = tmp_path / "ck.npz"
    a.run_to(4.0)
    a.emit_output(4.0)
    a.run_to(8.0)
    b = _sim(io_mode="stream", dtype="float32c")
    ck.load_checkpoint(tmp_path / "ck.npz", b)
    b.run_to(8.0)
    assert b.t == a.t and b.total_steps == a.total_steps
    for x, y in zip((*a.state, a.comp), (*b.state, b.comp)):
        assert torch.equal(x, y)


def test_jax_streamed_checkpoint_resumes_in_the_port(tmp_path):
    """A JAX streamed checkpoint (deflated zip64 members) loads into the
    port; the f64 resume lies within 1e-12 of the resume from the port's
    own streamed checkpoint of the same run."""
    jsim = _jsim()
    jsim.run_to(4.0)
    jck.save_checkpoint(tmp_path / "jax.npz", jsim,
                        snapshot=JStreamingSnapshot(jsim))
    sim = _sim(io_mode="stream")
    sim.run_to(4.0)
    ck.save_checkpoint(tmp_path / "port.npz", sim,
                       snapshot=_StreamingSnapshot(sim))
    runs = {}
    for name in ("jax", "port"):
        runs[name] = _sim(io_mode="stream")
        ck.load_checkpoint(tmp_path / f"{name}.npz", runs[name])
        runs[name].run_to(8.0)
    for x, y in zip(runs["jax"].state, runs["port"].state):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-12,
                                   atol=1e-12)


# ---------------------------------------------------------------------------
# The API, the XML and the bound on host memory


def _write_model(root, io_mode):
    write_raster(root / "dem.asc", Raster(np.zeros((48, 64)), cell_size=2.0))
    (root / "m.xml").write_text(f"""<?xml version="1.0"?>
    <configuration><metadata><name>F</name></metadata>
    <simulation>
      <parameter name="duration" value="4" />
      <parameter name="outputFrequency" value="2" />
      <parameter name="ioMode" value="{io_mode}" />
      <domainSet><domain type="cartesian">
        <data sourceDir="." targetDir="out/">
          <dataSource type="constant" value="depth" source="0.3" />
          <dataSource type="constant" value="manningCoefficient"
                      source="0.03" />
          <dataSource type="raster" value="structure,dem" source="dem.asc"/>
          <dataTarget type="raster" value="depth" format="GTiff"
                      target="d_%t.tif" />
        </data>
        <scheme name="Godunov" />
      </domain></domainSet></simulation></configuration>""")
    return root / "m.xml"


@pytest.mark.parametrize("mesh", [None, (2, 2)])
def test_api_field_on_streamed_snapshot(tmp_path, mesh):
    """handle.field inside on_output reads a streamed snapshot (only the
    requested field, from chunks) and equals the gathered field."""
    from hipims_tpu_torch.api import simulation_load

    xml = _write_model(tmp_path, "stream")
    m = None if mesh is None else make_mesh(shape=mesh, devices=["cpu"] * 4)
    h = simulation_load(xml, device="cpu", mesh=m)
    h.simulation.config.io_chunk_mb = 0
    got = {}

    def cb(handle, t):
        sim = handle.simulation
        assert handle._snapshot.streaming
        got[t] = (handle.field("depth"), out.derive_field(
            "depth", sim.state_logical, sim.static_logical, sim.domain.dx,
            datum=sim.domain.datum))

    h.on_output(cb).launch(blocking=True)
    assert set(got) == {2.0, 4.0}
    for field, want in got.values():
        assert field.shape == (48, 64)
        np.testing.assert_array_equal(field, want)


def test_io_mode_from_xml_selects_the_streamed_path(tmp_path):
    """<parameter name="ioMode" value="stream"> streams, runs, and writes
    the rasters of the same model with ioMode "gather"."""
    files = {}
    for mode in ("gather", "stream"):
        (tmp_path / mode).mkdir()
        model = load_config(_write_model(tmp_path / mode, mode))
        assert model.config.io_mode == mode
        sim = model.simulation(device="cpu")
        assert sim.io_streaming() is (mode == "stream")
        sim.run()
        files[mode] = _files(tmp_path / mode / "out")
    assert list(files["stream"]) == ["d_2.tif", "d_4.tif"]
    assert files["stream"] == files["gather"]


@pytest.mark.parametrize("mesh", [None, (2, 2)])
def test_streamed_event_stays_within_its_chunks(tmp_path, monkeypatch, mesh):
    """During a streamed output event (rasters, gauges, the mass balance
    and a checkpoint) nothing reads the full-grid host copies or assembles
    the mesh's blocks, and no tensor reaches the host with more than
    chunk_rows rows."""
    sim = _sim(io_mode="stream", mesh=mesh, dtype="float32c")
    sim.run_to(4.0)
    chunk_rows = _StreamingSnapshot(sim).chunk_rows
    assert chunk_rows == 8
    rasters = out.RasterOutputWriter(TARGETS[:3], str(tmp_path / "r"),
                                     sim.domain)
    gauges = out.GaugeOutputWriter("depth", GAUGES, tmp_path / "g.csv",
                                   sim.domain)
    volumes = []
    sim.output_writer = out.CompositeOutputWriter([
        rasters, gauges,
        lambda view, t: volumes.append(view.volume())])
    sim.checkpoint_path = tmp_path / "ck.npz"

    def refuse(*a, **kw):
        raise AssertionError("a full-grid read in a streamed event")

    for cls, name in ((simulation_mod.Simulation, "state_logical"),
                      (simulation_mod.Simulation, "static_logical"),
                      (halo_deep.HaloDeepBlocks, "_assemble")):
        monkeypatch.setattr(cls, name, property(refuse) if name.endswith(
            "logical") else refuse)
    copies = []
    numpy = torch.Tensor.numpy

    def counted(self, *a, **kw):
        copies.append(tuple(self.shape))
        return numpy(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "numpy", counted)
    sim.emit_output(4.0)
    monkeypatch.undo()
    planes = [s for s in copies if len(s) == 2]
    assert planes and max(s[0] for s in planes) <= chunk_rows
    assert volumes and (tmp_path / "ck.npz").exists()
    assert sorted(p.name for p in (tmp_path / "r").iterdir()) == \
        ["depth_4.tif", "fsl_4.asc", "vx_4.tif"]
    # The event's files equal a gathered event's of the same state.
    sim.config.io_mode = "gather"
    rasters.target_dir = str(tmp_path / "r_gather")
    (tmp_path / "r_gather").mkdir()
    sim.checkpoint_path = tmp_path / "ck_gather.npz"
    sim.emit_output(4.0)
    assert _files(tmp_path / "r") == _files(tmp_path / "r_gather")
    header, *rows = (tmp_path / "g.csv").read_text().splitlines()
    assert rows[0] == rows[1] and volumes[0] == pytest.approx(
        volumes[1], rel=1e-12)
