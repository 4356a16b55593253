"""chip_smoke.py without a card: it refuses to run, and its model writers,
main-path phases, launch checks and kernels record work on the CPU, so the
script does not rot between runs on the card."""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke

torch.set_num_threads(1)
ROOT = Path(chip_smoke.__file__).parent


def _run(script, cwd):
    return subprocess.run([sys.executable, str(script)], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env={"CUDA_VISIBLE_DEVICES": "",
                               "PATH": "/usr/bin:/bin"})


def test_refuses_without_cuda():
    res = _run(ROOT / "chip_smoke.py", ROOT)
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
    assert '"ok"' not in res.stdout


def test_refuses_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run(tmp_path / "chip_smoke.py", tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def _main_path_on_cpu(tmp_path, scheme):
    # 30 s leaves up to 1 s of the last hydrological chunk unapplied
    # (~3%), hence the looser mass tolerance than the card's 600 s run.
    res = chip_smoke.run_main_path(tmp_path, "cpu", 32, 48, 30.0, 15.0,
                                   mass_tol=0.05, scheme=scheme)
    assert res["steps"] > 0
    assert set(res["launches"]) == set(chip_smoke.kernel_wrappers())
    assert not any(res["launches"].values())
    assert res["volume"] == pytest.approx(res["expected"], rel=0.05)
    assert (tmp_path / "output" / "maxdepth_30.tif").is_file()
    return res


def test_main_path_on_cpu(tmp_path):
    res = _main_path_on_cpu(tmp_path, "godunov")
    assert "Scheme:      godunov" in res["log"]


def test_muscl_main_path_on_cpu(tmp_path):
    """Phase 4b's XML name "musclhancock" runs MUSCL-Hancock, whose
    two-cell ring the forced area leaves out."""
    res = _main_path_on_cpu(tmp_path, "musclhancock")
    assert "Scheme:      muscl-hancock" in res["log"]
    assert res["expected"] == pytest.approx(
        chip_smoke._forced_volume(32, 48, 2, 30.0))


def test_api_path_on_cpu(tmp_path):
    """Phase 4c's recompute-variant run through the embedding API
    (simulation_load -> launch on a thread -> field in on_output), on the
    CPU (plain versions, so no launches)."""
    res = chip_smoke.run_api_path(tmp_path, "cpu", 32, 48, 30.0,
                                  "recompute", mass_tol=0.05)
    assert res["steps"] > 0 and not any(res["launches"].values())
    assert not list((tmp_path / "output").glob("*"))   # no raster written


def test_radar_path_on_cpu(tmp_path):
    """Phase 4f's model and checks at 96x128 and 60 s (rain frames every
    20 s on 50 m cells, outputs every 30 s): run B resumed from run A's
    30 s checkpoint writes no 30 s raster, and its 60 s raster and gauge
    row are bit-equal to A's (checked inside); A's mass balance against
    the frames' rain minus the loss; the band DEMs stitched equal the
    loader's bed; the output events are timed part by part."""
    from hipims_tpu_torch.runtime import checkpoint, output

    res = chip_smoke.run_radar_path(tmp_path, "cpu", 96, 128, 60.0, 30.0,
                                    interval=20.0, rain_cell=50.0,
                                    mass_tol=0.05)
    a, b = res["a"], res["b"]
    assert not any(a["launches"].values()) and not any(b["launches"].values())
    assert 0 < b["steps"] < a["steps"]
    assert abs(res["rel"]) < 0.05 and res["expected"] > 0.0
    assert [set(e) for e in res["events_a"]] == \
        [{"copy", "raster", "gauge", "checkpoint"}] * 2
    assert [set(e) for e in res["events_b"]] == [{"copy", "raster", "gauge"}]
    header, *rows = res["gauges"]
    assert header.split(",")[1:] == [f"G{k}" for k in range(1, 9)]
    assert [r.split(",")[0] for r in rows] == ["30.000000", "60.000000"]
    assert all(float(v) > 0.0 for v in rows[-1].split(",")[1:])
    assert sorted(p.name for p in (tmp_path / "topography").iterdir()) == \
        ["dem_part0.img", "dem_part1.img"]
    assert len(list((tmp_path / "boundaries").glob("radar_*.asc"))) == 4
    # The timing patches are undone.
    assert output.GaugeOutputWriter.__call__.__name__ == "__call__"
    assert checkpoint.save_checkpoint.__module__ == checkpoint.__name__


def test_streamed_radar_path_on_cpu(tmp_path):
    """Phase 4i's runs and checks at 96x128 and 60 s with --io-mode stream
    (the card's 16.78 M cells stream by default): runs A and B stream
    every output event, run G gathers, A's rasters and gauge CSV are G's
    bytes and B resumes bit-equal to A (both checked inside); each
    streamed event is timed by part and records its largest chunk set."""
    from hipims_tpu_torch.runtime import sharded_io, simulation

    res = chip_smoke.run_radar_path(tmp_path, "cpu", 96, 128, 60.0, 30.0,
                                    interval=20.0, rain_cell=50.0,
                                    mass_tol=0.05, io_mode="stream",
                                    gather_run=True)
    streamed = {"snapshot", "chunks", "raster", "gauge", "volume",
                "chunk_set_bytes"}
    assert [set(e) for e in res["events_a"]] == \
        [streamed | {"checkpoint"}] * 2
    assert [set(e) for e in res["events_b"]] == [streamed]
    assert [set(e) for e in res["events_g"]] == [{"copy", "raster",
                                                  "gauge"}] * 2
    # 96 rows under the default 64 MiB budget: one chunk set of the grid.
    assert res["events_a"][0]["chunk_set_bytes"] == 96 * 128 * 4 * 6
    assert abs(res["rel"]) < 0.05
    assert "largest chunk set 0.28 MiB" in chip_smoke.format_events(
        res["events_a"])
    # The timing patches are undone.
    assert sharded_io.host_rows.__module__ == sharded_io.__name__
    assert simulation._StreamingSnapshot.stream_chunks.__name__ == \
        "stream_chunks"


def test_mesh_stream_path_on_cpu(tmp_path):
    """Phase 5g on CPU blocks: a 2x2 mesh run in forecast windows with
    io_mode "stream" and the default (wall-clock) batches writes, at every
    event, the rasters, gauge CSV and checkpoint members of a gathered
    snapshot of the same state (checked inside)."""
    res = chip_smoke.run_mesh_stream_path(tmp_path, "cpu", 48, 48, 20.0,
                                          10.0, interval=10.0)
    assert res["steps"] > 0 and res["window"] > 1
    assert not any(res["launches"].values())
    assert (tmp_path / "output_b" / "depth_20.tif").is_file()
    assert (tmp_path / "output" / "depth_20.tif").read_bytes() == \
        (tmp_path / "output_b" / "depth_20.tif").read_bytes()


def test_mesh_stream_path_names_the_members_that_differ(tmp_path,
                                                        monkeypatch):
    """A streamed mesh checkpoint that differs from the gathered one
    fails phase 5g with the member's name and its max|diff|."""
    from hipims_tpu_torch.runtime import sharded_io

    host_rows = sharded_io.host_rows

    def off_by_one_zmax(plane, r0, n):
        out = host_rows(plane, r0, n)
        return out + 1.0 if getattr(plane, "_name", None) == "zmax" else out

    monkeypatch.setattr(sharded_io, "host_rows", off_by_one_zmax)
    with pytest.raises(RuntimeError, match=r"'zmax': 1\.0"):
        chip_smoke.run_mesh_stream_path(tmp_path, "cpu", 48, 48, 20.0,
                                        10.0, interval=10.0)


def test_mesh_batches_change_only_the_idle_counter(tmp_path):
    """Two separate runs of phase 5g's mesh model in batches of 8 and 16
    windows (a streamed and a gathered run) write the same planes, clock
    and step count; their checkpoints differ in ``batch_skipped`` alone,
    the idle steps a batch runs past an output time.  Wall-clock batches
    make two runs' counters differ in this way, so phase 5g compares the
    streamed and gathered snapshots of one run."""
    import torch

    from hipims_tpu_torch.io.xml_config import load_config
    from hipims_tpu_torch.parallel import make_mesh

    xml = chip_smoke.write_radar_model(tmp_path, 48, 48, 20.0, 10.0,
                                       interval=10.0, rain_cell=50.0)
    for mode, batch in (("stream", 8), ("gather", 16)):
        model = load_config(xml)
        cfg = model.config
        cfg.io_mode, cfg.batch_auto, cfg.batch_size = mode, False, batch
        sim = model.simulation(mesh=make_mesh(
            4, shape=(2, 2), devices=[torch.device("cpu")] * 4))
        assert sim.window > 1
        sim.checkpoint_path = tmp_path / f"{mode}.npz"
        sim.run()
    with np.load(tmp_path / "stream.npz") as a, \
            np.load(tmp_path / "gather.npz") as b:
        assert a.files == b.files
        differ = [k for k in a.files if not np.array_equal(a[k], b[k])]
        assert differ == ["batch_skipped"]
        assert int(a["batch_skipped"]) < int(b["batch_skipped"])


def test_radar_model_loads_as_two_bands(tmp_path):
    """The radar model is a decomposed model: two <domain> row bands of
    HFA DEMs overlapping by 4 rows each side, stitched into one grid,
    with one gridded and one loss boundary, a raster and a gauge
    target."""
    from hipims_tpu_torch.io.xml_config import load_config
    from hipims_tpu_torch.ops.boundaries import (GriddedBoundary,
                                                 UniformBoundary)

    xml = chip_smoke.write_radar_model(tmp_path, 40, 56, 600.0, 300.0)
    text = xml.read_text()
    assert text.count("<domain ") == 2 and 'type="gridded"' in text
    model = load_config(xml)
    np.testing.assert_array_equal(
        model.domain.zb, chip_smoke.glasgow_bed(40, 56, 2.0).astype(
            np.float32))
    (rain, loss) = model.boundaries
    assert isinstance(rain, GriddedBoundary) and isinstance(loss,
                                                            UniformBoundary)
    assert rain.series.shape == (3, 1, 1) and rain.interval == 300.0
    assert ((rain.series >= 6.0) & (rain.series <= 70.8)).all()
    assert [t["kind"] for t in model.output_targets] == ["raster",
                                                         "timeseries"]


def test_inertial_main_path_on_cpu(tmp_path):
    """Phase 4d's model: the XML name "inertial" runs the partial-inertial
    scheme (one-cell ring) and holds the mass balance."""
    res = _main_path_on_cpu(tmp_path, "inertial")
    assert "Scheme:      inertial" in res["log"]
    assert res["expected"] == pytest.approx(
        chip_smoke._forced_volume(32, 48, 1, 30.0))


def test_breach_path_on_cpu(tmp_path):
    """Phase 4e's breach through the CLI on the CPU: two output events,
    a positive volume that does not fall, no kernel launches."""
    res = chip_smoke.run_breach_path(tmp_path, "cpu", 64, 96, 30.0, 15.0)
    assert res["steps"] > 0 and not any(res["launches"].values())
    assert len(res["volumes"]) == 2
    assert 0.0 < res["volumes"][0] <= res["volumes"][1]
    assert res["ratio"] == pytest.approx(
        res["volume"] / (chip_smoke.BREACH_M3_S * 30.0))
    assert (tmp_path / "output" / "depth_30.tif").is_file()


def test_breach_writer_matches_bench_e2e(tmp_path):
    """chip_smoke's own breach writer (the port's raster writer, no JAX
    package) gives the model of tools/bench_e2e.py's writer."""
    from hipims_tpu_torch.io.xml_config import load_config
    from tools.bench_e2e import XML, build_thamesmead_class

    spec = build_thamesmead_class(str(tmp_path / "ref"), rows=64, cols=96,
                                  duration=600.0, outfreq=600.0)
    (tmp_path / "ref" / "model.xml").write_text(
        XML.format(precision="double", **spec))
    want = load_config(tmp_path / "ref" / "model.xml")
    got = load_config(chip_smoke.write_thamesmead_model(
        tmp_path / "own", 64, 96, 600.0, 600.0))
    for name in ("zb", "manning"):
        assert (getattr(got.domain, name) == getattr(want.domain, name)).all()
    (g,), (w,) = got.boundaries, want.boundaries
    for f in ("rows", "cols", "series"):
        assert (getattr(g, f) == getattr(w, f)).all(), f
    for f in ("interval", "length", "depth_mode", "discharge_mode"):
        assert getattr(g, f) == getattr(w, f), f
    assert got.config.scheme == want.config.scheme == "godunov"


def test_kernel_bounds():
    """Every kernel of the port has a cost entry; the bounds of the
    fused steps at 9.04 M cells are PERF.md's 40 / 48 / 80 B/cell.  The
    time controller's kernel moves no plane (its cost is its launch), so
    it is the one wrapper without a cost entry."""
    assert (set(chip_smoke.KERNEL_COST) | {"advance"}
            == set(chip_smoke.kernel_wrappers()))
    cells = 2944 * 3072
    for mode, want in (("f32", 0.108), ("f32c", 0.130), ("f64", 0.216)):
        ms, by = chip_smoke.kernel_bound("inertial_fused", mode, cells, 0.5)
        assert (round(ms, 3), by) == (want, "bytes")
    # K1 and K3, counted at two face solves per cell, stay bound by their
    # bytes: 48 and 96 B/cell in f32c.
    for name, want in (("godunov_fused", 0.130), ("muscl_correct", 0.259)):
        for mode in ("f32", "f32c", "f64"):
            assert chip_smoke.kernel_bound(name, mode, cells, 1.0)[1] == \
                "bytes"
        ms, _ = chip_smoke.kernel_bound(name, "f32c", cells, 1.0)
        assert round(ms, 3) == want
    # K5b, counted at two face solves per cell and one predictor
    # evaluation per second-order cell, is bound by its bytes, 40 / 48 /
    # 80 B/cell, whatever the share of second-order cells.
    for mode, want in (("f32", 0.108), ("f32c", 0.130), ("f64", 0.216)):
        for share in (0.0, 1.0):
            ms, by = chip_smoke.kernel_bound("muscl_fused", mode, cells,
                                             share)
            assert (round(ms, 3), by) == (want, "bytes")


def test_expect_launches():
    chip_smoke._expect_launches("x", {"a": 3, "b": 0}, {"a": 3})
    with pytest.raises(RuntimeError, match="b launched 1 times"):
        chip_smoke._expect_launches("x", {"a": 3, "b": 1}, {"a": 3})
    with pytest.raises(RuntimeError, match="a launched 0 times"):
        chip_smoke._expect_launches("x", {"a": 0}, {"a": 0})


def test_kernels_record():
    """Seven kernels, every key of the kernels line, the f32c numbers of
    the main-path grid, and the bound computed for the given inputs."""
    names = list(chip_smoke.KERNEL_SOURCES)
    rows, cols = chip_smoke.CASES[-1][:2]
    times = {(n, r, c, m): (1.0 + k, 2.0 + k) for k, n in enumerate(names)
             for r, c, *_ in chip_smoke.CASES for m in ("f64", "f32c")}
    rec = chip_smoke.kernels_record(
        times, {n: 0.0 for n in names}, {n: 7 for n in names}, rows * cols,
        0.25, {n: 4 for n in names})
    assert [r["name"] for r in rec] == names and len(rec) == 7
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "mesh_launches"}
    for k, r in enumerate(rec):
        assert set(r) == keys and r["route"] == "cuda"
        assert (r["ms"], r["plain_ms"], r["launches"],
                r["mesh_launches"]) == (1.0 + k, 2.0 + k, 7, 4)
        assert (ROOT / r["source"]).is_file()
        path, line = r["replaces"].split(":")
        assert "pallas_call" in (ROOT / path).read_text() and int(line) > 0
        assert (r["bound_ms"], r["bound_by"]) == chip_smoke.kernel_bound(
            r["name"], "f32c", rows * cols, 0.25)


def test_kernels_record_lists_k5b_mesh_mode():
    """Phase 3d's K5b mesh mode is an eighth entry with every key, its own
    times, launches and error, and its bound for the blocks' cells."""
    names = list(chip_smoke.KERNEL_SOURCES)
    rows, cols = chip_smoke.CASES[-1][:2]
    times = {(n, rows, cols, "f32c"): (1.0, 2.0) for n in names}
    mesh = dict(ms=0.8, plain_ms=30.0, cells=9_200_000, err=0.0,
                launches=12)
    rec = chip_smoke.kernels_record(
        times, {n: 0.0 for n in names}, {n: 7 for n in names}, rows * cols,
        0.25, {n: 4 for n in names}, mesh)
    assert len(rec) == 8 and set(rec[7]) == set(rec[0])
    r = rec[7]
    assert r["name"] == "muscl_fused_mesh" and r["source"] == rec[2]["source"]
    assert (r["ms"], r["plain_ms"], r["launches"], r["replaces"]) == (
        0.8, 30.0, 12, rec[2]["replaces"])
    assert (r["bound_ms"], r["bound_by"]) == chip_smoke.kernel_bound(
        "muscl_fused", "f32c", 9_200_000, 0.25)


@pytest.mark.parametrize("patch", [(5, 7), (10, 10)])
def test_patch_manning_is_constant_per_patch(patch):
    """One Manning value per land-use patch, inside random_domain's range,
    and different across patch edges (K4's two branches in one warp)."""
    pr, pc = patch
    n = chip_smoke.patch_manning(23, 41, pr, pc)
    assert n.shape == (23, 41) and n.flags.c_contiguous
    assert ((n >= 0.01) & (n <= 0.06)).all()
    for r0 in range(0, 23, pr):
        for c0 in range(0, 41, pc):
            block = n[r0:r0 + pr, c0:c0 + pc]
            assert (block == block[0, 0]).all()
    assert (n[:, pc] != n[:, pc - 1]).any() and (n[pr] != n[pr - 1]).any()


def test_mesh_paths_on_cpu(tmp_path):
    """Phases 4g and 4h on CPU blocks: the pluvial model as a lock-step
    2x2 mesh writes rasters bit-equal to the one-device run's (checked
    inside _same_rasters), and the radar model as a 2x1 mesh takes its
    forecast window from the bands' overlap, holds the mass balance and
    stays within the window-mode bars of the one-device depth."""
    one = _main_path_on_cpu(tmp_path / "one", "godunov")
    mesh = chip_smoke.run_main_path(tmp_path / "mesh", "cpu", 32, 48, 30.0,
                                    15.0, mass_tol=0.05, sync="timestep",
                                    extra=("--mesh-shape", "2x2"))
    assert "Window:      1 step(s)" in mesh["log"]
    assert mesh["steps"] == one["steps"]
    for t in (15.0, 30.0):
        chip_smoke._same_rasters("4g", tmp_path / "mesh", tmp_path / "one",
                                 t)
    ref = chip_smoke.run_radar_path(tmp_path / "radar", "cpu", 96, 128, 60.0,
                                    30.0, interval=20.0, rain_cell=50.0,
                                    mass_tol=0.05)
    res = chip_smoke.run_mesh_radar_path(
        tmp_path / "mesh_radar", "cpu", 96, 128, 60.0, 30.0,
        ref_root=tmp_path / "radar", interval=20.0, rain_cell=50.0,
        mass_tol=0.05)
    assert res["window"] == 3 and res["reruns"] >= 0
    assert abs(res["rel"] - ref["rel"]) < 0.01
    assert res["mean_diff"] <= chip_smoke.WINDOW_DEPTH_BARS[0]
    assert not any(res["launches"].values())


def test_mesh_kernels_phase_on_cpu(monkeypatch):
    """Phase 3d's checks at a small grid with the plain versions on the
    CPU (the timing stubbed): the blocks of a 2x2 split and a ragged
    south-east block agree with the plain versions and, on their owned
    cells, with the whole grid's step."""
    monkeypatch.setattr(chip_smoke, "CASES", ((130, 197, 1, 1),))
    monkeypatch.setattr(chip_smoke, "_time_ms", lambda torch, fn, reps: 0.0)
    blocks = chip_smoke.mesh_blocks
    monkeypatch.setattr(chip_smoke, "mesh_blocks", lambda rows, cols: blocks(
        rows, cols, ragged=(37, 53)))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    times = {(n, 130, 197, m): (0.0, 0.0) for n in chip_smoke.MESH_KERNELS
             for m in ("f64", "f32", "f32c")}
    worst, mesh_times, (k5b_plain_ms, cells) = \
        chip_smoke.phase_mesh_vs_plain(torch, torch.device("cpu"), times)
    assert set(worst) == set(chip_smoke.MESH_KERNELS)
    assert "muscl_fused" in worst
    assert all(v == 0.0 for v in worst.values())
    assert len(mesh_times) == 15 and k5b_plain_ms == 0.0
    # The four blocks of a 2x2 split, each extended by 17 cells a side.
    assert cells == sum((nr + 34) * (nc + 34) for _, nr, _, nc in
                        chip_smoke.mesh_blocks(130, 197)[:4])


def test_ranks_main_path_on_cpu(tmp_path):
    """Phase 4j's two ranks (this script's --rank-worker processes, gloo
    on the CPU) at 64x48, 20 s: rasters byte-equal to the one-process
    run's, one checkpoint, the ranks agreeing (checked inside).  Both
    runs take fixed batches of 8 steps (the scheme's queueSize), so their
    idle steps, which a batch runs past the output time, are equal too:
    batches sized by the wall clock differ between two runs."""
    one = chip_smoke.run_main_path(tmp_path / "one", "cpu", 64, 48, 20.0,
                                   20.0, mass_tol=0.1, sync="timestep",
                                   queue_size=8)
    res = chip_smoke.run_ranks_main_path(tmp_path / "two", 64, 48, 20.0,
                                         ref_root=tmp_path / "one",
                                         device="cpu", mass_tol=0.1,
                                         queue_size=8)
    assert (res["steps"], res["idle"]) == (one["steps"], one["idle"])
    assert [r["rank"] for r in res["ranks"]] == [0, 1]
    assert "comp" in res["members"] and res["checkpoint_mb"] > 0
    assert not any(res["launches"].values())
    # Host-staged (no device group on the CPU): the max is read back to
    # the host at every lock-step step.
    assert res["groups"] == {"world": "gloo", "device": None}
    assert res["reads"] >= 2 * res["steps"]


def test_cards_main_path_on_cpu(tmp_path):
    """Phase 4k at 64x48, 20 s on the CPU: (a) the 2x2 mesh in one
    process on four CPU blocks and (b) on four ranks (gloo, no device
    group on the CPU) write phase 4's rasters byte for byte, whole
    checkpoints, equal steps and idle steps (fixed batches), and their
    lock-step steps read nothing back in one process; the ranks' do,
    host-staged."""
    chip_smoke.run_main_path(tmp_path / "one", "cpu", 64, 48, 20.0, 20.0,
                             mass_tol=0.1, sync="timestep")
    res = chip_smoke.run_cards_main_path(tmp_path / "cards", 64, 48, 20.0,
                                         tmp_path / "one", 4, device="cpu",
                                         mass_tol=0.1, queue_size=8)
    a, b = res["a"], res["b"]
    assert a["devices"] == ["cpu"] and a["reads"] == 0
    assert len(b["ranks"]) == 4 and b["reads"] > 0
    assert all(r["groups"] == {"world": "gloo", "device": None}
               for r in b["ranks"])
    assert (a["steps"], a["idle"]) == (b["steps"], b["idle"])
    assert "comp" in a["members"] and a["members"] == b["members"]


@pytest.mark.parametrize("cards", [0, 1, 2, 4])
def test_multi_card_phases_say_when_not_run(cards):
    line = chip_smoke.not_run("4k", cards)
    if cards >= 2:
        assert line is None
    else:
        assert line == (f"phase 4k: not run: needs 2+ CUDA devices, "
                        f"{cards} visible")


def test_ranks_stream_path_on_cpu(tmp_path):
    """Phase 5h at 48x48, 20 s: the radar model streamed as a 2x2 mesh on
    two ranks equals the one-process run in outputs, checkpoint members
    and re-runs (checked inside)."""
    res = chip_smoke.run_ranks_stream_path(tmp_path, 48, 48, 20.0, 10.0,
                                           interval=10.0, device="cpu")
    assert res["window"] == 3 and res["steps"] > 0
    assert "comp" in res["members"] and "batch_skipped" in res["members"]


def test_phase_3f_rehearsed_on_the_cpu():
    """Phase 3f on CPU tensors, where the wrapper runs the plain version:
    the sweep takes every branch of the ladder in both dtypes, and the
    dam break's chain (here 48 x 80, 120 steps) runs carry by carry."""
    res = chip_smoke.phase_advance_vs_plain(torch, torch.device("cpu"),
                                            count=300, chain_steps=120,
                                            grid=(48, 80))
    assert res["cases"] == 600 and res["n_partials"] == 1920
    for branches in res["branches"].values():
        assert all(n > 0 for n in branches.values()), branches
    assert res["chain_steps"] + res["chain_idle"] == 120
    assert res["chain_steps"] > 0 and res["chain_t"] > 0.0
    assert set(res["host_us"]) == {"kernel", "plain"}
