"""The port's multi-process runs: two CPU ranks under torch.distributed (gloo).

tests/test_multihost.py for the port, and not marked slow: each module
fixture spawns one cluster of two ``subprocess`` ranks, which run every
phase in one go and save what they saw; the tests below hold it against
the port's one-process runs (``torch.equal``) and the JAX package's
one-process ``make_mesh(8)`` runs (at the bars of tests/test_torch_mesh.py
and tests/test_multihost.py):

* phase A: Godunov, lock-step, a (2, 4) mesh with 4 blocks per rank,
  rank-gated rasters and gauges, the volume, a cluster checkpoint resumed
  in one process (and in the JAX package);
* phase B: MUSCL split12 in forecast windows of 2 with the NE-quadrant
  gridded rain, streamed rasters, gauges and checkpoint byte-equal to
  gathered ones, the re-runs;
* f32c with the comp exchange, lock-step and in windows, on a (3, 2) mesh
  whose strips cross ranks in both passes;
* batch sizes agreed across ranks whose clocks disagree;
* the embedding API's callbacks on rank 0 alone, and ``field`` refused
  in a streamed run;
* a NaN on rank 1 stops both ranks; the CLI's ``--distributed`` and its
  errors;
* the device-direct branch (``distributed.open_device_group``: NCCL on
  the card) run here over a second gloo group on CPU tensors, which gloo
  takes directly: its strips, maxima and NaN probe give the host-staged
  branch's results ``torch.equal`` in lock-step and windows, its
  lock-step steps read nothing back to the host, and a NaN on rank 1
  still stops both ranks; and the census's choice of groups (none on
  the CPU or where two ranks name one card).

Every spawn has a timeout and a kill, and the ranks' collectives the
process group's timeout, so a deadlock fails a test instead of hanging
the suite.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from hipims_tpu.domain import Domain as JDomain
from hipims_tpu.ops.boundaries import GriddedBoundary as JGridded
from hipims_tpu.parallel import make_mesh as jax_mesh
from hipims_tpu.runtime import Simulation as JSimulation
from hipims_tpu.runtime import SimulationConfig as JConfig
from hipims_tpu.runtime.checkpoint import load_checkpoint as jax_load
from hipims_tpu_torch.cli import main as torch_main
from hipims_tpu_torch.io.raster import read_raster
from hipims_tpu_torch.parallel import distributed, make_mesh
from hipims_tpu_torch.runtime.checkpoint import load_checkpoint
from hipims_tpu_torch.tools.model_builder import build_dam_break

REPO = Path(__file__).resolve().parent.parent
SPAWN_TIMEOUT = 240

# The ranks' program and, imported by the tests, the one-process runs it
# is held against: the same model functions on both sides.
COMMON = r'''
import numpy as np
import torch

from hipims_tpu_torch.domain import Domain
from hipims_tpu_torch.ops.boundaries import GriddedBoundary, UniformBoundary
from hipims_tpu_torch.parallel import make_mesh
from hipims_tpu_torch.runtime import Simulation, SimulationConfig
from hipims_tpu_torch.runtime.output import (CompositeOutputWriter,
                                             GaugeOutputWriter,
                                             RasterOutputWriter)

CPU = torch.device("cpu")
# World coordinates of gauges on blocks of both ranks of the (2, 4) mesh.
GAUGES = [(10.0, 10.0, "sw"), (70.0, 30.0, "s"), (30.0, 100.0, "nw"),
          (110.0, 110.0, "ne"), (66.0, 64.0, "c")]


def dam(n=64, manning=0.0):
    """tests/test_multihost.py's circular dam."""
    dom = Domain(zb=np.zeros((n, n)), manning=manning, dx=2.0, dy=2.0)
    yy, xx = np.mgrid[0:n, 0:n]
    r = np.hypot((yy - n / 2) * 2.0, (xx - n / 2) * 2.0)
    dom.set_initial_depth(np.where(r <= n * 2.0 / 8.0, 2.5, 0.5))
    return dom


def quadrant_rain(n=64):
    """tests/test_multihost.py's phase-B rain: 3600 mm/h on the NE
    quadrant of a 2x2 radar grid."""
    series = np.zeros((4, 2, 2))
    series[:, 1, 1] = 3600.0
    return GriddedBoundary(series=series, interval=600.0,
                           resolution=n * 2.0 / 2.0, offset_x=0.0,
                           offset_y=0.0, mass_flux=False, length=2400.0)


def writers(dom, root, sub, target):
    return CompositeOutputWriter([
        RasterOutputWriter([dict(value="depth", format="tif",
                                 target=target)], f"{root}/{sub}", dom),
        GaugeOutputWriter("depth", GAUGES, f"{root}/{sub}/gauges.csv",
                          dom)])


def phase_a(mesh, root=None):
    """Godunov, lock-step, 2 s with outputs every second."""
    dom = dam()
    cfg = SimulationConfig(scheme="godunov", duration=2.0,
                           output_frequency=1.0, batch_size=4,
                           batch_auto=False)
    return Simulation(dom, cfg, mesh=mesh, device=None if mesh else CPU,
                      output_writer=writers(dom, root, "a", "depth_%t.tif")
                      if root else None)


def phase_a_resumed(mesh):
    cfg = SimulationConfig(scheme="godunov", duration=3.0,
                           output_frequency=3.0, batch_size=4,
                           batch_auto=False)
    return Simulation(dam(), cfg, mesh=mesh, device=None if mesh else CPU)


def phase_b(mesh, io_mode, root=None):
    """MUSCL split12, forecast windows of 2, gridded rain, 3 s with
    outputs every 1.5 s."""
    dom = dam(manning=0.02)
    cfg = SimulationConfig(scheme="muscl-hancock", duration=3.0,
                           output_frequency=1.5, batch_size=2,
                           batch_auto=False, sync_method="forecast",
                           forecast_window=2, io_mode=io_mode)
    return Simulation(dom, cfg, boundaries=(quadrant_rain(),), mesh=mesh,
                      output_writer=writers(dom, root, "b_" + io_mode,
                                            "d_%t.tif") if root else None)


def phase_c(mesh, sync, batch_auto=False):
    """f32c, 48x48, 60 mm/h rain: lock-step or windows of 3."""
    cfg = SimulationConfig(scheme="godunov", duration=4.0,
                           output_frequency=4.0, dtype="float32c",
                           batch_size=4, batch_auto=batch_auto,
                           batch_target_seconds=1.0, sync_method=sync,
                           forecast_window=3)
    rain = UniformBoundary(values=np.full(10, 60.0), interval=600.0,
                           length=6000.0, is_loss=False)
    return Simulation(dam(48), cfg, boundaries=(rain,), mesh=mesh)
'''

WORKER = COMMON + r'''
import json
import sys
import time

from hipims_tpu_torch.parallel.distributed import (gather_to_host,
                                                   host_summary,
                                                   initialize_cluster,
                                                   is_coordinator)
from hipims_tpu_torch.runtime.checkpoint import (load_checkpoint,
                                                 save_checkpoint)

torch.set_num_threads(1)
coord, rank, root, case = sys.argv[1], int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
assert initialize_cluster(coord, 2, rank)
assert initialize_cluster(coord, 2, rank)       # again: success
mine = f"{root}/rank{rank}"
arrays, info = {}, {}

from hipims_tpu_torch.parallel import distributed
if case.endswith("device"):
    # The device-direct branch on CPU tensors: a second gloo group.
    distributed.open_device_group("gloo")
    assert distributed.groups() == dict(world="gloo", device="gloo")

if case.startswith("nan"):
    sim = phase_a(make_mesh(8, devices=[CPU] * 8))
    if rank == 1:
        b = sim._blocks.blocks[0]
        b.state.qx[b.interior][5, 5] = float("nan")
    sim.run()                                   # raises on both ranks
    raise SystemExit("no divergence was seen")

if case == "device":
    import chip_smoke
    with chip_smoke.count_host_reads() as reads:
        sim = phase_a(make_mesh(8, devices=[CPU] * 8))
        sim.run()
    arrays["a_z"] = gather_to_host(sim.state.z)
    info["a_t"], info["a_reads"] = sim.t, reads["reads"]
    for sync in ("timestep", "forecast"):
        with chip_smoke.count_host_reads() as reads:
            simC = phase_c(make_mesh(6, shape=(3, 2), devices=[CPU] * 6),
                           sync)
            simC.run()
        arrays[f"c_{sync}_z"] = gather_to_host(simC.state.z)
        arrays[f"c_{sync}_comp"] = gather_to_host(simC.comp)
        info[f"c_{sync}_reruns"] = simC.window_reruns
        info[f"c_{sync}_reads"] = reads["reads"]
        info[f"c_{sync}_steps"] = simC.total_steps + simC.total_skipped
    np.savez(f"{root}/rank{rank}.npz", **arrays)
    with open(f"{root}/rank{rank}.json", "w") as f:
        json.dump(info, f)
    distributed.shutdown()
    print("RANK_DONE", rank)
    raise SystemExit(0)

info["census"] = distributed.census("cpu")
info["groups"] = distributed.open_groups("cpu")

summary = host_summary()
info.update(summary=summary, coordinator=is_coordinator())
mesh8 = make_mesh(8, devices=[CPU] * 8)
info["ranks"] = mesh8.ranks.tolist()

# Phase A.
sim = phase_a(mesh8, mine)
sim.write_outputs = is_coordinator()
sim.run()
arrays["a_z"] = gather_to_host(sim.state.z)
arrays["a_zmax_streamed"] = gather_to_host(sim._blocks.plane("zmax"))
info["a_t"], info["a_vol"] = sim.t, sim.volume()
save_checkpoint(f"{root}/cluster_ck.npz", sim)
sim2 = phase_a_resumed(mesh8)
load_checkpoint(f"{root}/cluster_ck.npz", sim2)
sim2.run_to(3.0)
arrays["a_z3"], info["a_t3"] = gather_to_host(sim2.state.z), sim2.t

# Phase B, streamed and gathered, each with its checkpoint.
for io_mode in ("stream", "gather"):
    simB = phase_b(mesh8, io_mode, mine)
    simB.write_outputs = is_coordinator()
    simB.checkpoint_path = f"{root}/b_{io_mode}.npz"
    simB.run()
    arrays[f"b_{io_mode}_z"] = gather_to_host(simB.state.z)
    info[f"b_{io_mode}"] = dict(t=simB.t, vol=simB.volume(),
                                reruns=simB.window_reruns,
                                steps=simB.total_steps)

# f32c with the comp exchange on a (3, 2) mesh, 3 blocks a rank.
for sync in ("timestep", "forecast"):
    simC = phase_c(make_mesh(6, shape=(3, 2), devices=[CPU] * 6), sync)
    simC.run()
    arrays[f"c_{sync}_z"] = gather_to_host(simC.state.z)
    arrays[f"c_{sync}_comp"] = gather_to_host(simC.comp)
    info[f"c_{sync}_reruns"] = simC.window_reruns

# Batches sized from clocks that disagree: rank 1's runs 3x fast.
real = time.perf_counter
if rank == 1:
    time.perf_counter = lambda: 3.0 * real()
sizes = []
simD = phase_c(make_mesh(4, devices=[CPU] * 4), "forecast",
               batch_auto=True)
simD.run(progress=lambda s, t, e: sizes.append(s._batch_size))
time.perf_counter = real
info["d_sizes"], info["d_t"] = sizes, simD.t
arrays["d_z"] = gather_to_host(simD.state.z)

# The embedding API: callbacks on rank 0 alone; field() inside one reads
# the gathered snapshot, and raises on a streamed one.
from hipims_tpu_torch.api import simulation_load
from hipims_tpu_torch.tools.model_builder import build_dam_break
build_dam_break(f"{mine}/e", duration=20.0)
for io_mode in ("gather", "stream"):
    h = simulation_load(f"{mine}/e/dam-break.xml",
                        mesh=make_mesh(2, devices=[CPU] * 2))
    h.simulation.config.io_mode = io_mode
    h.simulation.write_outputs = is_coordinator()
    seen = []

    def field_at(handle, t):
        try:
            seen.append(float(handle.field("depth").max()))
        except RuntimeError as e:
            seen.append(str(e))

    h.on_output(field_at).launch()
    info[f"e_{io_mode}"] = seen

np.savez(f"{root}/rank{rank}.npz", **arrays)
with open(f"{root}/rank{rank}.json", "w") as f:
    json.dump(info, f)
# Leave the groups before the interpreter exits: a process group left to
# the interpreter's teardown can abort the process after its work is done.
distributed.shutdown()
print("RANK_DONE", rank)
'''

namespace = {}
exec(compile(COMMON, "distributed_common", "exec"), namespace)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _spawn(argvs, cwd=REPO):
    """Run one process per argv at once; returns [(returncode, output)],
    each killed at SPAWN_TIMEOUT."""
    procs = [subprocess.Popen(argv, env=_env(), cwd=cwd, text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for argv in argvs]
    out = []
    for p in procs:
        try:
            text, _ = p.communicate(timeout=SPAWN_TIMEOUT)
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
            text += "\n[killed at the spawn timeout]"
        out.append((p.returncode, text))
    return out


def _ranks(root, case):
    script = root / "worker.py"
    script.write_text(WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    return _spawn([[sys.executable, str(script), coord, str(r), str(root),
                    case] for r in (0, 1)])


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    root = tmp_path_factory.mktemp("cluster")
    for r, (rc, out) in enumerate(_ranks(root, "main")):
        assert rc == 0 and f"RANK_DONE {r}" in out, \
            f"rank {r} failed:\n{out[-4000:]}"
    return root, [np.load(root / f"rank{r}.npz") for r in (0, 1)], \
        [json.loads((root / f"rank{r}.json").read_text()) for r in (0, 1)]


@pytest.fixture(scope="module")
def device_cluster(tmp_path_factory):
    """The ranks' lock-step and window runs on the device-direct branch
    (a second gloo group standing in for NCCL)."""
    root = tmp_path_factory.mktemp("device_cluster")
    for r, (rc, out) in enumerate(_ranks(root, "device")):
        assert rc == 0 and f"RANK_DONE {r}" in out, \
            f"rank {r} failed:\n{out[-4000:]}"
    return [np.load(root / f"rank{r}.npz") for r in (0, 1)], \
        [json.loads((root / f"rank{r}.json").read_text()) for r in (0, 1)]


@pytest.fixture(scope="module")
def one_process():
    """The ranks' runs in this process: phases A (and its resume from the
    cluster's checkpoint, in the tests), B streamed, C, on the same
    meshes."""
    mesh8 = make_mesh(8, devices=[torch.device("cpu")] * 8)
    a = namespace["phase_a"](mesh8)
    a.run()
    b = namespace["phase_b"](mesh8, "stream")
    b.run()
    c = {}
    for sync in ("timestep", "forecast"):
        c[sync] = namespace["phase_c"](
            make_mesh(6, shape=(3, 2), devices=[torch.device("cpu")] * 6),
            sync)
        c[sync].run()
    return dict(a=a, b=b, c=c)


def _jax_dam(manning=0.0):
    n = 64
    dom = JDomain(zb=np.zeros((n, n)), manning=manning, dx=2.0, dy=2.0)
    yy, xx = np.mgrid[0:n, 0:n]
    r = np.hypot((yy - n / 2) * 2.0, (xx - n / 2) * 2.0)
    dom.set_initial_depth(np.where(r <= 16.0, 2.5, 0.5))
    return dom


def _mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax_mesh(8)


# ---------------------------------------------------------------------------
# The library on its own.
# ---------------------------------------------------------------------------

def test_no_process_group_leaves_make_mesh_unchanged():
    assert distributed.world_size() == 1 and distributed.is_coordinator()
    m = make_mesh(8, devices=[torch.device("cpu")] * 8)
    assert m.shape == (2, 4) and not m.ranks.any()
    assert make_mesh(3, devices=[torch.device("cpu")] * 3).shape == (1, 3)
    assert distributed.rank_device("cpu") == torch.device("cpu")
    s = distributed.host_summary()
    assert (s["process_index"], s["process_count"], s["backend"]) == \
        (0, 1, None)


@pytest.mark.parametrize("spec,want", [
    ("env", None), (" ENV ", None),
    ("10.0.0.1:29500,4,3", ("10.0.0.1:29500", 4, 3)),
    ("localhost:1234, 2, 0", ("localhost:1234", 2, 0))])
def test_parse_spec(spec, want):
    assert distributed.parse_spec(spec) == want


@pytest.mark.parametrize("spec", ["", "host:1,2", "host,2,0", "host:x,2,0",
                                  "host:1,2,2", "host:0,2,0", ":1,2,0"])
def test_parse_spec_rejects(spec):
    with pytest.raises(ValueError, match="--distributed"):
        distributed.parse_spec(spec)


def test_cluster_census(cluster):
    _, _, info = cluster
    for r, i in enumerate(info):
        s = i["summary"]
        assert (s["process_index"], s["process_count"], s["backend"]) == \
            (r, 2, "gloo")
        assert s["local_devices"] and s["global_device_count"] >= 2
        assert i["coordinator"] == (r == 0)
        assert i["ranks"] == [[0, 0, 0, 0], [1, 1, 1, 1]]


# ---------------------------------------------------------------------------
# Phase A: Godunov, lock-step.
# ---------------------------------------------------------------------------

def test_phase_a_equals_one_process(cluster, one_process):
    _, arrays, info = cluster
    a = one_process["a"]
    for r in (0, 1):
        assert info[r]["a_t"] == a.t
        assert torch.equal(torch.from_numpy(arrays[r]["a_z"]), a.state.z)
        assert np.array_equal(arrays[r]["a_zmax_streamed"],
                              a.state.zmax.numpy())
        # The volume: the blocks' sums in block order, on every rank.
        assert info[r]["a_vol"] == a.volume()


def test_phase_a_matches_jax(cluster):
    _, arrays, info = cluster
    j = JSimulation(_jax_dam(), JConfig(scheme="godunov", duration=2.0,
                                        output_frequency=1.0, batch_size=4,
                                        batch_auto=False), mesh=_mesh8())
    j.run()
    assert info[0]["a_t"] == pytest.approx(j.t, abs=1e-9)
    np.testing.assert_allclose(arrays[0]["a_z"], np.asarray(j.state.z),
                               rtol=1e-7, atol=5e-9)
    assert info[0]["a_vol"] == pytest.approx(j.volume(), rel=1e-9)


def test_phase_a_outputs_on_rank_0_only(cluster, one_process, tmp_path):
    root, _, _ = cluster
    assert sorted(os.listdir(root / "rank0" / "a")) == \
        ["depth_1.tif", "depth_2.tif", "gauges.csv"]
    assert os.listdir(root / "rank1" / "a") == []
    # The one-process run's files, written now: the same bytes.
    a = namespace["phase_a"](make_mesh(8, devices=[torch.device("cpu")] * 8),
                             tmp_path)
    a.run()
    for name in ("depth_1.tif", "depth_2.tif", "gauges.csv"):
        assert (root / "rank0" / "a" / name).read_bytes() == \
            (tmp_path / "a" / name).read_bytes(), name
    assert len((tmp_path / "a" / "gauges.csv").read_text()
               .splitlines()) == 3


def test_cluster_checkpoint_resumes_in_one_process(cluster):
    root, arrays, info = cluster
    assert not (root / "cluster_ck.npz.part").exists()
    one = namespace["phase_a_resumed"](None)
    load_checkpoint(root / "cluster_ck.npz", one)
    assert one.t == info[0]["a_t"]
    one.run_to(3.0)
    assert one.t == info[0]["a_t3"] == info[1]["a_t3"]
    for r in (0, 1):
        assert torch.equal(torch.from_numpy(arrays[r]["a_z3"]), one.state.z)
    # The JAX package resumes it too, to the JAX test's bars.
    j = JSimulation(_jax_dam(), JConfig(scheme="godunov", duration=3.0,
                                        output_frequency=3.0, batch_size=4,
                                        batch_auto=False), mesh=_mesh8())
    jax_load(root / "cluster_ck.npz", j)
    j.run_to(3.0)
    assert info[0]["a_t3"] == pytest.approx(j.t, abs=1e-9)
    np.testing.assert_allclose(arrays[0]["a_z3"], np.asarray(j.state.z),
                               rtol=1e-7, atol=5e-9)


# ---------------------------------------------------------------------------
# Phase B: MUSCL in forecast windows, gridded rain, streamed I/O.
# ---------------------------------------------------------------------------

def test_phase_b_streamed_outputs_equal_gathered(cluster):
    root, arrays, info = cluster
    s, g = root / "rank0" / "b_stream", root / "rank0" / "b_gather"
    assert sorted(os.listdir(s)) == sorted(os.listdir(g)) == \
        ["d_1.5.tif", "d_3.tif", "gauges.csv"]
    for name in os.listdir(s):
        assert (s / name).read_bytes() == (g / name).read_bytes(), name
    assert os.listdir(root / "rank1" / "b_stream") == []
    with np.load(root / "b_stream.npz") as a, \
            np.load(root / "b_gather.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
    for r in (0, 1):
        assert np.array_equal(arrays[r]["b_stream_z"],
                              arrays[r]["b_gather_z"])
        assert info[r]["b_stream"] == info[r]["b_gather"] \
            == info[0]["b_stream"]


def test_phase_b_equals_one_process_and_matches_jax(cluster, one_process):
    _, arrays, info = cluster
    b = one_process["b"]
    assert info[0]["b_stream"] == dict(t=b.t, vol=b.volume(),
                                       reruns=b.window_reruns,
                                       steps=b.total_steps)
    for r in (0, 1):
        assert torch.equal(torch.from_numpy(arrays[r]["b_stream_z"]),
                           b.state.z)
    series = np.zeros((4, 2, 2))
    series[:, 1, 1] = 3600.0
    rain = JGridded(series=series, interval=600.0, resolution=64.0,
                    offset_x=0.0, offset_y=0.0, mass_flux=False,
                    length=2400.0)
    j = JSimulation(_jax_dam(0.02), JConfig(
        scheme="muscl-hancock", duration=3.0, output_frequency=1.5,
        batch_size=2, batch_auto=False, sync_method="forecast",
        forecast_window=2), boundaries=(rain,), mesh=_mesh8())
    j.run()
    assert info[0]["b_stream"]["t"] == pytest.approx(j.t, abs=1e-9)
    np.testing.assert_allclose(arrays[0]["b_stream_z"],
                               np.asarray(j.state.z), rtol=1e-6, atol=1e-7)
    assert info[0]["b_stream"]["vol"] == pytest.approx(j.volume(), rel=1e-6)
    # Rain fell on the NE quadrant (the JAX test's bar).
    assert info[0]["b_stream"]["vol"] > info[0]["a_vol"] * 0.9


# ---------------------------------------------------------------------------
# f32c, agreed batches, divergence.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sync", ["timestep", "forecast"])
def test_f32c_comp_exchange_equals_one_process(cluster, one_process, sync):
    _, arrays, info = cluster
    c = one_process["c"][sync]
    assert c.window == (3 if sync == "forecast" else 1)
    for r in (0, 1):
        assert torch.equal(torch.from_numpy(arrays[r][f"c_{sync}_z"]),
                           c.state.z)
        assert torch.equal(torch.from_numpy(arrays[r][f"c_{sync}_comp"]),
                           c.comp)
        assert info[r][f"c_{sync}_reruns"] == c.window_reruns


def test_batches_agree_across_skewed_clocks(cluster):
    _, arrays, info = cluster
    sizes = [i["d_sizes"] for i in info]
    # One size sequence, from the slower clock (rank 1's, 3x): a rank
    # sizing from its own clock would take a batch of its own after the
    # first 4 windows, and step other frozen-speed windows.
    assert sizes[0] == sizes[1] and len(sizes[0]) > 1 and sizes[0][0] == 4
    assert info[0]["d_t"] == info[1]["d_t"] == 4.0
    assert np.array_equal(arrays[0]["d_z"], arrays[1]["d_z"])


def test_api_callbacks_fire_on_rank_0_only(cluster):
    _, _, info = cluster
    assert info[1]["e_gather"] == info[1]["e_stream"] == []
    depths = info[0]["e_gather"]
    assert len(depths) == 4 and all(isinstance(d, float) and d > 0.19
                                    for d in depths)
    assert len(info[0]["e_stream"]) == 4 and all(
        "not available in multi-process streamed-IO runs" in e
        for e in info[0]["e_stream"])


def test_nan_on_rank_1_stops_every_rank(tmp_path):
    """A NaN discharge in one of rank 1's blocks makes its step's CFL max
    NaN, which must reach every rank's clock (t = NaN), as in one process:
    gloo's ReduceOp.MAX would drop it, and only the NaN probe would stop
    the run, with a finite t."""
    one = namespace["phase_a"](make_mesh(8, devices=[torch.device("cpu")]
                                         * 8))
    b = one._blocks.blocks[4]
    b.state.qx[b.interior][5, 5] = float("nan")
    with pytest.raises(RuntimeError, match=r"diverged \(t=nan"):
        one.run()
    for r, (rc, out) in enumerate(_ranks(tmp_path, "nan")):
        assert rc != 0, f"rank {r} ran on:\n{out[-2000:]}"
        assert "Simulation diverged (t=nan" in out, \
            f"rank {r}:\n{out[-3000:]}"


# ---------------------------------------------------------------------------
# The device group: placement, and the device-direct branch.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("entries,platform,want", [
    ([("h", "cuda:0"), ("h", "cuda:1")], "gpu", "nccl"),
    ([("h0", "cuda:0"), ("h1", "cuda:0")], "gpu", "nccl"),
    ([("h", "cuda:0"), ("h", "cuda:0")], "gpu", None),
    ([("h", "cuda:0"), ("h", "cuda:1"), ("h", "cuda:1")], "gpu", None),
    ([("h", "cpu"), ("h", "cpu")], "cpu", None),
    ([("h0", "cpu"), ("h1", "cpu")], "cpu", None),
    ([("h", "cuda:0")], "gpu", None)])
def test_device_backend_by_placement(entries, platform, want):
    """NCCL only on the GPU where no two ranks name one card of one host
    (NCCL refuses two ranks on one device); otherwise host-staged."""
    assert distributed.device_backend(entries, platform) == want


def test_census_on_the_cpu_opens_no_device_group(cluster):
    _, _, info = cluster
    for r, i in enumerate(info):
        assert [tuple(e) for e in i["census"]] == [
            tuple(info[0]["census"][0]), tuple(info[1]["census"][1])]
        assert [e[1] for e in i["census"]] == ["cpu", "cpu"]
        assert i["groups"] is None
        assert i["summary"]["device_backend"] is None
    assert distributed.groups() == dict(world=None, device=None)


def test_device_branch_lock_step_equals_host_staged(cluster, device_cluster,
                                                    one_process):
    """Phase A (a (2, 4) mesh, 4 blocks a rank) and f32c lock-step on the
    (3, 2) mesh: the device-direct strips and maxima give the host-staged
    cluster's state (and the one process's), bit for bit, and no host
    read in the steps; the host-staged branch reads the max every
    step."""
    _, host, host_info = cluster
    dev, info = device_cluster
    c = one_process["c"]["timestep"]
    for r in (0, 1):
        assert torch.equal(torch.from_numpy(dev[r]["a_z"]),
                           torch.from_numpy(host[r]["a_z"]))
        assert info[r]["a_t"] == host_info[r]["a_t"]
        assert torch.equal(torch.from_numpy(dev[r]["c_timestep_z"]),
                           c.state.z)
        assert torch.equal(torch.from_numpy(dev[r]["c_timestep_comp"]),
                           c.comp)
        assert info[r]["a_reads"] == 0 and info[r]["c_timestep_reads"] == 0


def test_device_branch_windows_equal_host_staged(cluster, device_cluster,
                                                 one_process):
    """f32c in windows of 3 on the (3, 2) mesh: the same state, comp and
    re-runs as the host-staged cluster and one process; one host read per
    window (the ``violated`` predicate) and per re-run, none per step."""
    _, host, host_info = cluster
    dev, info = device_cluster
    c = one_process["c"]["forecast"]
    for r in (0, 1):
        for k in ("c_forecast_z", "c_forecast_comp"):
            assert torch.equal(torch.from_numpy(dev[r][k]),
                               torch.from_numpy(host[r][k]))
        assert torch.equal(torch.from_numpy(dev[r]["c_forecast_z"]),
                           c.state.z)
        assert info[r]["c_forecast_reruns"] == \
            host_info[r]["c_forecast_reruns"] == c.window_reruns
        windows = info[r]["c_forecast_steps"] // 3
        assert info[r]["c_forecast_reads"] == \
            windows + info[r]["c_forecast_reruns"] > 0


def test_nan_on_rank_1_stops_every_rank_on_the_device_group(tmp_path):
    """The device-direct max folds the ranks' values with torch.maximum
    as the host-staged one does, so rank 1's NaN reaches every clock."""
    for r, (rc, out) in enumerate(_ranks(tmp_path, "nan_device")):
        assert rc != 0, f"rank {r} ran on:\n{out[-2000:]}"
        assert "Simulation diverged (t=nan" in out, \
            f"rank {r}:\n{out[-3000:]}"


# ---------------------------------------------------------------------------
# The CLI.
# ---------------------------------------------------------------------------

def _cli_ranks(xml, *extra, logs=None):
    coord = f"127.0.0.1:{_free_port()}"
    return _spawn([[sys.executable, "-m", "hipims_tpu_torch", "-c", str(xml),
                    "-n", "--platform", "cpu", *extra,
                    *(("-l", str(logs[r])) if logs else ()),
                    "--distributed", f"{coord},2,{r}"] for r in (0, 1)])


def test_cli_two_ranks_equal_one_process(tmp_path, capsys):
    for d in ("one", "two"):
        build_dam_break(tmp_path / d, duration=20.0)
    assert torch_main(["-c", str(tmp_path / "one" / "dam-break.xml"), "-q",
                       "--platform", "cpu", "--mesh", "2", "--checkpoint",
                       str(tmp_path / "one.npz")]) == 0
    logs = [tmp_path / f"rank{r}.log" for r in (0, 1)]
    ck = tmp_path / "two.npz"
    res = _cli_ranks(tmp_path / "two" / "dam-break.xml", "--mesh", "2",
                     "--checkpoint", str(ck), "--mass-balance", logs=logs)
    for r, (rc, out) in enumerate(res):
        assert rc == 0, f"rank {r}:\n{out[-3000:]}"
    assert "Cluster:     2 ranks, backend gloo, device group none " \
        "(strips and maxima through the host)" in res[0][1]
    assert "Mass balance" in res[0][1] and "rank" in res[0][1]
    assert "Simulation complete" not in res[1][1]   # rank 1 is quiet
    assert logs[0].exists() and not logs[1].exists()
    assert "Mass balance" in logs[0].read_text()
    one = sorted((tmp_path / "one" / "output").glob("*.tif"))
    two = sorted((tmp_path / "two" / "output").glob("*.tif"))
    assert [p.name for p in one] == [p.name for p in two] and len(one) == 16
    for a, b in zip(one, two):
        assert a.read_bytes() == b.read_bytes(), a.name
    assert sorted(p.name for p in tmp_path.glob("two.npz*")) == ["two.npz"]
    with np.load(ck) as a, np.load(tmp_path / "one.npz") as b:
        assert float(a["t"]) == 20.0
        assert np.array_equal(a["z"], b["z"])


def test_cli_errors_exit_1(tmp_path, capsys, monkeypatch):
    build_dam_break(tmp_path)
    xml = tmp_path / "dam-break.xml"
    assert torch_main(["-c", str(xml), "--platform", "cpu",
                       "--distributed", "localhost,2"]) == 1
    assert "--distributed 'localhost,2'" in capsys.readouterr().err
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert torch_main(["-c", str(xml), "--platform", "cpu",
                       "--distributed", "env"]) == 1
    assert "RANK expected" in capsys.readouterr().err
    assert distributed.world_size() == 1
    for r, (rc, out) in enumerate(_cli_ranks(xml, "--mesh", "3")):
        assert rc == 1, f"rank {r}:\n{out[-3000:]}"
        assert "Invalid mesh" in out and "3 blocks" in out
