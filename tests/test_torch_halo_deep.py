"""The port's mesh runs against its own one-device runs, on the CPU.

``Simulation(..., mesh=make_mesh(8, devices=[cpu] * 8))`` splits the grid
into halo-extended blocks stepped in halo-deep windows
(``parallel/halo_deep.py``).  With owned-cell CFL maxima, the global max
of the blocks' maxima is the one-device max exactly, and no cell's
arithmetic depends on its block, so a lock-step mesh run equals the
one-device run bit for bit (``torch.equal``), in every scheme and
precision, with every kind of boundary, on even and uneven splits; a
window-mode run (frozen speed, one max per window) equals itself across
mesh sizes.  The end-to-end cases run the CLI with ``--mesh`` and
``--mesh-shape``.  tests/test_torch_mesh.py holds the mesh runs against
the JAX package's.
"""

import numpy as np
import pytest
import torch

from chip_smoke import write_radar_model
from hipims_tpu_torch.cli import main as torch_main
from hipims_tpu_torch.domain import Domain
from hipims_tpu_torch.io.raster import read_raster
from hipims_tpu_torch.io.xml_config import load_config
from hipims_tpu_torch.ops import boundaries as B
from hipims_tpu_torch.ops.kernels.stencil import stencil_step
from hipims_tpu_torch.parallel import make_mesh
from hipims_tpu_torch.runtime import Simulation, SimulationConfig, simulation
from hipims_tpu_torch.runtime.checkpoint import load_checkpoint
from hipims_tpu_torch.tools.model_builder import build_dam_break

torch.set_num_threads(1)
CPU = torch.device("cpu")
SCHEMES = [("godunov", None), ("muscl-hancock", "split12"),
           ("muscl-hancock", "recompute"), ("inertial", None)]


def mesh(n, shape=None):
    return make_mesh(n, shape=shape, devices=[CPU] * n)


def dam(n=64, rows=None, h_in=2.5, h_out=0.5, manning=0.0):
    """The JAX tests' circular dam (tests/test_simulation.py), on a rows x
    n grid."""
    rows = rows or n
    dom = Domain(zb=np.zeros((rows, n)), manning=manning, dx=2.0, dy=2.0)
    yy, xx = np.mgrid[0:rows, 0:n]
    r = np.hypot((yy - rows / 2.0) * 2.0, (xx - n / 2.0) * 2.0)
    dom.set_initial_depth(np.where(r <= n * 2.0 / 8.0, h_in, h_out))
    return dom


def flat(n=48):
    dom = Domain(zb=np.zeros((n, n)), manning=0.03, dx=2.0, dy=2.0)
    dom.set_initial_depth(0.0)
    return dom


def rain(mm_h=50.0):
    return B.UniformBoundary(values=np.full(10, mm_h), interval=600.0,
                             length=6000.0, is_loss=False)


def ne_quadrant_rain(n):
    """A 2x2 radar grid with rain in the NE quadrant only: local-coordinate
    georeferencing on a block would move or lose it."""
    series = np.zeros((10, 2, 2))
    series[:, 1, 1] = 50.0
    return B.GriddedBoundary(series=series, interval=600.0,
                             resolution=n * 2.0 / 2.0, offset_x=0.0,
                             offset_y=0.0, mass_flux=False)


def inflow_cells(n):
    """A line of fixed-depth source cells crossing every block row."""
    rows = np.arange(4, n - 4)
    return B.CellBoundary(rows=rows, cols=np.full_like(rows, n // 2),
                          series=np.array([[0.0, 1.0, 0.0, 0.0],
                                           [600.0, 1.0, 0.0, 0.0]]),
                          interval=600.0, length=1200.0,
                          depth_mode=B.DEPTH_IS_DEPTH,
                          discharge_mode=B.DISCHARGE_IGNORE)


def run(domain, m=None, boundaries=(), duration=3.0, **cfg):
    cfg = SimulationConfig(**{**dict(duration=duration,
                                     output_frequency=duration,
                                     batch_size=8, batch_auto=False), **cfg})
    sim = Simulation(domain, cfg, boundaries=boundaries,
                     device=None if m else CPU, mesh=m)
    sim.run()
    return sim


def assert_equal_runs(a, b):
    assert a.t == b.t and a.total_steps == b.total_steps
    for x, y, name in zip(a.state, b.state, ("z", "zmax", "qx", "qy")):
        assert torch.equal(x, y), name
    if a.comp is not None:
        assert torch.equal(a.comp, b.comp)


@pytest.mark.parametrize("dtype", ["float64", "float32", "float32c"])
@pytest.mark.parametrize("scheme,variant", SCHEMES)
def test_lock_step_mesh_equals_one_device(scheme, variant, dtype):
    kw = dict(scheme=scheme, muscl_variant=variant, dtype=dtype,
              friction=True)
    one = run(dam(manning=0.03), **kw)
    eight = run(dam(manning=0.03), mesh(8), **kw)
    assert eight.window == 1
    assert_equal_runs(one, eight)
    if dtype == "float32c":
        # The comp plane rides the exchange: it is live, and equal.
        assert bool((eight.comp != 0).any())


@pytest.mark.parametrize("sync,window", [("timestep", 1), ("forecast", 4)])
@pytest.mark.parametrize("what", ["uniform", "gridded", "cell"])
def test_mesh_with_boundaries_equals_one_device(what, sync, window):
    n = 48
    bdy = {"uniform": rain(), "gridded": ne_quadrant_rain(n),
           "cell": inflow_cells(n)}[what]
    kw = dict(scheme="godunov", sync_method=sync, forecast_window=window,
              forecast_dt="step", duration=10.0 if what == "cell" else 20.0)
    one = run(flat(n), boundaries=(bdy,), **kw)
    eight = run(flat(n), mesh(8), boundaries=(bdy,), **kw)
    assert eight.window == window
    assert one.volume() > 0.0
    assert_equal_runs(one, eight)
    if what == "gridded":
        d = eight.depth()
        assert d[n // 2:, n // 2:].sum() > 0.98 * d.sum() > 0.0


def test_muscl_rain_forecast_equals_one_device():
    """Radius 2: the mesh forces exactly the one-device cell set (the
    logical grid minus the two-cell ring) in every window."""
    kw = dict(scheme="muscl-hancock", duration=20.0)
    one = run(flat(), boundaries=(rain(),), **kw)
    for sync, window in (("timestep", 1), ("forecast", 4)):
        m = run(flat(), mesh(8), boundaries=(rain(),), sync_method=sync,
                forecast_window=window, forecast_dt="step", **kw)
        assert m.window == window
        assert_equal_runs(one, m)


@pytest.mark.parametrize("scheme,variant", SCHEMES)
def test_window_mode_equals_across_mesh_sizes(scheme, variant):
    """Frozen speed, one max per window: the dt schedule is global, so
    one block and eight give the same bits."""
    kw = dict(scheme=scheme, muscl_variant=variant, sync_method="forecast",
              forecast_window=4, forecast_dt="window", batch_size=4)
    one = run(dam(h_in=25.0, h_out=5.0, manning=0.02), mesh(1), **kw)
    eight = run(dam(h_in=25.0, h_out=5.0, manning=0.02), mesh(8), **kw)
    assert one.window == eight.window == 4
    assert_equal_runs(one, eight)
    assert one.window_reruns == eight.window_reruns


@pytest.mark.parametrize("sync", ["timestep", "forecast"])
def test_uneven_split_equals_one_device(sync):
    """61 x 67 on a (2, 4) mesh: blocks of 31 or 30 rows and 17 or 16
    columns.  The result does not depend on the split."""
    kw = dict(scheme="godunov", sync_method=sync, forecast_window=3,
              forecast_dt="step")
    one = run(dam(67, rows=61))
    uneven = run(dam(67, rows=61), mesh(8, (2, 4)), **kw)
    assert uneven.window == (3 if sync == "forecast" else 1)
    assert_equal_runs(one, uneven)


def test_window_shrinks_to_fit_the_blocks():
    """A window's pads shrink to the smallest block: a (4, 2) mesh of 16 x
    32 blocks takes MUSCL's forecast window 8 (pads 17) down to 7 (15)."""
    cfg = SimulationConfig(scheme="muscl-hancock", sync_method="forecast",
                           forecast_window=8)
    sim = Simulation(dam(), cfg, mesh=mesh(8, (4, 2)))
    assert sim.window == 7


@pytest.mark.parametrize("sync,window", [("timestep", 1), ("forecast", 4)])
@pytest.mark.parametrize("scheme", ["godunov", "muscl-hancock", "inertial"])
def test_the_mesh_steps_through_the_simulations_step(monkeypatch, scheme,
                                                     sync, window):
    """Every step of every block goes through the simulation's own names
    of the scheme kernels (``Simulation._step``), each with its block's
    owned window, and the counted run equals the plain one bit for
    bit."""
    kw = dict(scheme=scheme, sync_method=sync, forecast_window=window)
    plain = run(dam(), mesh(4, (2, 2)), **kw)
    windows = []
    for name in ("stencil_step", "muscl_step_split"):
        def step(*args, _fn=getattr(simulation, name), **kwargs):
            windows.append(kwargs["speed_window"])
            return _fn(*args, **kwargs)

        monkeypatch.setattr(simulation, name, step)
    sim = run(dam(), mesh(4, (2, 2)), **kw)
    assert sim.window == window and sim.windows > 0
    assert len(windows) == sim.windows * sim.window * 4
    assert set(windows) == {b.speed_window for b in sim._blocks.layout}
    assert_equal_runs(plain, sim)


def test_planted_step_fault_reaches_the_mesh(monkeypatch):
    """A first-order step put in place of the simulation's MUSCL kernels,
    as the benchmark plants its fault, changes a MUSCL mesh run."""
    plain = run(dam(), mesh(4, (2, 2)), scheme="muscl-hancock")

    def first_order(state, static, dt, params, variant=None, comp=None,
                    **options):
        return stencil_step("godunov", state, static, dt, params, comp=comp,
                            **options)

    monkeypatch.setattr(simulation, "muscl_step_split", first_order)
    faulty = run(dam(), mesh(4, (2, 2)), scheme="muscl-hancock")
    assert faulty.total_steps > 0
    assert not torch.equal(plain.state.z, faulty.state.z)


def test_resume_across_mesh_and_one_device(tmp_path):
    """A checkpoint written by a mesh run resumes on one device, and one
    written on one device resumes on a mesh, bit-equal to an
    uninterrupted run."""
    kw = dict(scheme="godunov", dtype="float32c", duration=4.0,
              output_frequency=2.0)
    whole = run(dam(manning=0.03), boundaries=(rain(360.0),), **kw)
    for first, second in ((mesh(4), None), (None, mesh(4))):
        cfg = SimulationConfig(**{**dict(batch_size=8, batch_auto=False),
                                  **kw})
        a = Simulation(dam(manning=0.03), cfg, boundaries=(rain(360.0),),
                       device=None if first else CPU, mesh=first)
        a.checkpoint_path = tmp_path / "ck.npz"
        a.run_to(2.0)
        a.emit_output(2.0)
        b = Simulation(dam(manning=0.03), cfg, boundaries=(rain(360.0),),
                       device=None if second else CPU, mesh=second)
        load_checkpoint(tmp_path / "ck.npz", b)
        assert b.t == a.t
        b.run()
        assert_equal_runs(whole, b)


def test_mesh_device_must_be_the_first_block_device():
    with pytest.raises(ValueError, match="first device"):
        Simulation(dam(), SimulationConfig(), device="meta", mesh=mesh(2))


# ---------------------------------------------------------------------------
# End to end through the CLI.
# ---------------------------------------------------------------------------

def _rasters(root):
    return {p.name: read_raster(p).data
            for p in sorted((root / "output").glob("*.tif"))}


def test_cli_mesh_shape_rasters_equal_one_device(tmp_path, capsys):
    for run_dir in ("one", "mesh"):
        build_dam_break(tmp_path / run_dir)
    assert torch_main(["-c", str(tmp_path / "one" / "dam-break.xml"), "-q",
                       "--platform", "cpu"]) == 0
    assert torch_main(["-c", str(tmp_path / "mesh" / "dam-break.xml"), "-n",
                       "--platform", "cpu", "--mesh-shape", "2x2"]) == 0
    out = capsys.readouterr().out
    assert "Mesh:        (2, 2) (4 blocks)" in out
    assert "block rows" in out and "(1,1)" in out
    # The dam break's <domainSet> takes the reference's default sync
    # method, "forecast": its window of 8 shrinks to the 4-row blocks'
    # 3 steps.  Its dt sits at the 0.1 s early limit, so the frozen-speed
    # windows take the one-device dts.
    assert "Window:      3 step(s)" in out
    one, shd = _rasters(tmp_path / "one"), _rasters(tmp_path / "mesh")
    assert sorted(one) == sorted(shd) and len(one) == 16
    for name in one:
        assert np.array_equal(one[name], shd[name]), name


def test_cli_mesh_checkpoint_resumes_without_mesh(tmp_path):
    """A mesh run (2 blocks) with a checkpoint to half way, then the CLI's
    --resume from it on one device: the end equals an uninterrupted
    one-device run's bit for bit."""
    for run_dir in ("whole", "a", "b"):
        build_dam_break(tmp_path / run_dir, duration=20.0)
    assert torch_main(["-c", str(tmp_path / "whole" / "dam-break.xml"),
                       "-q", "--platform", "cpu"]) == 0
    ck = tmp_path / "c.npz"
    model = load_config(str(tmp_path / "a" / "dam-break.xml"))
    model.config.duration = 10.0
    sim = model.simulation(mesh=mesh(2))
    sim.checkpoint_path = ck
    sim.run()
    assert torch_main(["-c", str(tmp_path / "b" / "dam-break.xml"), "-q",
                       "--platform", "cpu", "--resume", str(ck)]) == 0
    assert not (tmp_path / "b" / "output" / "depth_10.tif").exists()
    for t in (15, 20):
        got, want = (read_raster(tmp_path / d / "output" / f"depth_{t}.tif")
                     .data for d in ("b", "whole"))
        assert np.array_equal(got, want)


def test_cli_decomposed_model_takes_its_window_from_the_overlap(tmp_path,
                                                                capsys):
    """The radar model directory (two <domain> row bands overlapping by 4
    rows a side, syncMethod="forecast") under --mesh-shape 2x1: the
    window comes from the overlap, (8 // 2 - 1) // 1 = 3 steps, and the
    run holds the mass balance of the frames' rain minus the loss."""
    xml = write_radar_model(tmp_path, 96, 128, 40.0, 40.0, interval=20.0,
                            rain_cell=50.0)
    assert load_config(xml).config.forecast_window == 3
    assert torch_main(["-c", str(xml), "-n", "--platform", "cpu",
                       "--mesh-shape", "2x1", "--mass-balance"]) == 0
    out = capsys.readouterr().out
    assert "Window:      3 step(s)" in out
    assert "Mass balance" in out
