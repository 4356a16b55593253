"""The port's CLI against the analytic dam break and the JAX package's CLI,
on the CPU, and the port's raster codecs against the JAX package's."""

import numpy as np
import pytest
import torch

from chip_smoke import write_glasgow_model
from hipims_tpu.cli import main as jax_main
from hipims_tpu.io import raster as j_raster
from hipims_tpu.tools.model_builder import build_dam_break, build_lake_at_rest
from hipims_tpu_torch.cli import main as torch_main
from hipims_tpu_torch.io import raster as t_raster

torch.set_num_threads(1)


def _depth(path):
    return t_raster.read_raster(path).to_domain_array()


def _dam_break_vs_stoker_and_jax(tmp_path, **kw):
    for pkg in ("jax", "torch"):
        build_dam_break(tmp_path / pkg, **kw)
    assert torch_main(["-c", str(tmp_path / "torch" / "dam-break.xml"), "-q",
                       "--platform", "cpu"]) == 0
    assert jax_main(["-c", str(tmp_path / "jax" / "dam-break.xml"), "-q",
                     "--platform", "cpu"]) == 0
    num = _depth(tmp_path / "torch" / "output" / "depth_40.tif")
    ex = _depth(tmp_path / "torch" / "validation" / "depth_exact_40.asc")
    l1 = np.abs(np.where(num == -9999, 0, num)[3:5, 2:-2]
                - ex[3:5, 2:-2]).mean()
    assert l1 < 0.05
    for t in (10, 20, 30, 40):
        got = _depth(tmp_path / "torch" / "output" / f"depth_{t}.tif")
        want = _depth(tmp_path / "jax" / "output" / f"depth_{t}.tif")
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_dam_break_matches_stoker_and_jax(tmp_path):
    """The reference's verify case: L1 against the Stoker solution (the
    JAX run gives ~0.009), and depth rasters equal to the JAX CLI's."""
    _dam_break_vs_stoker_and_jax(tmp_path)


def test_muscl_dam_break_matches_stoker_and_jax(tmp_path):
    """The same dam break with <scheme name="muscl-hancock">: the 2-cell
    wall ring of the strip is the scheme's static ring."""
    _dam_break_vs_stoker_and_jax(tmp_path, scheme="muscl-hancock")


def test_muscl_lake_at_rest_stays_at_rest(tmp_path):
    """Well-balancedness (MUSCL is build_lake_at_rest's default): a
    still surface over emerging bumps stays still; depth equals the
    validation raster (the initial depth) and the velocities stay ~0."""
    build_lake_at_rest(tmp_path, n=32, duration=20.0)
    assert torch_main(["-c", str(tmp_path / "lake-at-rest.xml"), "-q",
                       "--platform", "cpu"]) == 0
    for t in (5, 10, 15, 20):
        got = _depth(tmp_path / "output" / f"depth_{t}.tif")
        want = _depth(tmp_path / "validation" / f"depth_exact_{t}.asc")
        wet = want > 0
        np.testing.assert_allclose(got[wet], want[wet], rtol=0, atol=1e-5)
        for vel in ("velX", "velY"):
            v = _depth(tmp_path / "output" / f"{vel}_{t}.tif")
            assert np.abs(np.where(v == -9999, 0, v)).max() < 1e-4


def test_glasgow_class_volume_matches_jax(tmp_path):
    """Rain + loss over undulating terrain (tools/bench_e2e.py's Glasgow
    class) shrunk to 32x48 and 120 s: the same water volume as JAX.

    Run in float64: in single precision the ~1 mm rain films make the CFL
    speed (q / h) and hence dt differ by O(1e-3) between any two f32
    implementations after the early-limit phase, which moves the
    hydrological gate; the f32c CLI path is held to JAX by the dam-break
    rasters above."""
    vols = {}
    for pkg, main in (("jax", jax_main), ("torch", torch_main)):
        xml = write_glasgow_model(tmp_path / pkg, 32, 48, 120.0, 60.0)
        assert main(["-c", str(xml), "-q", "--platform", "cpu",
                     "--precision", "double"]) == 0
        depth = _depth(tmp_path / pkg / "output" / "depth_120.tif")
        vols[pkg] = float(np.where(depth > 0, depth, 0.0).sum()) * 4.0
    assert vols["torch"] > 0.0
    assert vols["torch"] == pytest.approx(vols["jax"], rel=1e-6)


@pytest.mark.parametrize("argv", [["--mesh", "2"], ["--distributed", "env"],
                                  ["--checkpoint", "c.npz"],
                                  ["--resume", "c.npz"],
                                  ["--io-mode", "stream"]])
def test_unported_flags_exit_1(tmp_path, argv, capsys):
    build_dam_break(tmp_path)
    rc = torch_main(["-c", str(tmp_path / "dam-break.xml"), "--platform",
                     "cpu"] + argv)
    assert rc == 1
    assert "not yet ported" in capsys.readouterr().err


def test_gpu_platform_without_cuda_fails_cleanly(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    build_dam_break(tmp_path)
    assert torch_main(["-c", str(tmp_path / "dam-break.xml")]) == 1
    assert "CUDA is not available" in capsys.readouterr().err


@pytest.mark.parametrize("fmt", ["asc", "tif"])
def test_raster_write_byte_equal(tmp_path, fmt):
    rng = np.random.default_rng(0)
    data = rng.uniform(-5, 50, (13, 21))
    data[2, 3] = -9999.0
    rast = dict(data=data, xll=1000.5, yll=-20.0, cell_size=2.5,
                nodata=-9999.0)
    j_raster.write_raster(tmp_path / f"j.{fmt}", j_raster.Raster(**rast))
    t_raster.write_raster(tmp_path / f"t.{fmt}", t_raster.Raster(**rast))
    assert (tmp_path / f"t.{fmt}").read_bytes() == \
        (tmp_path / f"j.{fmt}").read_bytes()
    back = t_raster.read_raster(tmp_path / f"j.{fmt}")
    want = j_raster.read_raster(tmp_path / f"j.{fmt}")
    np.testing.assert_array_equal(back.data, want.data)
    assert (back.xll, back.yll, back.cell_size, back.nodata) == \
        (want.xll, want.yll, want.cell_size, want.nodata)
