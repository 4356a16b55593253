"""The port's CLI against the analytic dam break and the JAX package's CLI,
on the CPU, and the port's raster codecs against the JAX package's."""

import numpy as np
import pytest
import torch

from chip_smoke import write_glasgow_model
from hipims_tpu.cli import main as jax_main
from hipims_tpu.io import raster as j_raster
from hipims_tpu_torch.cli import main as torch_main
from hipims_tpu_torch.io import raster as t_raster
from hipims_tpu_torch.tools.model_builder import (build_dam_break,
                                                build_lake_at_rest)

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


def test_reference_command_line_runs(tmp_path, capsys):
    """The reference's command line, ``-c model.xml -m -x dir -s``, as the
    JAX CLI takes it: -m and -x are accepted and ignored with a note each
    (in the log file: -s keeps the console quiet), and the dam break's
    rasters equal those of the same run without them, and those of the
    JAX CLI on the same line at the dam-break bar."""
    for run in ("plain", "reference", "jax"):
        build_dam_break(tmp_path / run)
    xml = str(tmp_path / "plain" / "dam-break.xml")
    assert torch_main(["-c", xml, "-s", "--platform", "cpu"]) == 0
    xml = str(tmp_path / "reference" / "dam-break.xml")
    log = tmp_path / "reference.log"
    assert torch_main(["-c", xml, "-m", "-x", str(tmp_path), "-s",
                       "-l", str(log), "--platform", "cpu"]) == 0
    assert capsys.readouterr().out == ""
    notes = log.read_text()
    assert "--mpi-mode is a no-op" in notes
    assert "--code-dir ignored" in notes
    assert jax_main(["-c", str(tmp_path / "jax" / "dam-break.xml"), "-m",
                     "-x", str(tmp_path), "-s", "--platform", "cpu"]) == 0
    for t in (10, 20, 30, 40):
        got, want, jax = (_depth(tmp_path / run / "output" / f"depth_{t}.tif")
                          for run in ("reference", "plain", "jax"))
        assert np.array_equal(got, want)
        np.testing.assert_allclose(got, jax, rtol=0, atol=1e-5)


@pytest.mark.parametrize("argv", [["--distributed", "env"]])
def test_unported_flags_exit_1(tmp_path, argv, capsys):
    build_dam_break(tmp_path)
    rc = torch_main(["-c", str(tmp_path / "dam-break.xml"), "--platform",
                     "cpu"] + argv)
    assert rc == 1
    assert "not yet ported" in capsys.readouterr().err


def test_io_mode_stream_equals_gather(tmp_path):
    """--io-mode stream exits 0 and writes every raster (4 targets x 4
    events) byte-equal to --io-mode gather's."""
    out = {}
    for mode in ("gather", "stream"):
        build_dam_break(tmp_path / mode, duration=20.0)
        assert torch_main(["-c", str(tmp_path / mode / "dam-break.xml"),
                           "-q", "--platform", "cpu", "--io-mode",
                           mode]) == 0
        out[mode] = {p.name: p.read_bytes()
                     for p in (tmp_path / mode / "output").iterdir()}
    assert len(out["gather"]) == 16 and out["gather"] == out["stream"]


@pytest.mark.parametrize("argv", [["--mesh", "2"], ["--mesh-shape", "2x1"],
                                  ["--mesh", "2", "--checkpoint", "c.npz"]])
def test_mesh_flags_run(tmp_path, argv):
    """The mesh flags run the model on CPU blocks: rc 0 and rasters equal
    to the one-device run's (and, with --checkpoint, a checkpoint)."""
    for run in ("one", "mesh"):
        build_dam_break(tmp_path / run, n=100, duration=8.0)
    assert torch_main(["-c", str(tmp_path / "one" / "dam-break.xml"), "-q",
                       "--platform", "cpu"]) == 0
    argv = [str(tmp_path / a) if a.endswith(".npz") else a for a in argv]
    assert torch_main(["-c", str(tmp_path / "mesh" / "dam-break.xml"), "-q",
                       "--platform", "cpu"] + argv) == 0
    for t in (2, 4, 6, 8):
        got, want = (_depth(tmp_path / run / "output" / f"depth_{t}.tif")
                     for run in ("mesh", "one"))
        assert np.array_equal(got, want)
    assert (tmp_path / "c.npz").exists() == ("--checkpoint" in argv)


def test_gpu_platform_without_cuda_fails_cleanly(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    build_dam_break(tmp_path)
    assert torch_main(["-c", str(tmp_path / "dam-break.xml")]) == 1
    assert "CUDA is not available" in capsys.readouterr().err


def test_profile_batch_without_cuda_fails_cleanly(tmp_path, capsys):
    """The batch profiler takes only the model (-c) and needs the card."""
    from hipims_tpu_torch.tools import profile_batch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit):
        profile_batch.main(["-c", "m.xml", "--steps", "5"])
    assert profile_batch.main(["-c", str(tmp_path / "m.xml")]) == 2
    assert "CUDA is not available" in capsys.readouterr().err


def test_kernel_ab_without_cuda_fails_cleanly(tmp_path, capsys):
    """The two-tree kernel A/B needs the card."""
    import kernel_ab

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert kernel_ab.main(["--other", str(tmp_path)]) == 2
    assert "CUDA is not available" in capsys.readouterr().err


def test_kernel_ab_counts_sass():
    """Instructions and MUFU per kernel of a cuobjdump -sass listing; the
    encoding lines and headers are not instructions."""
    from kernel_ab import count_sass

    dump = """
\tcode for sm_90a
\t\tFunction : _Z4stepPf
\t.headerflags    @"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                            /* 0x000fe20000000800 */
        /*0010*/                   MUFU.RSQ R3, R2 ;        /* 0x0000000200037308 */
        /*10000*/              @P0 BRA 0x100 ;              /* 0x0000000000000947 */
\t\tFunction : _Z4donev
        /*0000*/                   EXIT ;                   /* 0x000000000000794d */
"""
    assert count_sass(dump) == {"_Z4stepPf": (3, 1), "_Z4donev": (1, 0)}


@pytest.mark.parametrize("fmt", ["asc", "tif", "img"])
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


def test_profile_batch_takes_the_muscl_variant(tmp_path, capsys):
    """profile_batch runs a MUSCL model with either variant on the card;
    without one it stops before loading the model."""
    from hipims_tpu_torch.tools import profile_batch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    xml = write_glasgow_model(tmp_path, 8, 8, 60.0, 30.0,
                              scheme="musclhancock")
    assert profile_batch.main(["-c", str(xml), "--muscl-variant",
                               "recompute"]) == 2
    assert "CUDA is not available" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        profile_batch.main(["-c", str(xml), "--muscl-variant", "fused"])
