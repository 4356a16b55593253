"""Checkpoint / resume in the port, on the CPU:

* the port resumes exactly: same t, and a state ``torch.equal`` to the run
  that paused at the same time (an output sync point changes the dt
  sequence, so the baseline pauses there too);
* a JAX checkpoint resumes in the port, and a port checkpoint in JAX,
  within 1e-12 in float64 (one file format, CHECKPOINT_VERSION 1);
* a mismatched grid (a JAX grid padded for its kernels too), scheme or
  datum raises;
* the CLI's ``--checkpoint`` / ``--resume``, as tests/test_io.py has it
  for the JAX CLI.
"""

import json

import numpy as np
import pytest
import torch

from hipims_tpu.domain import Domain as JDomain
from hipims_tpu.runtime import Simulation as JSimulation
from hipims_tpu.runtime import SimulationConfig as JConfig
from hipims_tpu.runtime import checkpoint as jck
from hipims_tpu_torch.cli import main
from hipims_tpu_torch.domain import Domain
from hipims_tpu_torch.io.raster import Raster, read_raster, write_raster
from hipims_tpu_torch.ops.boundaries import UniformBoundary
from hipims_tpu_torch.runtime import Simulation, SimulationConfig
from hipims_tpu_torch.runtime import checkpoint as ck

torch.set_num_threads(1)


def _domain(cls, n=40, seed=3):
    """A bumpy basin at a ~50 m datum with a raised pool of water."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n]
    zb = 50.0 + 0.3 * np.sin(yy / 4.0) * np.cos(xx / 5.0) \
        + rng.uniform(0.0, 0.02, (n, n))
    d = cls(zb=zb, manning=0.03, dx=2.0, dy=2.0)
    d.set_initial_depth(np.where(np.hypot(yy - n / 2, xx - n / 3) < n / 6,
                                 1.5, 0.2))
    return d


def _cfg(cls, duration=4.0, **kw):
    return cls(scheme=kw.pop("scheme", "godunov"), duration=duration,
               output_frequency=duration, batch_size=8, batch_auto=False,
               **kw)


def _rain():
    return (UniformBoundary(values=np.full(4, 50.0), interval=60.0,
                            length=240.0, is_loss=False),)


@pytest.mark.parametrize("dtype", ["float64", "float32c"])
def test_port_resumes_exactly(tmp_path, dtype):
    a = Simulation(_domain(Domain), _cfg(SimulationConfig, dtype=dtype),
                   boundaries=_rain(), device="cpu")
    a.run_to(2.0)
    ck.save_checkpoint(tmp_path / "ck.npz", a)
    a.run_to(4.0)

    b = Simulation(_domain(Domain), _cfg(SimulationConfig, dtype=dtype),
                   boundaries=_rain(), device="cpu")
    ck.load_checkpoint(tmp_path / "ck.npz", b)
    assert b.t == pytest.approx(2.0, abs=1e-5)
    assert b.total_steps > 0
    b.run_to(4.0)
    assert b.t == a.t and b.total_steps == a.total_steps
    for x, y in zip(a.state, b.state):
        assert torch.equal(x, y)
    if dtype == "float32c":
        assert torch.equal(a.comp, b.comp) and a.comp.abs().max() > 0
    for x, y in zip(a.carry, b.carry):
        assert torch.equal(x, y)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_cross_packages(tmp_path, writer):
    """Written by one package at t=2, resumed by the other to t=4: the
    same state as the writer's own run to 4, within 1e-12 in float64."""
    j = JSimulation(_domain(JDomain), _cfg(JConfig))
    p = Simulation(_domain(Domain), _cfg(SimulationConfig), device="cpu")
    src, dst = (j, p) if writer == "jax" else (p, j)
    src.run_to(2.0)
    (jck if writer == "jax" else ck).save_checkpoint(tmp_path / "c.npz", src)
    src.run_to(4.0)
    (ck if writer == "jax" else jck).load_checkpoint(tmp_path / "c.npz", dst)
    assert float(dst.t) == pytest.approx(2.0, abs=1e-9)
    dst.run_to(4.0)
    assert dst.t == pytest.approx(src.t, abs=1e-12)
    for name, x, y in zip(("z", "zmax", "qx", "qy"), j.state, p.state):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-12,
                                   atol=1e-12, err_msg=name)
    with np.load(tmp_path / "c.npz") as data:
        assert json.loads(str(data["meta"]))["version"] == 1
        assert set(data.files) == {"meta", "z", "zmax", "qx", "qy", "t",
                                   "dt", "t_hydro", "batch_dt_total",
                                   "batch_successful", "batch_skipped"}


def test_mismatches_raise(tmp_path):
    base = Simulation(_domain(Domain, n=32), _cfg(SimulationConfig),
                      device="cpu")
    ck.save_checkpoint(tmp_path / "ck.npz", base)
    for sim, match in (
            (Simulation(_domain(Domain, n=40), _cfg(SimulationConfig),
                        device="cpu"), "grid"),
            (Simulation(_domain(Domain, n=32),
                        _cfg(SimulationConfig, scheme="inertial"),
                        device="cpu"), "scheme"),
            (Simulation(_domain(Domain, n=32),
                        _cfg(SimulationConfig, dtype="float32c"),
                        device="cpu"), "datum")):
        with pytest.raises(ValueError, match=match):
            ck.load_checkpoint(tmp_path / "ck.npz", sim)


def test_padded_jax_checkpoint_raises_grid(tmp_path):
    """JAX pads a grid for its Pallas kernels (Domain.pad_for_tiles); the
    port never pads, so such a checkpoint is refused, not cropped."""
    j = JSimulation(_domain(JDomain, n=20),
                    _cfg(JConfig, dtype="float32", kernel_backend="pallas"))
    assert (j.domain.rows, j.domain.cols) != (20, 20)
    jck.save_checkpoint(tmp_path / "ck.npz", j)
    p = Simulation(_domain(Domain, n=20), _cfg(SimulationConfig,
                                               dtype="float32"),
                   device="cpu")
    with pytest.raises(ValueError, match="grid"):
        ck.load_checkpoint(tmp_path / "ck.npz", p)


XML = """<?xml version="1.0"?>
<configuration>
  <metadata><name>CK</name></metadata>
  <simulation>
    <parameter name="duration" value="{dur}" />
    <parameter name="outputFrequency" value="5" />
    <domainSet><domain type="cartesian">
      <data sourceDir="." targetDir="{out}/">
        <dataSource type="constant" value="depth" source="0.1" />
        <dataSource type="constant" value="manningCoefficient"
                    source="0.03" />
        <dataSource type="raster" value="structure,dem" source="dem.asc" />
        <dataTarget type="raster" value="depth" format="GTiff"
                    target="depth_%t.tif" />
      </data>
      <scheme name="Godunov" />
    </domain></domainSet>
  </simulation>
</configuration>"""


def test_cli_checkpoint_resume(tmp_path, capsys):
    """--checkpoint writes a resumable checkpoint at every output time;
    --resume continues from it, skipping the outputs already written, and
    the resumed end state equals an uninterrupted run's exactly."""
    yy, xx = np.mgrid[0:16, 0:16]
    write_raster(tmp_path / "dem.asc", Raster(
        data=0.05 * np.sin(yy / 3.0) + 0.01 * xx, cell_size=2.0))
    for name, dur, out in (("full", 10, "out_full"), ("half", 5, "out_half"),
                           ("rest", 10, "out_rest")):
        (tmp_path / f"{name}.xml").write_text(XML.format(dur=dur, out=out))
    cli = ["-n", "--platform", "cpu"]
    assert main(["-c", str(tmp_path / "full.xml"), *cli]) == 0
    ckpt = tmp_path / "run.npz"
    assert main(["-c", str(tmp_path / "half.xml"), *cli,
                 "--checkpoint", str(ckpt)]) == 0
    assert ckpt.exists()
    assert main(["-c", str(tmp_path / "rest.xml"), *cli,
                 "--resume", str(ckpt)]) == 0
    assert "Resumed:     t=5.0 s" in capsys.readouterr().out
    rest = sorted(p.name for p in (tmp_path / "out_rest").glob("*.tif"))
    assert rest == ["depth_10.tif"]
    a = read_raster(tmp_path / "out_full" / "depth_10.tif").data
    b = read_raster(tmp_path / "out_rest" / "depth_10.tif").data
    np.testing.assert_array_equal(a, b)
    assert main(["-c", str(tmp_path / "rest.xml"), *cli,
                 "--resume", str(tmp_path / "missing.npz")]) == 1
