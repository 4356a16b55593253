"""Multi-``<domain>`` (decomposed) configs in the port against the JAX
package's loader, on the CPU: the stitched Domain (zb, manning, active,
initial state, edges), the merged boundaries and targets and every config
field are equal to ``hipims_tpu.io.xml_config.load_config``'s, for 2- and
3-band ``--decompose`` models with overlap, for hand-made bands with
NODATA holes, and the decomposed model runs exactly as the whole one."""

import dataclasses

import numpy as np
import pytest
import torch

from hipims_tpu.io.xml_config import load_config as j_load_config
from hipims_tpu_torch.io.raster import Raster, write_raster
from hipims_tpu_torch.io.xml_config import load_config
from hipims_tpu_torch.tools.model_builder import build_pluvial
from hipims_tpu_torch.tools.model_builder import main as mb_main

torch.set_num_threads(1)


def _assert_same_model(got, want):
    gd, wd = got.domain, want.domain
    for name in ("zb", "manning", "active", "_depth", "_fsl", "_qx", "_qy"):
        g, w = getattr(gd, name), getattr(wd, name)
        assert (g is None) == (w is None), name
        if g is not None:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=name)
    for name in ("dx", "dy", "xll", "yll", "edge_treatment"):
        assert getattr(gd, name) == getattr(wd, name), name
    # The port's config is the JAX package's less its kernel backend.
    want_config = dataclasses.asdict(want.config)
    del want_config["kernel_backend"]
    assert dataclasses.asdict(got.config) == want_config
    assert got.output_targets == want.output_targets
    assert got.target_dir == want.target_dir
    assert [type(b).__name__ for b in got.boundaries] == \
        [type(b).__name__ for b in want.boundaries]
    for g, w in zip(got.boundaries, want.boundaries):
        for f in dataclasses.fields(w):
            np.testing.assert_array_equal(np.asarray(getattr(g, f.name)),
                                          np.asarray(getattr(w, f.name)),
                                          err_msg=f.name)


@pytest.mark.parametrize("parts,overlap,sync", [
    (None, 0, None), (2, 6, None), (3, 4, "forecast"), (3, 7, "timestep")])
def test_decomposed_pluvial_matches_jax(tmp_path, parts, overlap, sync):
    kw = dict(decompose=parts, decompose_overlap=overlap) if parts else {}
    xml = build_pluvial(tmp_path, size=40, duration=600.0,
                        sync_method=sync, **kw)
    got, want = load_config(xml), j_load_config(xml)
    _assert_same_model(got, want)
    assert len(got.boundaries) == 1        # the repeated rain applies once
    if parts:
        assert got.config.sync_method == (sync or "forecast")


def test_decompose_overlap_maps_to_forecast_window(tmp_path):
    """The JAX package's mapping from the decompose overlap and
    syncSpareSize to the forecast window (tests/test_model_builder.py):
    read into the config, acted on by nothing on one device."""
    mb_main(["-t", "lake-at-rest", "-d", str(tmp_path),
             "--decompose", "2", "--decompose-overlap", "12",
             "--sync-method", "forecast"])
    xml = tmp_path / "lake-at-rest.xml"
    model = load_config(xml)
    assert (model.config.sync_method, model.config.forecast_window) == \
        ("forecast", 5)
    xml.write_text(xml.read_text().replace(
        '<domainSet syncMethod="forecast">',
        '<domainSet syncMethod="forecast" syncSpareSize="2">'))
    assert load_config(xml).config.forecast_window == \
        j_load_config(xml).config.forecast_window == 3
    model.simulation(device="cpu").run_to(0.5)


DOMAIN = """<domain type="cartesian" deviceNumber="{i}">
  <data sourceDir="." targetDir="out/">
    <dataSource type="raster" value="structure,dem" source="dem{i}.asc" />
    <dataSource type="raster" value="manningCoefficient" source="n{i}.asc"/>
    <dataSource type="raster" value="depth" source="h{i}.asc" />
    <dataSource type="constant" value="manningCoefficient" source="{n}" />
    <dataTarget type="raster" value="depth" format="GTiff"
                target="depth_%t.tif" />
    <dataTarget type="timeseries" value="depth" source="gauges.csv"
                target="gauge_depth.csv" />
  </data>
  <scheme name="Godunov" />
  <boundaryConditions sourceDir=".">
    <domainEdge edge="north" treatment="{north}" />
    <timeseries type="atmospheric" name="Rain" value="rain-intensity"
                source="rain.csv" />
  </boundaryConditions>
</domain>"""


def test_bands_with_nodata_holes_match_jax(tmp_path):
    """Two overlapping bands whose DEM, Manning and depth rasters have
    NODATA holes (a hole in one band's overlap is filled by the other's
    value, later bands overwrite the overlap), conflicting constants and
    <domainEdge>s: every stitched plane is equal to JAX's, bit for bit."""
    rng = np.random.default_rng(11)
    rows, cols, overlap = 30, 17, 5
    bands = ((0, 15 + overlap), (15 - overlap, rows))
    for i, (lo, hi) in enumerate(bands):
        for name, lo_v, hi_v in (("dem", 1.0, 3.0), ("n", 0.01, 0.06),
                                 ("h", 0.0, 0.4)):
            a = rng.uniform(lo_v, hi_v, (hi - lo, cols))
            a[rng.random(a.shape) < 0.08] = -9999.0
            write_raster(tmp_path / f"{name}{i}.asc",
                         Raster.from_domain_array(a, xll=50.0,
                                                  yll=80.0 + lo * 2.0,
                                                  cell_size=2.0))
    (tmp_path / "rain.csv").write_text("Time,Rate\n0,30\n600,0\n")
    (tmp_path / "gauges.csv").write_text("x,y,name\n57,95,A\n61,121,B\n")
    doms = "\n".join(DOMAIN.format(i=i, n=0.02 + 0.01 * i,
                                   north=("open", "closed")[i])
                     for i in range(2))
    (tmp_path / "m.xml").write_text(f"""<?xml version="1.0"?>
<configuration><metadata><name>Bands</name></metadata>
<simulation>
  <parameter name="duration" value="30" />
  <parameter name="outputFrequency" value="10" />
  <parameter name="floatingPointPrecision" value="double-strict" />
  <domainSet syncMethod="forecast" syncSpareSize="1">{doms}</domainSet>
</simulation></configuration>""")
    got, want = load_config(tmp_path / "m.xml"), j_load_config(tmp_path /
                                                               "m.xml")
    _assert_same_model(got, want)
    zb = got.domain.zb
    assert zb.shape == (rows, cols) and (zb == -9999.0).any()
    assert (~got.domain.active).any()
    assert got.domain.edge_treatment["north"] == "open"
    assert [t["kind"] for t in got.output_targets] == ["raster",
                                                       "timeseries"]


def test_decomposed_run_equals_whole_run(tmp_path):
    """A --decompose 3 pluvial model runs in the port exactly as the
    undecomposed one: the same depth at 30 s, bit for bit."""
    whole = load_config(build_pluvial(tmp_path / "whole", size=36,
                                      duration=600.0))
    parts = load_config(build_pluvial(tmp_path / "parts", size=36,
                                      duration=600.0, decompose=3,
                                      decompose_overlap=5))
    a, b = (m.simulation(device="cpu") for m in (whole, parts))
    a.run_to(30.0)
    b.run_to(30.0)
    assert a.total_steps == b.total_steps > 0
    for x, y in zip(a.state, b.state):
        assert torch.equal(x, y)
    assert b.volume() > 0.0
