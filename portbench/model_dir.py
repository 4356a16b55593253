"""Writes one cell's HiPIMS model directory from its configuration, its
traffic and a seed: the XML, the DEM (and the initial depth, where the
traffic starts from the terrain's water) as uncompressed float32 GeoTIFFs,
and one CSV per boundary time series.

The XML is chip_smoke.py's ``XML`` (a07496d) with the initial-depth
source and the output targets filled in from the traffic.  Terrains are
modules ``terrain/<kind>.py`` found by the configuration's
``terrain.kind``, so a later configuration adds a terrain by adding a
file.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np

from . import geotiff

HERE = Path(__file__).resolve().parent

XML = """<?xml version="1.0"?>
<configuration>
  <metadata><name>{name}</name>
    <description>{desc}</description>
  </metadata>
  <simulation>
    <parameter name="duration" value="{duration!r}" />
    <parameter name="outputFrequency" value="{duration!r}" />
    <parameter name="floatingPointPrecision" value="{precision}" />
    <domainSet>
      <domain type="cartesian">
        <data sourceDir="topography/" targetDir="output/">
          <dataSource type="raster" value="structure,dem" source="dem.tif" />
          <dataSource type="constant" value="manningCoefficient"
                      source="{manning!r}" />{sources}{targets}
        </data>
        <scheme name="{scheme}">
          <parameter name="courantNumber" value="{courant!r}" />
          <parameter name="frictionEffects" value="yes" />
        </scheme>
        <boundaryConditions sourceDir="boundaries/">{edges}{boundaries}
        </boundaryConditions>
      </domain>
    </domainSet>
  </simulation>
</configuration>
"""

SCHEME_XML = {"godunov": "godunov", "muscl-hancock": "musclhancock"}
BOUNDARY_VALUE = {"rain": "rain-intensity", "loss": "loss-rate"}


def load_module(path: Path, name: str):
    """Import the Python file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def terrain(config, seed):
    """(bed, initial depth or None) of ``config`` for ``seed``, in domain
    orientation (row 0 south)."""
    kind = config["terrain"]["kind"]
    module = load_module(HERE / "terrain" / f"{kind}.py",
                         f"portbench_terrain_{kind}")
    rng = np.random.default_rng(seed)
    return module.build(config["rows"], config["cols"], config["cell_size_m"],
                        config["terrain"], rng)


def write(root, config, traffic, seed, precision=None):
    """Write the model directory under ``root`` and return its XML path.
    ``precision`` overrides the configuration's floatingPointPrecision
    (the control runs "single")."""
    root = Path(root)
    (root / "topography").mkdir(parents=True, exist_ok=True)
    (root / "boundaries").mkdir(parents=True, exist_ok=True)
    dx = config["cell_size_m"]
    bed, depth = terrain(config, seed)
    geotiff.write(root / "topography" / "dem.tif", bed[::-1], dx)
    sources = ""
    if traffic["initial"] == "terrain":
        if depth is None:
            raise ValueError(f"terrain {config['terrain']['kind']} holds no "
                             "water for an initial='terrain' traffic")
        geotiff.write(root / "topography" / "depth.tif", depth[::-1], dx)
        sources = ('\n          <dataSource type="raster" value="depth" '
                   'source="depth.tif" />')
    targets = "".join(
        f'\n          <dataTarget type="raster" value="{v}" format="GTiff" '
        f'target="{v}_%t.tif" />' for v in traffic["outputs"])
    edges = "".join(
        f'\n          <domainEdge edge="{e}" treatment="{config["edges"]}" />'
        for e in ("north", "south", "east", "west"))
    boundaries = ""
    for k, b in enumerate(traffic["boundaries"]):
        name = f"{b['kind']}{k}.csv"
        rows = "\n".join(f"{t!r},{r!r}" for t, r in b["series"])
        (root / "boundaries" / name).write_text(f"Time,Rate\n{rows}\n")
        boundaries += (
            f'\n          <timeseries type="atmospheric" name="{b["kind"]}{k}" '
            f'value="{BOUNDARY_VALUE[b["kind"]]}" source="{name}" />')
    xml = root / "model.xml"
    xml.write_text(XML.format(
        name=config["name"], desc=traffic["description"],
        duration=float(traffic["segment_s"]),
        precision=precision or config["floatingPointPrecision"],
        manning=float(config["manning"]), sources=sources, targets=targets,
        scheme=SCHEME_XML[config["scheme"]], courant=float(config["courant"]),
        edges=edges, boundaries=boundaries))
    return xml
