"""Writes one cell's HiPIMS model directory from its configuration, its
traffic and a seed: the XML, the DEM (and the initial depth, where the
traffic starts from the terrain's water) as uncompressed float32 GeoTIFFs,
one CSV per uniform boundary time series, and the frames of each gridded
(radar) boundary as ASC grids named by a strftime mask of the real-world
time (``REAL_START`` + t), as the program and the reference code read
them.

The XML is chip_smoke.py's ``XML`` (a07496d) with the initial-depth
source and the output targets filled in from the traffic, and, where a
configuration gives a ``layout``, its sync method on ``<domainSet>``.
Terrains are modules ``terrain/<kind>.py`` found by the configuration's
``terrain.kind``, and rain generators modules ``rain/<generator>.py``
found by a radar boundary's ``generator``, so a later configuration adds
a terrain, and a later traffic a storm, by adding a file.
"""

from __future__ import annotations

import datetime
import importlib.util
import math
from pathlib import Path

import numpy as np

from . import asc, geotiff

HERE = Path(__file__).resolve().parent

XML = """<?xml version="1.0"?>
<configuration>
  <metadata><name>{name}</name>
    <description>{desc}</description>
  </metadata>
  <simulation>
    <parameter name="duration" value="{duration!r}" />
    <parameter name="outputFrequency" value="{duration!r}" />
    <parameter name="floatingPointPrecision" value="{precision}" />{real_start}
    <domainSet{sync}>
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
REAL_START = datetime.datetime(2020, 6, 1, 12, 0, 0)
REAL_START_XML = ('\n    <parameter name="realStart" value="{:%Y-%m-%d %H:%M:%S}"'
                  ' format="%Y-%m-%d %H:%M:%S" />'.format(REAL_START))


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


def radar_frames(config, boundary, segment_s, seed, k):
    """The rain rates (mm/h) of the ``k``-th boundary of a traffic, a
    radar one, for ``seed``: (frames, grid rows, grid cols), row 0 south,
    one frame every ``interval_s`` from 0 through ``segment_s``, on a
    grid of ``resolution_m`` cells that covers the domain."""
    name = boundary["generator"]
    module = load_module(HERE / "rain" / f"{name}.py",
                         f"portbench_rain_{name}")
    res = float(boundary["resolution_m"])
    shape = (math.ceil(config["rows"] * config["cell_size_m"] / res),
             math.ceil(config["cols"] * config["cell_size_m"] / res))
    n_frames = int(segment_s // float(boundary["interval_s"])) + 1
    rng = np.random.default_rng([seed, k + 1])
    return module.build(shape, n_frames, boundary, rng)


def _boundary(root, config, traffic, seed, k, b):
    """Write the files of the ``k``-th boundary ``b`` of ``traffic`` and
    return its XML element."""
    if b["kind"] == "radar":
        interval = float(b["interval_s"])
        mask = f"radar{k}_%Y%m%d_%H%M%S.asc"
        frames = radar_frames(config, b, float(traffic["segment_s"]), seed,
                              k)
        for i, frame in enumerate(frames):
            t = REAL_START + datetime.timedelta(seconds=i * interval)
            asc.write(root / "boundaries" / t.strftime(mask), frame[::-1],
                      float(b["resolution_m"]))
        return (f'\n          <timeseries type="gridded" name="radar{k}" '
                f'value="rain-intensity" mask="{mask}" '
                f'interval="{interval!r}" />')
    name = f"{b['kind']}{k}.csv"
    rows = "\n".join(f"{t!r},{r!r}" for t, r in b["series"])
    (root / "boundaries" / name).write_text(f"Time,Rate\n{rows}\n")
    return (f'\n          <timeseries type="atmospheric" name="{b["kind"]}{k}" '
            f'value="{BOUNDARY_VALUE[b["kind"]]}" source="{name}" />')


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
    boundaries = "".join(_boundary(root, config, traffic, seed, k, b)
                         for k, b in enumerate(traffic["boundaries"]))
    radar = any(b["kind"] == "radar" for b in traffic["boundaries"])
    layout = config.get("layout")
    xml = root / "model.xml"
    xml.write_text(XML.format(
        name=config["name"], desc=traffic["description"],
        duration=float(traffic["segment_s"]),
        precision=precision or config["floatingPointPrecision"],
        real_start=REAL_START_XML if radar else "",
        sync=f' syncMethod="{layout["sync"]}"' if layout else "",
        manning=float(config["manning"]), sources=sources, targets=targets,
        scheme=SCHEME_XML[config["scheme"]], courant=float(config["courant"]),
        edges=edges, boundaries=boundaries))
    return xml
