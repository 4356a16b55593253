"""Model builder: generate ready-to-run model directories.

The reference ships a Node.js CLI (`hipims-mb`, tools/model-builder/
main.js:305-327) that builds pluvial, analytical and laboratory models —
DEM rasters, boundary CSVs and an XML configuration.  This is its Python
equivalent, generating the same artefact set against this framework's
(reference-compatible) schema, including the analytical cases with
validation rasters (tools/model-builder/tests/README.md:33-64) and the
reference's four registered test cases (tools/model-builder/TestCases.js):
lake at rest, sloshing bowl, dam break over an emerging bed, and the
dam-break-against-an-isolated-obstacle laboratory flume.

Like the reference's ``--decompose`` family of flags (main.js:160-196),
``--decompose N`` splits the generated model into N overlapping row-band
sub-domains written as a multi-``<domain>`` configuration (the loader
stitches them back onto one grid).

A copy of hipims_tpu/tools/model_builder.py that needs no JAX: both write
the same bytes for the same arguments (tests/test_torch_tools.py), so a
machine without JAX builds the models the JAX package runs.

Usage:
    python -m hipims_tpu_torch.tools.model_builder --type dam-break \\
        --directory ./models/test [--scheme godunov] [--decompose 2]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..io.raster import Raster, write_raster
from ..utils import time_label
from ..validation.cases import (SloshingBowl, ritter_dry_dam_break,
                                stoker_wet_dam_break)

XML_TEMPLATE = """<?xml version="1.0"?>
<configuration>
\t<metadata>
\t\t<name>{name}</name>
\t\t<description>{description}</description>
\t</metadata>
\t<execution>
\t\t<executor name="TPU" />
\t</execution>
\t<simulation>
\t\t<parameter name="duration" value="{duration}" />
\t\t<parameter name="outputFrequency" value="{output_frequency}" />
\t\t<parameter name="floatingPointPrecision" value="{precision}" />
\t\t<domainSet{sync_attrs}>
{domains}
\t\t</domainSet>
\t</simulation>
</configuration>
"""

DOMAIN_TEMPLATE = """\t\t\t<domain type="cartesian" deviceNumber="{device}">
\t\t\t\t<data sourceDir="topography/" targetDir="output/">
{sources}{targets}
\t\t\t\t</data>
\t\t\t\t<scheme name="{scheme}">
\t\t\t\t\t<parameter name="courantNumber" value="{courant}" />
\t\t\t\t\t<parameter name="frictionEffects" value="{friction}" />
\t\t\t\t</scheme>
\t\t\t\t<boundaryConditions sourceDir="boundaries/">
\t\t\t\t\t<domainEdge edge="north" treatment="closed" />
\t\t\t\t\t<domainEdge edge="south" treatment="closed" />
\t\t\t\t\t<domainEdge edge="east" treatment="closed" />
\t\t\t\t\t<domainEdge edge="west" treatment="closed" />
{timeseries}
\t\t\t\t</boundaryConditions>
\t\t\t</domain>"""

TARGETS = """
\t\t\t\t\t<dataTarget type="raster" value="depth" format="GTiff" target="depth_%t.tif" />
\t\t\t\t\t<dataTarget type="raster" value="velocityX" format="GTiff" target="velX_%t.tif" />
\t\t\t\t\t<dataTarget type="raster" value="velocityY" format="GTiff" target="velY_%t.tif" />
\t\t\t\t\t<dataTarget type="raster" value="maxdepth" format="GTiff" target="maxdepth_%t.tif" />"""


def _source_line(kind, value, source):
    return (f'\t\t\t\t\t<dataSource type="{kind}" value="{value}" '
            f'source="{source}" />')


def _tstr(t):
    """Lossless, filesystem-safe time label (shared with the production
    raster writer so validation filenames match outputs)."""
    return time_label(t)


def _emit(directory, name, description, zb, extras, duration,
          output_frequency, scheme="godunov", resolution=2.0,
          manning=0.03, friction="yes", courant=0.5, rainfall=None,
          depth=None, fsl=None, validation=None, decompose=None,
          decompose_overlap=4, sync_method=None, gauges=None,
          xll=0.0, yll=0.0):
    directory = Path(directory)
    (directory / "topography").mkdir(parents=True, exist_ok=True)
    (directory / "boundaries").mkdir(exist_ok=True)
    (directory / "output").mkdir(exist_ok=True)

    def band_sources(lo, hi, suffix, band_yll):
        """Constant + per-band raster IC source lines for rows [lo, hi) —
        each decomposed <domain> is configured FULLY, as the reference
        does (src/Domain/CDomainManager.cpp:170-241)."""
        out = [_source_line("constant", "manningCoefficient", manning)]
        for nm, vals in (("depth", depth), ("fsl", fsl)):
            if vals is None:
                continue
            if np.isscalar(vals):
                out.append(_source_line("constant", nm, vals))
            else:
                fname = f"{nm}{suffix}.asc"
                write_raster(directory / "topography" / fname,
                             Raster.from_domain_array(
                                 np.asarray(vals)[lo:hi], xll=xll,
                                 cell_size=resolution, yll=band_yll))
                out.append(_source_line("raster", nm, fname))
        return out

    timeseries = []
    if rainfall is not None:
        rows = "\n".join(f"{t},{v}" for t, v in rainfall)
        (directory / "boundaries" / "rainfall.csv").write_text(
            "Time (s),Rainfall intensity (mm/hr)\n" + rows + "\n")
        timeseries.append(
            '\t\t\t\t\t<timeseries type="atmospheric" name="Rainfall" '
            'value="rain-intensity" source="rainfall.csv" />')

    if validation is not None:
        (directory / "validation").mkdir(exist_ok=True)
        for fname, grid in validation.items():
            write_raster(directory / "validation" / fname,
                         Raster.from_domain_array(grid,
                                                  cell_size=resolution))
    if gauges is not None:
        rows = "\n".join(f"{gx},{gy},{gn}" for gx, gy, gn in gauges)
        (directory / "boundaries" / "gauges.csv").write_text(
            "X (m),Y (m),Gauge\n" + rows + "\n")

    # ---- domain blocks (1 or N row-band decomposed) ----------------------
    n_parts = int(decompose) if decompose else 1
    blocks = []
    nrows = zb.shape[0]
    for i in range(n_parts):
        if n_parts == 1:
            lo, hi, dem_name, suffix = 0, nrows, "dem.asc", ""
        else:
            # Overlapping row bands, like the reference's decomposed
            # configs (tools/model-builder main.js:160-196): band i covers
            # rows [lo, hi) of the logical grid plus `decompose_overlap`
            # shared halo rows on each interior seam.
            lo = i * nrows // n_parts
            hi = (i + 1) * nrows // n_parts
            lo = max(0, lo - (decompose_overlap if i > 0 else 0))
            hi = min(nrows, hi + (decompose_overlap
                                  if i < n_parts - 1 else 0))
            suffix = f"_part{i}"
            dem_name = f"dem{suffix}.asc"
        band_yll = yll + lo * resolution
        write_raster(directory / "topography" / dem_name,
                     Raster.from_domain_array(zb[lo:hi], xll=xll,
                                              cell_size=resolution,
                                              yll=band_yll))
        # Every domain carries its own full configuration — band-sliced
        # ICs, the boundary timeseries and the output targets — exactly
        # like a reference decomposed config; the loader deduplicates the
        # repeats when stitching.
        dom_sources = ([_source_line("raster", "structure,dem", dem_name)]
                       + band_sources(lo, hi, suffix, band_yll))
        blocks.append(DOMAIN_TEMPLATE.format(
            device=i + 1, scheme=scheme, courant=courant, friction=friction,
            sources="\n".join(dom_sources),
            targets=TARGETS,
            timeseries="\n".join(timeseries)))

    sync_attrs = ""
    if sync_method:
        sync_attrs = f' syncMethod="{sync_method}"'
    from xml.sax.saxutils import escape
    xml = XML_TEMPLATE.format(
        name=escape(name), description=escape(description),
        duration=duration,
        output_frequency=output_frequency, precision="double",
        sync_attrs=sync_attrs, domains="\n".join(blocks))
    (directory / f"{name}.xml").write_text(xml)
    return directory / f"{name}.xml"


def build_pluvial(directory, name="pluvial", size=500, resolution=2.0,
                  rain_mm_hr=70.0, duration=3600.0, scheme="godunov",
                  terrain_dir=None, extent=None, **kw):
    """Pluvial model: uniform rainfall over a catchment DEM.

    Without ``terrain_dir`` the terrain is synthetic.  With it, the
    reference's real-data workflow runs offline: ``extent`` (BNG metres,
    (x0, y0, x1, y1)) is mapped to 10 km EA LiDAR tile names and the
    pre-fetched tile rasters in ``terrain_dir`` are mosaicked and
    clipped into the model DEM (reference:
    tools/model-builder/DomainBNG.js + BngTile.js, minus the network).
    Cells not covered by any tile are disabled (-9999)."""
    xll = yll = 0.0
    if terrain_dir is not None:
        from .bng import mosaic_extent, tile_names_for_extent
        if extent is None:
            raise ValueError("--extent x0,y0,x1,y1 is required with "
                             "--terrain-dir")
        x0, y0, x1, y1 = extent
        zb, missing = mosaic_extent(terrain_dir, x0, y0, x1, y1,
                                    resolution)
        if missing:
            print(f"  warning: no raster found for tiles {missing} "
                  f"(of {tile_names_for_extent(x0, y0, x1, y1)}); "
                  "their cells are disabled")
        if (zb == -9999.0).all():
            raise ValueError("no tile raster covered the extent at all")
        xll, yll = x0, y0
        description = "EA LiDAR pluvial catchment"
    else:
        n = int(size)
        x = np.linspace(0, 4 * np.pi, n)
        y = np.linspace(0, 4 * np.pi, n)
        zb = (2.0 * np.sin(x)[None, :] * np.cos(y)[:, None]
              + 0.01 * np.arange(n)[:, None] * resolution / 10.0)
        description = "Synthetic pluvial catchment"
    return _emit(directory, name, description, zb,
                 {}, duration, duration / 6, scheme=scheme,
                 resolution=resolution, depth=0.0, xll=xll, yll=yll,
                 rainfall=[(0, rain_mm_hr), (duration / 2, rain_mm_hr),
                           (duration, 0.0)], **kw)


def build_dam_break(directory, name="dam-break", n=400, resolution=2.0,
                    h_up=2.0, h_down=0.2, duration=40.0,
                    scheme="godunov", **kw):
    """1-D dam break strip with Stoker validation rasters at each output
    interval (reference analogue: TestDamBreakEmergingBed with a wet bed;
    pass h_down=0 for the Ritter dry-front variant)."""
    rows = 8
    zb = np.zeros((rows, n))
    zb[:2, :] = 9999.9
    zb[-2:, :] = 9999.9
    x = (np.arange(n) + 0.5) * resolution
    x0 = n * resolution / 2
    depth = np.where(x < x0, h_up, h_down)[None, :].repeat(rows, 0)
    depth[:2] = 0.0
    depth[-2:] = 0.0

    out_freq = duration / 4
    validation = {}
    for k in range(1, 5):
        t = k * out_freq
        if h_down > 0:
            h_ex, _ = stoker_wet_dam_break(h_up, h_down, x, t, x0)
        else:
            h_ex, _ = ritter_dry_dam_break(h_up, x, t, x0)
        validation[f"depth_exact_{_tstr(t)}.asc"] = \
            h_ex[None, :].repeat(rows, 0)

    return _emit(directory, name, "Stoker/Ritter dam break", zb, {},
                 duration, out_freq, scheme=scheme, resolution=resolution,
                 friction="no", depth=depth, validation=validation, **kw)


def build_sloshing_bowl(directory, name="sloshing-bowl", n=200,
                        scheme="muscl-hancock", **kw):
    """Thacker planar sloshing bowl with analytic depth rasters
    (reference analogue: TestSloshingBowl.js)."""
    case = SloshingBowl()
    pad = 1.3
    x = np.linspace(-case.a * pad, case.a * pad, n)
    dxr = x[1] - x[0]
    rows = 8
    zb1 = case.bed(x)
    zb = zb1[None, :].repeat(rows, 0)
    zb[:2, :] = 9999.9
    zb[-2:, :] = 9999.9
    depth = np.maximum(case.surface(x, 0.0) - zb1, 0.0)[None, :].repeat(
        rows, 0)
    depth[:2] = 0.0
    depth[-2:] = 0.0

    duration = case.period
    out_freq = case.period / 4
    validation = {}
    for k in range(1, 5):
        t = k * out_freq
        h_ex = np.maximum(case.surface(x, t) - zb1, 0.0)
        validation[f"depth_exact_{_tstr(t)}.asc"] = \
            h_ex[None, :].repeat(rows, 0)
    return _emit(directory, name, "Thacker sloshing parabolic bowl", zb,
                 {}, duration, out_freq, scheme=scheme, resolution=dxr,
                 friction="no", depth=depth, validation=validation, **kw)


def build_lake_at_rest(directory, name="lake-at-rest", n=128,
                       resolution=2.0, fsl=1.0, duration=600.0,
                       scheme="muscl-hancock", **kw):
    """Well-balancedness test (reference analogue: TestLakeAtRest.js,
    tools/model-builder/tests/README.md:36-64): an irregular bumpy bed,
    partly emerging above a still free surface.  The exact solution is
    that nothing moves; the validation raster at every output interval is
    the initial depth field."""
    yy, xx = np.mgrid[0:n, 0:n].astype(float) * resolution
    rng = np.random.default_rng(42)
    zb = np.zeros((n, n))
    for _ in range(12):
        cx, cy = rng.uniform(0, n * resolution, 2)
        amp = rng.uniform(0.3, 1.8)          # some bumps emerge (> fsl)
        sig = rng.uniform(4, 16) * resolution
        zb += amp * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2)
                           / (2 * sig ** 2))

    out_freq = duration / 4
    h0 = np.maximum(fsl - zb, 0.0)
    validation = {f"depth_exact_{_tstr(k * out_freq)}.asc": h0
                  for k in range(1, 5)}
    return _emit(directory, name, "Lake at rest (well-balancedness)", zb,
                 {}, duration, out_freq, scheme=scheme,
                 resolution=resolution, friction="no", fsl=fsl,
                 validation=validation, **kw)


def build_dam_break_emerging_bed(directory, name="dam-break-emerging-bed",
                                 resolution=0.25, slope_angle=np.pi / 60.0,
                                 dam_level=1.0, dam_position=20.0,
                                 upstream=20.0, downstream=45.0,
                                 duration=8.0, scheme="muscl-hancock",
                                 **kw):
    """Dam break over an emerging (upward-sloping) bed, for which the
    wet/dry front location is known in closed form (reference analogue:
    TestDamBreakAgainstObstacle sibling TestDamBreakEmergingBed.js;
    solution from Xing et al. 2010, Adv. Water Resour. 33:1476-1493).

    Bed z(x) = (x - dam_position) * tan(a); still water at FSL
    ``dam_level`` behind the dam; frictionless.  The front advances as

        x_f(t) = 2 t sqrt(g h0 cos a) - 0.5 g t^2 tan a     (h0 = dam_level)

    decelerating as it climbs the emerging bed.  Emits per-interval
    validation rasters: ``front_exact_<t>.asc`` with the reference's
    0/1/2 coding (dry beyond front / wet behind front / front cell) and
    ``front_velocity_<t>.asc`` holding d x_f/dt = 2 sqrt(g h0 cos a)
    - g t tan a on the front cells (the reference's JS evaluates this
    derivative with t^2, which does not differentiate x_f; we emit the
    true derivative).  Tests moving wet/dry fronts + positivity on an
    adverse slope."""
    from .. import constants as C

    rows = 8
    n = int(round((upstream + downstream) / resolution))
    x = (np.arange(n) + 0.5) * resolution
    xi = x - dam_position                       # dam at xi = 0
    zb1 = xi * np.tan(slope_angle)
    zb = zb1[None, :].repeat(rows, 0)
    zb[:2, :] = 9999.9
    zb[-2:, :] = 9999.9

    depth1 = np.where(xi <= 0.0, np.maximum(dam_level - zb1, 0.0), 0.0)
    depth = depth1[None, :].repeat(rows, 0)
    depth[:2] = 0.0
    depth[-2:] = 0.0

    h0 = dam_level
    celerity0 = 2.0 * np.sqrt(C.GRAVITY * h0 * np.cos(slope_angle))
    out_freq = duration / 4
    validation = {}
    for k in range(1, 5):
        t = k * out_freq
        front = (celerity0 * t
                 - 0.5 * C.GRAVITY * t * t * np.tan(slope_angle))
        # Snap to the nearest cell centre, as the reference does.
        front = (np.floor((front - resolution / 2) / resolution)
                 * resolution + resolution / 2)
        code1 = np.where(
            xi <= front + 0.75 * resolution,
            np.where(np.abs(xi - front) <= resolution / 2, 2.0, 1.0), 0.0)
        code = code1[None, :].repeat(rows, 0)
        code[:2] = 0.0
        code[-2:] = 0.0
        validation[f"front_exact_{_tstr(t)}.asc"] = code
        # Non-front cells carry NODATA (-9999), matching the reference's
        # null coding; 0.0 would read as a valid velocity sample.
        vel = np.where(
            code == 2.0,
            celerity0 - C.GRAVITY * t * np.tan(slope_angle), -9999.0)
        validation[f"front_velocity_{_tstr(t)}.asc"] = vel

    return _emit(directory, name,
                 "Dam break over an emerging bed (Xing et al. 2010)",
                 zb, {}, duration, out_freq, scheme=scheme,
                 resolution=resolution, manning=0.0, friction="no",
                 depth=depth, validation=validation, **kw)


# Gauge positions for the Soares-Frazao & Zech (2007) flume, in the
# paper's coordinate system (origin at the downstream gate edge on the
# channel centreline, x downstream, y toward the G1/G3 bank) — read off
# the experiment sketch (reference resources:
# tools/model-builder/tests/resources/dam-break-against-obstacle/
# UCL_obstacle.TIF; gauge records building_gauges_h.txt).
OBSTACLE_GAUGES = {"G1": (2.65, 1.15), "G2": (2.65, -0.60),
                   "G3": (4.00, 1.15), "G4": (4.00, -0.80),
                   "G5": (5.20, 0.30), "G6": (-1.87, 1.10)}
# Downstream gate edge / centreline in flume coordinates (x from the
# reservoir back wall, y from the G2/G4-side toe of the bank).
OBSTACLE_GATE_X = 7.55
OBSTACLE_CENTRE_Y = 1.8


def obstacle_flume_bed(xx, yy):
    """Bed elevation of the Soares-Frazao & Zech flume at points (xx, yy)
    in flume coordinates (x in [0, 35.8], y in [0, 3.6]).  Faithful to
    the experiment sketch and the reference generator
    (tools/model-builder/tests/TestDamBreakAgainstObstacle.js:46-140):

    - trapezoidal banks, 0.155 m high over the outer 0.34 m each side;
    - a 0.80 m thick gate wall at x in [6.75, 7.55] with a 1.00 m
      central opening, extruded 0.50 m;
    - the 0.80 m x 0.40 m building rotated 64 degrees with its west
      corner at (10.99, 1.75) (= (3.44, -0.05) in gate coordinates),
      extruded 0.50 m.
    """
    z = np.zeros_like(xx)
    edge = np.minimum(yy, 3.6 - yy)
    bank = np.maximum(0.155 * (1.0 - edge / 0.34), 0.0)
    z = np.maximum(z, np.where(edge < 0.34, bank, 0.0))

    gate = ((xx >= 6.75) & (xx <= 7.55)
            & (np.abs(yy - OBSTACLE_CENTRE_Y) >= 0.5))
    z = np.where(gate, 0.5, z)

    th = np.deg2rad(64.0)
    lx, ly = np.cos(th), np.sin(th)          # long (0.80 m) side
    sx, sy = np.sin(th), -np.cos(th)         # short (0.40 m) side
    px, py = xx - 10.99, yy - 1.75
    u = px * lx + py * ly
    v = px * sx + py * sy
    inside = (u >= 0.0) & (u <= 0.80) & (v >= 0.0) & (v <= 0.40)
    return np.where(inside, 0.5, z)


def build_dam_break_obstacle(directory, name="dam-break-obstacle",
                             resolution=0.1, duration=30.0,
                             scheme="muscl-hancock", **kw):
    """Dam break against an isolated obstacle: the Soares-Frazao & Zech
    (2007) laboratory flume (reference analogue:
    TestDamBreakAgainstObstacle.js + tests/resources/
    dam-break-against-obstacle/).  Geometry after the experiment sketch:
    a 35.8 m x 3.6 m channel with 0.155 m trapezoidal banks, a reservoir
    behind a 0.8 m thick gate wall with a 1 m central opening at
    x = 6.75 m, initial depths 0.40 m (reservoir) / 0.02 m (channel),
    Manning n = 0.01, and a 0.80 m x 0.40 m building rotated 64 degrees
    with its west corner 3.44 m downstream of the gate.  Emits the six
    measurement gauge locations as boundaries/gauges.csv; the measured
    records live in the reference resources
    (building_gauges_h.txt, building_vel_t*.txt) and are asserted
    against in tests/test_flume_validation.py."""
    length, width = 35.8, 3.6
    wall = 2 if scheme == "muscl-hancock" else 1   # closed-edge ring width
    n_x = int(round(length / resolution)) + 2 * wall
    n_y = int(round(width / resolution)) + 2 * wall
    xll = yll = -wall * resolution

    # Cell centres in flume coordinates (interior spans [0, L] x [0, W];
    # the extra border rings become the closed-edge walls, so the walls
    # sit OUTSIDE the flume instead of eating bank cells).
    xc = xll + (np.arange(n_x) + 0.5) * resolution
    yc = yll + (np.arange(n_y) + 0.5) * resolution
    xx, yy = np.meshgrid(xc, yc)

    zb = obstacle_flume_bed(np.clip(xx, 0.0, length),
                            np.clip(yy, 0.0, width))

    # Initial state: 0.40 m reservoir level up to the downstream gate
    # edge, 0.02 m in the channel; dry where the bed out-extrudes it.
    depth = np.where(xx < OBSTACLE_GATE_X,
                     np.maximum(0.40 - zb, 0.0),
                     np.maximum(0.02 - zb, 0.0))

    gauges = [(OBSTACLE_GATE_X + gx, OBSTACLE_CENTRE_Y + gy, name_)
              for name_, (gx, gy) in OBSTACLE_GAUGES.items()]

    return _emit(directory, name,
                 "Dam break against an isolated obstacle "
                 "(Soares-Frazao & Zech 2007 flume)", zb, {},
                 duration, duration / 6, scheme=scheme,
                 resolution=resolution, manning=0.01, friction="yes",
                 depth=depth, gauges=gauges, xll=xll, yll=yll, **kw)


BUILDERS = {
    "pluvial": build_pluvial,
    "dam-break": build_dam_break,
    "sloshing-bowl": build_sloshing_bowl,
    "lake-at-rest": build_lake_at_rest,
    "dam-break-emerging-bed": build_dam_break_emerging_bed,
    "dam-break-obstacle": build_dam_break_obstacle,
}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="hipims-tpu-torch-mb",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--name", "-n", default=None)
    ap.add_argument("--type", "-t", required=True, choices=sorted(BUILDERS))
    ap.add_argument("--directory", "-d", required=True)
    ap.add_argument("--scheme", default=None)
    ap.add_argument("--decompose", type=int, default=None, metavar="N",
                    help="split into N overlapping row-band <domain>s "
                         "(reference: hipims-mb --decompose)")
    ap.add_argument("--decompose-overlap", type=int, default=4,
                    help="shared halo rows per seam (default 4)")
    ap.add_argument("--sync-method", default=None,
                    choices=("timestep", "forecast"),
                    help="<domainSet syncMethod> for decomposed models")
    ap.add_argument("--terrain-dir", default=None,
                    help="pluvial only: directory of pre-fetched EA LiDAR "
                         "BNG tile rasters (LIDAR-DTM-2M-<TILE>.*)")
    ap.add_argument("--extent", default=None, metavar="X0,Y0,X1,Y1",
                    help="pluvial only: model extent in BNG metres")
    ap.add_argument("--resolution", type=float, default=None)
    args = ap.parse_args(argv)
    kw = {}
    if args.name:
        kw["name"] = args.name
    if args.scheme:
        kw["scheme"] = args.scheme
    if args.decompose:
        kw["decompose"] = args.decompose
        kw["decompose_overlap"] = args.decompose_overlap
    if args.sync_method:
        kw["sync_method"] = args.sync_method
    if args.terrain_dir:
        kw["terrain_dir"] = args.terrain_dir
    if args.extent:
        kw["extent"] = tuple(float(v) for v in args.extent.split(","))
    if args.resolution:
        kw["resolution"] = args.resolution
    path = BUILDERS[args.type](args.directory, **kw)
    print(f"Model written: {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
