"""British National Grid tile arithmetic + offline LiDAR DEM mosaicking.

The reference's model builder turns a model extent into 10 km BNG tile
names, downloads the Environment Agency's 2 m LiDAR for each
(LIDAR-DTM-2M-<TILE>.zip), merges and clips them into the model DEM
(reference: tools/model-builder/BngConversion.js enToRef,
Extent.js:43-58 getBngTileNames, BngTile.js download/merge pipeline,
DomainBNG.js clip).  This environment has no network, so the equivalent
here is offline-first: the same extent -> tile-name mapping, plus a
mosaicker that consumes a directory of pre-fetched per-tile rasters
(named ``LIDAR-DTM-2M-<TILE>.*`` or ``<TILE>*.*``, any raster format the
codec sniffs) — the exact files the EA workflow leaves on disk.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

GRID_CHARS = "ABCDEFGHJKLMNOPQRSTUVWXYZ"   # no 'I', as on the OS grid
TILE_SIZE = 10_000.0                        # EA LiDAR 10 km tile groups


def en_to_ref(easting: float, northing: float, precision: int = 1) -> str:
    """(easting, northing) metres -> BNG reference, e.g. (425000, 565000)
    -> 'NZ26'.  Mirrors BngConversion.enToRef (BngConversion.js:7-30);
    ``precision`` digits of each sub-100km coordinate are kept (1 digit =
    a 10 km tile)."""
    e100, n100 = int(easting // 100_000), int(northing // 100_000)
    if not (0 <= e100 <= 6 and 0 <= n100 <= 12):
        return ""
    letters = (
        GRID_CHARS[(19 - n100) - ((19 - n100) % 5) + (e100 + 10) // 5]
        + GRID_CHARS[((19 - n100) * 5) % 25 + e100 % 5]
    )
    sub_e = f"{int(easting % 100_000):05d}"[:precision]
    sub_n = f"{int(northing % 100_000):05d}"[:precision]
    return letters + sub_e + sub_n


def ref_to_en(ref: str):
    """BNG reference -> lower-left (easting, northing) metres of the
    referenced square (inverse of en_to_ref)."""
    m = re.fullmatch(r"([A-HJ-Z]{2})(\d*)", ref.strip().upper())
    if not m:
        raise ValueError(f"not a BNG reference: '{ref}'")
    letters, digits = m.groups()
    if len(digits) % 2:
        raise ValueError(f"odd digit count in BNG reference '{ref}'")
    # Invert the two-letter encoding by direct search over the 7x13
    # valid 100 km squares (the forward map is injective there).
    for e100 in range(7):
        for n100 in range(13):
            if en_to_ref(e100 * 100_000, n100 * 100_000, 0) == letters:
                p = len(digits) // 2
                sub_e = int((digits[:p] or "0").ljust(5, "0"))
                sub_n = int((digits[p:] or "0").ljust(5, "0"))
                return (e100 * 100_000 + sub_e, n100 * 100_000 + sub_n)
    raise ValueError(f"'{letters}' is outside the supported BNG area")


def tile_names_for_extent(x0: float, y0: float, x1: float, y1: float):
    """10 km BNG tile names covering [x0, x1] x [y0, y1] (reference:
    Extent.js getBngTileNames, :43-58)."""
    names = []
    e = np.floor(x0 / TILE_SIZE) * TILE_SIZE
    while e < np.ceil(x1 / TILE_SIZE) * TILE_SIZE:
        n = np.floor(y0 / TILE_SIZE) * TILE_SIZE
        while n < np.ceil(y1 / TILE_SIZE) * TILE_SIZE:
            ref = en_to_ref(e, n, 1)
            if ref:
                names.append(ref)
            n += TILE_SIZE
        e += TILE_SIZE
    return names


def find_tile_raster(terrain_dir, tile: str):
    """Locate a pre-fetched raster for one tile: EA download naming first
    (LIDAR-DTM-2M-<TILE>.*, BngTile.js apiMatchEAFilenameDTM), then any
    file starting with the tile name."""
    d = Path(terrain_dir)
    for pattern in (f"LIDAR-DTM-2M-{tile}.*", f"LIDAR-DSM-2M-{tile}.*",
                    f"{tile}_DTM.*", f"{tile}*.*"):
        hits = sorted(d.glob(pattern)) + sorted(d.glob(pattern.lower()))
        for h in hits:
            if h.suffix.lower() in (".asc", ".tif", ".tiff", ".img",
                                    ".txt"):
                return h
    return None


def mosaic_extent(terrain_dir, x0, y0, x1, y1, resolution,
                  nodata=-9999.0):
    """Mosaic pre-fetched BNG tiles onto the extent's grid.

    Returns (zb, missing_tiles): a (rows, cols) array in domain
    orientation (row 0 = south) sampled at cell centres by nearest
    neighbour — the offline analogue of the reference's VRT merge + clip
    (DomainBNG.js domainClip).  Cells with no covering tile carry
    ``nodata`` (disabled, exactly how the reference's GDAL clip leaves
    gaps)."""
    from ..io.raster import read_raster

    cols = int(round((x1 - x0) / resolution))
    rows = int(round((y1 - y0) / resolution))
    zb = np.full((rows, cols), nodata, dtype=np.float64)

    missing = []
    for tile in tile_names_for_extent(x0, y0, x1, y1):
        path = find_tile_raster(terrain_dir, tile)
        if path is None:
            missing.append(tile)
            continue
        r = read_raster(path)
        data = r.to_domain_array()           # row 0 = south
        tr, tc = data.shape
        # Cell-centre coordinates of the model grid restricted to this
        # tile's footprint.
        xs = x0 + (np.arange(cols) + 0.5) * resolution
        ys = y0 + (np.arange(rows) + 0.5) * resolution
        ci = np.floor((xs - r.xll) / r.cell_size).astype(int)
        ri = np.floor((ys - r.yll) / r.cell_size).astype(int)
        cmask = (ci >= 0) & (ci < tc)
        rmask = (ri >= 0) & (ri < tr)
        if not cmask.any() or not rmask.any():
            continue
        sub = data[np.ix_(ri[rmask], ci[cmask])]
        tgt = zb[np.ix_(rmask, cmask)]
        take = sub != nodata
        tgt[take] = sub[take]
        zb[np.ix_(rmask, cmask)] = tgt
    return zb, missing
