"""Dataset I/O: rasters (ASC / GeoTIFF), CSV timeseries, XML config.

Grid convention: ``Raster.data`` is in map orientation (row 0 = north);
domain arrays are south-up (row 0 = south) — use Raster.to_domain_array /
from_domain_array to convert.
"""

from .raster import Raster, read_raster, write_raster  # noqa: F401
from .csv_series import read_timeseries_csv  # noqa: F401
