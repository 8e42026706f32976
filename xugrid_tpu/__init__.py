"""
xugrid_tpu: a JAX framework for 1D network and 2D unstructured-grid
(UGRID conventions) data.

Capability-parity rebuild of Deltares/xugrid on JAX/XLA:
topologies are padded dense int arrays; the spatial index is a flat BVH
with batched jitted queries; regridders build sparse weights on device and
apply them as fused gather + window-reduction kernels; partitioning maps
onto device sharding with collective halo exchange.  The labeled-array
core (xdata) is self-contained: xarray, netCDF4, shapely, and pyproj are
optional integrations.
"""

__version__ = "0.1.0"

from xugrid_tpu import xdata
from xugrid_tpu.constants import FILL_VALUE
from xugrid_tpu.core.common import (
    concat,
    full_like,
    load_dataarray,
    load_dataset,
    merge,
    ones_like,
    open_dataarray,
    open_dataset,
    open_mfdataset,
    open_zarr,
    zeros_like,
)
from xugrid_tpu.core.dataarray_accessor import UgridDataArrayAccessor
from xugrid_tpu.core.dataset_accessor import UgridDatasetAccessor
from xugrid_tpu.core.wrap import UgridDataArray, UgridDataset
from xugrid_tpu.plot import plot
from xugrid_tpu.regrid.gridder import NetworkGridder
from xugrid_tpu.regrid.regridder import (
    BarycentricInterpolator,
    CentroidLocatorRegridder,
    OverlapRegridder,
    RelativeOverlapRegridder,
)
from xugrid_tpu.ugrid.burn import (
    burn_vector_geometry,
    earcut_triangulate_polygons,
)
from xugrid_tpu.ugrid.conventions import UgridRolesAccessor, ugrid_roles
from xugrid_tpu.ugrid.partitioning import merge_partitions
from xugrid_tpu.ugrid.polygonize import polygonize
from xugrid_tpu.ugrid.snapping import (
    create_snap_to_grid_dataframe,
    snap_nodes,
    snap_to_grid,
)
from xugrid_tpu.ugrid.ugrid1d import Ugrid1d
from xugrid_tpu.ugrid.ugrid2d import Ugrid2d
from xugrid_tpu.ugrid.ugridbase import AbstractUgrid
from xugrid_tpu import data  # noqa: E402  (imports xugrid_tpu itself)

__all__ = (
    "data",
    "xdata",
    "FILL_VALUE",
    "concat",
    "full_like",
    "load_dataarray",
    "load_dataset",
    "merge",
    "ones_like",
    "open_dataarray",
    "open_dataset",
    "open_mfdataset",
    "open_zarr",
    "zeros_like",
    "UgridDataArrayAccessor",
    "UgridDatasetAccessor",
    "UgridDataArray",
    "UgridDataset",
    "plot",
    "BarycentricInterpolator",
    "CentroidLocatorRegridder",
    "OverlapRegridder",
    "RelativeOverlapRegridder",
    "burn_vector_geometry",
    "earcut_triangulate_polygons",
    "NetworkGridder",
    "UgridRolesAccessor",
    "ugrid_roles",
    "merge_partitions",
    "polygonize",
    "snap_nodes",
    "snap_to_grid",
    "create_snap_to_grid_dataframe",
    "AbstractUgrid",
    "Ugrid1d",
    "Ugrid2d",
)
