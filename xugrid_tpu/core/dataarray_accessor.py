"""
UgridDataArrayAccessor: topology-aware operations via ``uda.ugrid``.

Parity target: xugrid/core/dataarray_accessor.py:22-904.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import scipy.sparse

from xugrid_tpu import xdata
from xugrid_tpu.core.accessorbase import AbstractUgridAccessor
from xugrid_tpu.core.wrap import UgridDataArray, UgridDataset
from xugrid_tpu.ugrid import connectivity
from xugrid_tpu.ugrid.ugrid1d import Ugrid1d
from xugrid_tpu.ugrid.ugrid2d import Ugrid2d


class UgridDataArrayAccessor(AbstractUgridAccessor):
    """Operations using the UGRID topology, via ``uda.ugrid``."""

    def __init__(self, obj: xdata.DataArray, grid):
        self.obj = obj
        self.grid = grid

    @property
    def grids(self):
        """The topology, as a list (consistency with UgridDataset)."""
        return [self.grid]

    @property
    def name(self) -> str:
        """Name of the UGRID topology."""
        return self.grid.name

    @property
    def names(self):
        """Name of the UGRID topology, as a list."""
        return [self.grid.name]

    @property
    def topology(self) -> dict:
        """Mapping from name to UGRID topology."""
        return {self.name: self.grid}

    @property
    def bounds(self) -> dict:
        """Mapping from grid name to (minx, miny, maxx, maxy)."""
        return {self.grid.name: self.grid.bounds}

    @property
    def total_bounds(self):
        """(minx, miny, maxx, maxy) of the grid."""
        return next(iter(self.bounds.values()))

    @property
    def plot(self):
        """Plotting methods for this array's facet."""
        from xugrid_tpu.plot.plot import _PlotMethods

        return _PlotMethods(self)

    def rename(self, name: str) -> UgridDataArray:
        """Rename the topology and its coordinate/dimension names."""
        obj = self.obj
        new_grid, name_dict = self.grid.rename(name, return_name_dict=True)
        present = tuple(obj.coords) + tuple(obj.dims)
        new_obj = obj.rename(
            {k: v for k, v in name_dict.items() if k in present}
        )
        return UgridDataArray(new_obj, new_grid)

    def assign_node_coords(self) -> UgridDataArray:
        """Assign node coordinates from the grid to the object."""
        return UgridDataArray(self.grid.assign_node_coords(self.obj), self.grid)

    def assign_edge_coords(self) -> UgridDataArray:
        """Assign edge coordinates from the grid to the object."""
        return UgridDataArray(self.grid.assign_edge_coords(self.obj), self.grid)

    def assign_face_coords(self) -> UgridDataArray:
        """Assign face coordinates from the grid to the object."""
        if self.grid.topology_dimension == 1:
            raise TypeError("Cannot set face coords from a Ugrid1D topology")
        return UgridDataArray(self.grid.assign_face_coords(self.obj), self.grid)

    def set_node_coords(self, node_x: str, node_y: str):
        """Use coordinates node_x/node_y of the object as grid node coords."""
        self.grid.set_node_coords(node_x, node_y, self.obj)

    def sel(self, x=None, y=None):
        """
        Subselect in UGRID x/y: box slices return a UgridDataArray; line
        and point selections return a plain DataArray with section/point
        coordinates.
        """
        result = self.grid.sel(self.obj, x, y)
        if isinstance(result, tuple):
            return UgridDataArray(*result)
        return result

    def sel_points(
        self,
        x,
        y,
        method=None,
        out_of_bounds="warn",
        fill_value=np.nan,
        tolerance=None,
    ):
        """Select values at (x[i], y[i]) point locations."""
        return self.grid.sel_points(
            self.obj, x, y, method, out_of_bounds, fill_value, tolerance
        )

    def rasterize(self, resolution: float) -> xdata.DataArray:
        """Rasterize by sampling face values on a regular grid."""
        x, y, index = self.grid.rasterize(resolution)
        return self._raster(x, y, index)

    def rasterize_like(self, other) -> xdata.DataArray:
        """Rasterize on the x/y coordinates of another object."""
        x, y, index = self.grid.rasterize_like(
            x=np.asarray(other["x"].data), y=np.asarray(other["y"].data)
        )
        return self._raster(x, y, index)

    def to_periodic(self) -> UgridDataArray:
        """Convert to a periodic (wrap-around) grid."""
        grid, obj = self.grid.to_periodic(obj=self.obj)
        return UgridDataArray(obj, grid)

    def to_nonperiodic(self, xmax: float) -> UgridDataArray:
        """Split the periodic boundary, duplicating nodes at x = xmax."""
        grid, obj = self.grid.to_nonperiodic(xmax=xmax, obj=self.obj)
        return UgridDataArray(obj, grid)

    def _to_facet(self, facet: str, newdim: str) -> UgridDataArray:
        """Remap data between facets via the connecting connectivity."""
        grid = self.grid
        obj = self.obj
        gridfacets = grid.facets
        if facet not in gridfacets:
            raise ValueError(
                f"Cannot map to {facet} for a {type(grid).__name__} topology."
            )
        if newdim in obj.dims:
            raise ValueError(
                f"Dimension {newdim} already exists. Please provide a new "
                "dimension name."
            )
        source_dim = grid.dims.intersection(obj.dims).pop()
        target_dim = getattr(grid, f"{facet}_dimension")
        if source_dim == target_dim:
            raise ValueError(
                f"No conversion needed, data is already {facet}-associated."
            )
        source = {v: k for k, v in gridfacets.items()}[source_dim]
        conn = grid.format_connectivity_as_dense(
            getattr(grid, f"{facet}_{source}_connectivity")
        )
        # Outer gather: new shape (target_dim, newdim) over the source dim.
        axis = obj.dims.index(source_dim)
        values = np.asarray(obj.data)
        taken = np.take(values, np.maximum(conn, 0), axis=axis)
        mask_shape = [1] * values.ndim
        mask_shape[axis : axis + 1] = list(conn.shape)
        mask = (conn != -1).reshape(mask_shape)
        taken = np.where(mask, taken, np.nan)
        new_dims = (
            obj.dims[:axis] + (target_dim, newdim) + obj.dims[axis + 1 :]
        )
        coords = {
            k: v for k, v in obj._coords.items() if source_dim not in v.dims
        }
        mapped = xdata.DataArray(
            taken, dims=new_dims, name=obj.name, attrs=dict(obj.attrs)
        )
        mapped._coords.update(coords)
        return UgridDataArray(mapped, grid)

    def to_node(self, dim: str = "nmax") -> UgridDataArray:
        """Map data to nodes; new dim holds the contributing entities."""
        return self._to_facet("node", dim)

    def to_edge(self, dim: str = "nmax") -> UgridDataArray:
        """Map data to edges; new dim holds the contributing entities."""
        return self._to_facet("edge", dim)

    def to_face(self, dim: str = "nmax") -> UgridDataArray:
        """Map data to faces; new dim holds the contributing entities."""
        return self._to_facet("face", dim)

    def intersect_line(self, start: Sequence[float], end: Sequence[float]):
        """Cross-section values along a line; distance in coordinate s."""
        return self.grid.intersect_line(self.obj, start, end)

    def intersect_linestring(self, linestring):
        """Cross-section values along a linestring."""
        return self.grid.intersect_linestring(self.obj, linestring)

    @property
    def crs(self) -> dict:
        """Mapping from grid name to its CRS (None if unset)."""
        return {self.grid.name: self.grid.crs}

    def set_crs(self, crs=None, epsg=None, allow_override: bool = False):
        """Set the CRS without transforming geometry."""
        self.grid.set_crs(crs, epsg, allow_override)
        self.grid._update_coordinate_attrs(self.obj)

    def to_crs(self, crs=None, epsg=None) -> UgridDataArray:
        """Transform node geometry to a new CRS."""
        grid = self.grid.to_crs(crs, epsg)
        obj = grid._assign_derived_coords(self.obj)
        return UgridDataArray(obj, grid)

    def to_geodataframe(self, name: Optional[str] = None, dim_order=None):
        """Convert one facet's data + geometry to a GeoDataFrame."""
        import geopandas as gpd

        dim = self.obj.dims[-1]
        if name is not None:
            ds = self.obj.rename(name).to_dataset()
        else:
            ds = self.obj.to_dataset()
        variables = [
            var for var in ds.data_vars if dim in ds._variables[var].dims
        ]
        df = ds[variables].to_dataframe(dim_order=dim_order)
        geometry = self.grid.to_shapely(dim)
        return gpd.GeoDataFrame(df, geometry=geometry, crs=self.grid.crs)

    def reindex_like(self, other, tolerance: float = 0.0) -> UgridDataArray:
        """Conform to an equivalent topology with permuted entity order."""
        if isinstance(other, (Ugrid1d, Ugrid2d)):
            other_grid = other
        elif isinstance(other, (UgridDataArray, UgridDataset)):
            other_grid = other.ugrid.grid
        else:
            raise TypeError(
                "Expected Ugrid1d, Ugrid2d, UgridDataArray, or UgridDataset, "
                f"received instead: {type(other).__name__}"
            )
        new_obj = self.grid.reindex_like(
            other_grid, obj=self.obj, tolerance=tolerance
        )
        return UgridDataArray(new_obj, other_grid)

    def _binary_iterate(self, iterations, mask, value, border_value):
        if border_value == value:
            exterior = self.grid.exterior_faces
        else:
            exterior = None
        if mask is not None:
            mask = np.asarray(mask.data if hasattr(mask, "data") else mask)
        obj = self.obj
        if isinstance(obj, xdata.DataArray):
            output = connectivity._binary_iterate(
                self.grid.face_face_connectivity,
                np.asarray(obj.data),
                value,
                iterations,
                mask,
                exterior,
                border_value,
            )
            da = xdata.DataArray(
                output, dims=obj.dims, name=obj.name, attrs=dict(obj.attrs)
            )
            da._coords.update(obj._coords)
            return UgridDataArray(da, self.grid.copy())
        raise ValueError("object should be an xdata.DataArray")

    def binary_dilation(self, iterations: int = 1, mask=None, border_value=False):
        """Expand True regions along face adjacency."""
        return self._binary_iterate(iterations, mask, True, border_value)

    def binary_erosion(self, iterations: int = 1, mask=None, border_value=False):
        """Shrink True regions along face adjacency."""
        return self._binary_iterate(iterations, mask, False, border_value)

    def connected_components(self) -> UgridDataArray:
        """Label connected components of the face adjacency graph."""
        _, labels = scipy.sparse.csgraph.connected_components(
            self.grid.face_face_connectivity
        )
        return UgridDataArray(
            xdata.DataArray(labels, dims=(self.grid.face_dimension,)),
            self.grid,
        )

    def reverse_cuthill_mckee(self) -> UgridDataArray:
        """Reorder faces to reduce adjacency bandwidth."""
        grid = self.grid
        reordered_grid, reordering = grid.reverse_cuthill_mckee()
        reordered_data = self.obj.isel({grid.face_dimension: reordering})
        return UgridDataArray(reordered_data, reordered_grid)

    def label_partitions(self, n_part: int) -> UgridDataArray:
        """Partition labels; the data values act as weights."""
        obj = self.obj
        grid = self.grid
        if tuple(obj.dims) != (grid.core_dimension,):
            raise ValueError(
                "Weights must be associated with the core-dimension of the "
                f"grid: {grid.core_dimension}"
            )
        return grid.label_partitions(
            n_part=n_part, weights=np.asarray(obj.data)
        )

    def interpolate_na(
        self, method: str = "nearest", max_distance: Optional[float] = None
    ) -> UgridDataArray:
        """Fill NaNs from the nearest valid entity (KDTree for 2D grids,
        network distance for 1D)."""
        from xugrid_tpu.ugrid.interpolate import interpolate_na_helper

        if method != "nearest":
            raise ValueError(f'"{method}" is not a valid interpolator.')
        if max_distance is None:
            max_distance = np.inf
        grid = self.grid
        da = self.obj
        ugrid_dim = grid.find_ugrid_dim(da)
        da_filled = interpolate_na_helper(
            da,
            ugrid_dim=ugrid_dim,
            func=grid._nearest_interpolate,
            kwargs={"ugrid_dim": ugrid_dim, "max_distance": max_distance},
        )
        return UgridDataArray(da_filled, grid)

    def laplace_interpolate(
        self,
        xy_weights: bool = True,
        direct_solve: bool = False,
        delta=0.0,
        relax=0.0,
        rtol: float = 0.0,
        atol: float = 1.0e-4,
        maxiter: int = 500,
        precondition_degree: int = 4,
    ) -> UgridDataArray:
        """
        Fill NaNs by solving Laplace's equation with the known values as
        boundary conditions.

        Iterative path is a jit-compiled conjugate-gradient solve with a
        degree-``precondition_degree`` Chebyshev polynomial of the
        Jacobi-scaled operator as preconditioner (1 = plain Jacobi;
        fully parallel — the reference's sequential ILU0 is inherently
        serial, dataarray_accessor.py:805-886, interpolate.py:30-114).
        ``delta``/``relax`` are accepted for API parity.
        """
        from xugrid_tpu.ugrid.interpolate import (
            interpolate_na_helper,
            laplace_interpolate,
        )

        grid = self.grid
        da = self.obj
        ugrid_dim = grid.find_ugrid_dim(da)
        if ugrid_dim == grid.edge_dimension:
            raise ValueError("Laplace interpolation along edges is not allowed.")
        conn = grid.get_connectivity_matrix(ugrid_dim, xy_weights=xy_weights)
        _, components_labels = scipy.sparse.csgraph.connected_components(conn)
        da_filled = interpolate_na_helper(
            da,
            ugrid_dim,
            func=laplace_interpolate,
            kwargs={
                "connectivity": conn,
                "use_weights": xy_weights,
                "components_labels": components_labels,
                "direct_solve": direct_solve,
                "delta": delta,
                "relax": relax,
                "rtol": rtol,
                "atol": atol,
                "maxiter": maxiter,
                "precondition_degree": precondition_degree,
            },
        )
        return UgridDataArray(da_filled, grid)

    def to_dataset(self, optional_attributes: bool = False):
        """Convert to a plain Dataset with UGRID topology variables."""
        obj = self.obj
        if obj.name is None:
            obj = obj.rename(f"{self.grid.name}_data")
        return self.grid.to_dataset(obj.to_dataset(), optional_attributes)
