"""
Regridders: map data between unstructured and structured topologies.

Parity: xugrid/regrid/regridder.py:99-659 (CentroidLocatorRegridder,
OverlapRegridder, RelativeOverlapRegridder, BarycentricInterpolator,
weight serialization).  Differences:

* the apply path is a jitted gather + vectorized window reduction
  (regrid/apply.py) instead of a numba prange CSR loop;
* weight build runs on the BVH celltree device kernels;
* custom methods are jnp reductions over the trailing window axis.
"""

from __future__ import annotations

import abc
from typing import Callable, Optional, Tuple, Union

import numpy as np
import pandas as pd

from xugrid_tpu import xdata
from xugrid_tpu.core.sparse import MatrixCOO, MatrixCSR, PaddedCSR
from xugrid_tpu.core.wrap import UgridDataArray, UgridDataset
from xugrid_tpu.regrid import reduce
from xugrid_tpu.regrid.apply import apply_coo_gather, apply_weights
from xugrid_tpu.regrid.structured import StructuredGrid2d
from xugrid_tpu.regrid.unstructured import UnstructuredGrid2d
from xugrid_tpu.ugrid.ugrid2d import Ugrid2d


def _apply_chunk_bytes() -> int:
    """Device working-set budget per apply chunk (f32 source+target)."""
    import os

    return int(float(os.environ.get("XUGRID_TPU_APPLY_CHUNK_BYTES", 2e9)))


def setup_grid(obj, **kwargs):
    if isinstance(obj, (UnstructuredGrid2d, StructuredGrid2d)):
        return obj  # already adapted (e.g. reconstructed from a dataset)
    if isinstance(obj, (Ugrid2d, UgridDataArray, UgridDataset)):
        return UnstructuredGrid2d(obj)
    elif isinstance(obj, (xdata.DataArray, xdata.Dataset)):
        return StructuredGrid2d(
            obj,
            name_y=kwargs.get("name_y", "y"),
            name_x=kwargs.get("name_x", "x"),
        )
    raise TypeError(
        "Expected Ugrid2d, UgridDataArray, UgridDataset, DataArray, or "
        f"Dataset; received: {type(obj).__name__}"
    )


def convert_to_match(source, target):
    PROMOTIONS = {
        frozenset({StructuredGrid2d}): StructuredGrid2d,
        frozenset({StructuredGrid2d, UnstructuredGrid2d}): UnstructuredGrid2d,
        frozenset({UnstructuredGrid2d}): UnstructuredGrid2d,
    }
    types = {type(source), type(target)}
    matched_type = PROMOTIONS[frozenset(types)]
    return source.convert_to(matched_type), target.convert_to(matched_type)


class BaseRegridder(abc.ABC):
    _METHODS = {}

    def __init__(self, source, target, tolerance: Optional[float] = None):
        self._source = setup_grid(source)
        self._target = setup_grid(target)
        self._weights = None
        self._padded = None
        self._compute_weights(self._source, self._target, tolerance)

    @property
    @abc.abstractmethod
    def weights(self):
        ...

    @abc.abstractmethod
    def _compute_weights(self, source, target, tolerance=None):
        ...

    def _setup_regrid(self, func) -> None:
        if isinstance(func, str):
            try:
                self._reduction = self._METHODS[func]
            except KeyError as e:
                raise ValueError(
                    "Invalid regridding method. Available methods are: "
                    f"{list(self._METHODS.keys())}"
                ) from e
        elif callable(func):
            # Custom reduction: a jnp function over the trailing window
            # axis f(values (..., w), weights (..., w)) -> (...).
            self._reduction = func
        else:
            raise TypeError(
                f"method must be string or callable, received: "
                f"{type(func).__name__}"
            )

    @property
    def _padded_weights(self) -> PaddedCSR:
        if self._padded is None:
            w = self._weights
            if isinstance(w, MatrixCOO):
                self._padded = PaddedCSR.from_coo(w)
            else:
                self._padded = PaddedCSR.from_csr(w)
        return self._padded

    def _regrid_array(self, source: np.ndarray) -> np.ndarray:
        source_grid = self._source
        from xugrid_tpu.xdata.lazy import is_lazy

        if is_lazy(source):
            # Out-of-core: stream row blocks along the leading dim from
            # the store, regrid each eagerly, concatenate the (much
            # smaller) results.  The analog of the reference's lazy dask
            # map_blocks path (xugrid/regrid/regridder.py:167-186).
            shp = source.shape
            if len(shp) <= source_grid.ndim or shp[0] == 0:
                # No leading dim to stream over (or nothing to stream:
                # np.concatenate([]) would raise) — materialize and run
                # the eager path, which handles zero-length shapes.
                source = np.asarray(source)
            else:
                # Budget by the decoded dtype: CF-decoded lazy blocks
                # are typically float64, not 4 bytes/element.
                itemsize = int(
                    np.dtype(getattr(source, "dtype", np.float64)).itemsize
                )
                per_row = max(itemsize, 4) * (
                    int(np.prod(shp[1:]))
                    + int(np.prod(shp[1: len(shp) - source_grid.ndim]))
                    * self._target.size
                )
                rows = max(1, int(_apply_chunk_bytes() // max(per_row, 1)))
                return np.concatenate(
                    [
                        self._regrid_array(np.asarray(source[i : i + rows]))
                        for i in range(0, shp[0], rows)
                    ],
                    axis=0,
                )
        first_dims_shape = source.shape[: -source_grid.ndim]
        if 0 in first_dims_shape:
            # Nothing to regrid (e.g. a freshly initialized time=0
            # store): reshape(-1) cannot infer the grid dim from zero
            # elements, and the apply path needs >=1 extra row.
            return np.empty(
                first_dims_shape + self._target.shape, source.dtype
            )
        source = source.reshape(first_dims_shape + (-1,))
        if source.shape[-1] != source_grid.size:
            raise ValueError(
                f"Source size {source.shape[-1]} does not match regridder "
                f"source size {source_grid.size}"
            )
        source2d = source.reshape((-1, source.shape[-1]))
        n_extra = source2d.shape[0]
        # Out-of-core chunking over the extra (time/layer) dims: bound
        # the device working set so stacks larger than device memory stream
        # through in slabs.  The analog of the reference's dask
        # map_blocks path (xugrid/regrid/regridder.py:167-186), with the
        # UGRID dim likewise kept whole per chunk.
        per_slice = 4 * (source_grid.size + self._target.size)
        rows = max(int(_apply_chunk_bytes() // max(per_slice, 1)), 1)
        if n_extra > rows:
            out = np.concatenate(
                [
                    apply_weights(
                        self._padded_weights,
                        source2d[i : i + rows],
                        self._reduction,
                        self._target.size,
                    )
                    for i in range(0, n_extra, rows)
                ]
            )
        else:
            out = apply_weights(
                self._padded_weights,
                source2d,
                self._reduction,
                self._target.size,
            )
        return out.reshape(first_dims_shape + self._target.shape)

    def regrid_dataarray(self, source: xdata.DataArray, source_dims: Tuple[str, ...]):
        extra_dims = tuple(d for d in source.dims if d not in source_dims)
        transposed = source.transpose(*extra_dims, *source_dims)
        data = transposed.data
        from xugrid_tpu.xdata.lazy import is_lazy

        if not is_lazy(data):
            data = np.asarray(data)
        result = self._regrid_array(data)
        out = xdata.DataArray(
            result,
            dims=extra_dims + tuple(self._target.dims),
            name=source.name,
            attrs=dict(source.attrs),
        )
        for k, v in transposed._coords.items():
            if set(v.dims) <= set(extra_dims):
                out._coords[k] = v
        return out

    def regrid(self, data):
        """
        Regrid the data along its grid dimensions; all other dimensions
        (e.g. time, layer) are mapped.

        Parameters
        ----------
        data: UgridDataArray or DataArray

        Returns
        -------
        regridded: UgridDataArray (unstructured target) or DataArray
            (structured target)
        """
        if isinstance(data, UgridDataArray):
            obj = data.obj
            source_dims = (data.grid.core_dimension,)
        elif isinstance(data, xdata.DataArray):
            obj = data
            source_dims = tuple(self._source.dims)
        else:
            raise TypeError(
                "Expected UgridDataArray or DataArray, received: "
                f"{type(data).__name__}"
            )

        missing_dims = set(source_dims).difference(obj.dims)
        if missing_dims:
            raise ValueError(
                f"data does not contain regridder source dimensions: "
                f"{missing_dims}"
            )

        regridded = self.regrid_dataarray(obj, source_dims)
        if isinstance(self._target, StructuredGrid2d):
            return regridded.assign_coords(self._target.coords)
        return UgridDataArray(regridded, self._target.ugrid_topology)

    # -- serialization ---------------------------------------------------------
    def to_dataset(self) -> xdata.Dataset:
        """Store weights, source, and target topology for re-use."""
        w = self._weights
        ds = xdata.Dataset()
        for field, value in zip(w._fields, w):
            value = np.asarray(value)
            if value.ndim == 0:
                ds[f"__regrid_{field}"] = ((), value)
            else:
                ds[f"__regrid_{field}"] = ((f"__regrid_{field}",), value)
        ds = ds.merge(self._source.to_dataset("__source"), compat="override")
        ds = ds.merge(self._target.to_dataset("__target"), compat="override")
        return ds

    def weights_as_dataframe(self) -> pd.DataFrame:
        """The weights as a (target_index, source_index, weight) frame."""
        matrix = self._weights
        if matrix is None:
            raise ValueError("Weights have not been computed yet.")
        if isinstance(matrix, MatrixCSR):
            matrix = matrix.to_coo()
        return pd.DataFrame(
            {
                "target_index": matrix.row,
                "source_index": matrix.col,
                "weight": matrix.data,
            }
        )

    @staticmethod
    def _csr_from_dataset(dataset) -> MatrixCSR:
        return MatrixCSR(
            np.asarray(dataset["__regrid_data"].data),
            np.asarray(dataset["__regrid_indices"].data),
            np.asarray(dataset["__regrid_indptr"].data),
            int(dataset["__regrid_n"].data),
            int(dataset["__regrid_m"].data),
            int(dataset["__regrid_nnz"].data),
        )

    @staticmethod
    def _coo_from_dataset(dataset) -> MatrixCOO:
        return MatrixCOO(
            np.asarray(dataset["__regrid_data"].data),
            np.asarray(dataset["__regrid_row"].data),
            np.asarray(dataset["__regrid_col"].data),
            int(dataset["__regrid_n"].data),
            int(dataset["__regrid_m"].data),
            int(dataset["__regrid_nnz"].data),
        )

    @classmethod
    @abc.abstractmethod
    def _weights_from_dataset(cls, dataset):
        ...

    @staticmethod
    def _structured_from_dataset(dataset, prefix: str) -> StructuredGrid2d:
        """Rebuild a structured grid stored under ``{prefix}_*`` names,
        restoring the user-facing coordinate names."""
        attrs = dataset[prefix + "_type"].attrs
        nx = attrs.get("name_x", "x")
        ny = attrs.get("name_y", "y")
        grid = StructuredGrid2d(
            dataset,
            name_x=f"{prefix}_{nx}",
            name_y=f"{prefix}_{ny}",
        )
        grid.xbounds.name, grid.xbounds.dname = nx, f"d{nx}"
        grid.ybounds.name, grid.ybounds.dname = ny, f"d{ny}"
        return grid

    @classmethod
    def from_weights(cls, weights, target):
        instance = cls.__new__(cls)
        instance._weights = cls._weights_from_dataset(weights)
        instance._padded = None
        instance._target = setup_grid(target)
        unstructured = (
            weights["__source_type"].attrs["type"] == "UnstructuredGrid2d"
        )
        if unstructured:
            instance._source = setup_grid(
                Ugrid2d.from_dataset(weights, "__source")
            )
        else:
            instance._source = cls._structured_from_dataset(
                weights, "__source"
            )
        return instance

    @classmethod
    def from_dataset(cls, dataset):
        """Reconstruct a regridder from a stored weights dataset.

        Both topology kinds round-trip: unstructured targets rebuild the
        Ugrid2d, structured targets rebuild from the stored
        ``__target_{x,y}bounds`` coordinates.  (The reference raises an
        UnboundLocalError on structured targets,
        xugrid/regrid/regridder.py:334-361.)
        """
        unstructured = (
            dataset["__target_type"].attrs["type"] == "UnstructuredGrid2d"
        )
        if unstructured:
            target = Ugrid2d.from_dataset(dataset, "__target")
        else:
            target = cls._structured_from_dataset(dataset, "__target")
        return cls.from_weights(dataset, target)


class CentroidLocatorRegridder(BaseRegridder):
    """
    Regrid by locating the target grid's centroids inside the source
    grid: out[target] = source[containing face].

    Parameters
    ----------
    source, target: Ugrid2d, UgridDataArray, or structured DataArray
    tolerance: float, optional
        On-edge tolerance for point location.
    """

    def _compute_weights(self, source, target, tolerance=None):
        source, target = convert_to_match(source, target)
        source_index, target_index, weight_values = source.locate_centroids(
            target, tolerance
        )
        self._weights = MatrixCOO.from_triplet(
            target_index, source_index, weight_values,
            n=target.size, m=source.size,
        )
        self._padded = None

    def _regrid_array(self, source):
        source_grid = self._source
        first_dims_shape = source.shape[: -source_grid.ndim]
        if 0 in first_dims_shape:
            return np.empty(
                first_dims_shape + self._target.shape, source.dtype
            )
        source = source.reshape(first_dims_shape + (-1,))
        if source.shape[-1] != source_grid.size:
            # JAX clamps out-of-bounds gathers, so a size mismatch would
            # return garbage silently without this check.
            raise ValueError(
                f"Source size {source.shape[-1]} does not match regridder "
                f"source size {source_grid.size}"
            )
        out = apply_coo_gather(
            self._weights.row, self._weights.col, source, self._weights.n
        )
        return out.reshape(first_dims_shape + self._target.shape)

    def regrid_dataarray(self, source, source_dims):
        self._reduction = None  # gather path; no reduction needed
        return super().regrid_dataarray(source, source_dims)

    @property
    def weights(self):
        return self.to_dataset()

    @weights.setter
    def weights(self, weights):
        if not isinstance(weights, MatrixCOO):
            raise TypeError(
                f"Expected MatrixCOO, received: {type(weights).__name__}"
            )
        self._weights = weights
        self._padded = None

    @classmethod
    def _weights_from_dataset(cls, dataset) -> MatrixCOO:
        return cls._coo_from_dataset(dataset)


class BaseOverlapRegridder(BaseRegridder, abc.ABC):
    def _compute_weights(self, source, target, relative: bool) -> None:
        source, target = convert_to_match(source, target)
        source_index, target_index, weight_values = source.overlap(
            target, relative=relative
        )
        self._weights = MatrixCSR.from_triplet(
            target_index, source_index, weight_values,
            n=target.size, m=source.size,
        )
        self._padded = None

    @property
    def weights(self):
        return self.to_dataset()

    @weights.setter
    def weights(self, weights):
        if not isinstance(weights, MatrixCSR):
            raise TypeError(
                f"Expected MatrixCSR, received: {type(weights).__name__}"
            )
        self._weights = weights
        self._padded = None

    @classmethod
    def _weights_from_dataset(cls, dataset) -> MatrixCSR:
        return cls._csr_from_dataset(dataset)


class OverlapRegridder(BaseOverlapRegridder):
    """
    Regrid by area of overlap between source and target faces.

    Supported methods: mean, harmonic_mean, geometric_mean, sum, minimum,
    maximum, mode, median, max_overlap, p5/p10/p25/p50/p75/p90/p95, or a
    custom jnp reduction over the trailing window axis.

    Examples
    --------
    >>> regridder = OverlapRegridder(source, target, method="mean")
    >>> result = regridder.regrid(source_data)

    Custom percentile:

    >>> p33 = OverlapRegridder.create_percentile_method(33.3)
    >>> regridder = OverlapRegridder(source, target, method=p33)
    """

    _METHODS = reduce.ABSOLUTE_OVERLAP_METHODS

    def __init__(self, source, target, method: Union[str, Callable] = "mean"):
        super().__init__(source=source, target=target)
        self._setup_regrid(method)

    def _compute_weights(self, source, target, tolerance=None) -> None:
        super()._compute_weights(source, target, relative=False)

    @staticmethod
    def create_percentile_method(percentile: float) -> Callable:
        return reduce.create_percentile_method(percentile)

    @classmethod
    def from_weights(cls, weights, target, method="mean"):
        instance = super().from_weights(weights, target)
        instance._setup_regrid(method)
        return instance


class RelativeOverlapRegridder(BaseOverlapRegridder):
    """
    Overlap regridding with weights divided by the source face area
    (first-order conservative / conductance regridding).
    """

    _METHODS = reduce.RELATIVE_OVERLAP_METHODS

    def __init__(
        self, source, target,
        method: Union[str, Callable] = "first_order_conservative",
    ):
        super().__init__(source=source, target=target, tolerance=None)
        self._setup_regrid(method)

    def _compute_weights(self, source, target, tolerance=None) -> None:
        super()._compute_weights(source, target, relative=True)

    @classmethod
    def from_weights(cls, weights, target, method="first_order_conservative"):
        instance = super().from_weights(weights, target)
        instance._setup_regrid(method)
        return instance


class BarycentricInterpolator(BaseRegridder):
    """
    Smooth interpolation: target centroids located in the source's
    centroidal voronoi tessellation, with generalized barycentric
    weights over the surrounding source faces.
    """

    _METHODS = {"mean": reduce.mean}

    def __init__(self, source, target, tolerance: Optional[float] = None):
        super().__init__(source, target, tolerance)
        # Weights sum to 1 per target; weighted mean handles NaN sources.
        self._setup_regrid("mean")

    def _compute_weights(self, source, target, tolerance=None):
        source, target = convert_to_match(source, target)
        if isinstance(source, StructuredGrid2d):
            source_index, target_index, weights = source.linear_weights(target)
        else:
            source_index, target_index, weights = source.barycentric(
                target, tolerance
            )
        self._weights = MatrixCSR.from_triplet(
            target_index, source_index, weights,
            n=target.size, m=source.size,
        )
        self._padded = None

    @property
    def weights(self):
        return self.to_dataset()

    @weights.setter
    def weights(self, weights):
        if not isinstance(weights, MatrixCSR):
            raise TypeError(
                f"Expected MatrixCSR, received: {type(weights).__name__}"
            )
        self._weights = weights
        self._padded = None

    @classmethod
    def from_weights(cls, weights, target):
        instance = super().from_weights(weights, target)
        instance._setup_regrid("mean")
        return instance

    @classmethod
    def _weights_from_dataset(cls, dataset) -> MatrixCSR:
        return cls._csr_from_dataset(dataset)
