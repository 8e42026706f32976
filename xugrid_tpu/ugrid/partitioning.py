"""
Partition and merge UGRID topologies.

Two halves:

* ``partition_labels``: the built-in partitioner.  The reference
  delegates to METIS (xugrid/ugrid/ugridbase.py:1528-1571); here we use a
  Hilbert-style space-filling-curve decomposition over entity centroids
  with weighted balanced splits.  SFC parts are contiguous and balanced,
  cheap to compute at any scale, deterministic, and map directly onto
  device sharding (the same ordering is reused to lay faces out across
  devices; see xugrid_tpu.parallel).

* ``merge_partitions`` and helpers: reassemble partitioned topologies
  plus their data (reference: xugrid/ugrid/partitioning.py:81-414),
  deduplicating shared nodes/faces/edges via sort-based unique.
"""

from __future__ import annotations

from collections import defaultdict
from itertools import accumulate, chain
from typing import List, Optional

import numpy as np

from xugrid_tpu import xdata
from xugrid_tpu.constants import FILL_VALUE, IntArray, IntDType
from xugrid_tpu.core.dedup import unique_rows


# ---------------------------------------------------------------------------
# Partitioning
# ---------------------------------------------------------------------------
def hilbert_distance(xy: np.ndarray, order: int = 16) -> np.ndarray:
    """
    Distance along the Hilbert curve for 2D points (vectorized numpy).

    Unlike the Morton/Z curve, consecutive Hilbert cells are always
    spatially adjacent, so contiguous index ranges form compact parts.
    """
    from xugrid_tpu.utils.native import hilbert_distance_native

    native = hilbert_distance_native(xy, order)
    if native is not None:
        return native

    lo = xy.min(axis=0)
    hi = xy.max(axis=0)
    extent = np.maximum(hi - lo, 1e-300)
    side = (1 << order) - 1
    x = ((xy[:, 0] - lo[0]) / extent[0] * side).astype(np.uint64)
    y = ((xy[:, 1] - lo[1]) / extent[1] * side).astype(np.uint64)

    rx = np.zeros_like(x)
    ry = np.zeros_like(y)
    d = np.zeros_like(x)
    s = np.uint64(1) << np.uint64(order - 1)
    one = np.uint64(1)
    while s > 0:
        rx = ((x & s) > 0).astype(np.uint64)
        ry = ((y & s) > 0).astype(np.uint64)
        d += s * s * ((np.uint64(3) * rx) ^ ry)
        # Rotate quadrant
        swap = ry == 0
        flip = swap & (rx == 1)
        x_f = x.copy()
        x = np.where(flip, (s - one) - x, x)
        y = np.where(flip, (s - one) - y, y)
        x2 = np.where(swap, y, x)
        y2 = np.where(swap, x, y)
        x, y = x2, y2
        s >>= one
    return d


def partition_labels(
    coordinates: np.ndarray,
    n_part: int,
    adjacency=None,
    weights: Optional[IntArray] = None,
) -> IntArray:
    """
    Assign one of ``n_part`` labels to every entity.

    Entities are ordered along the Hilbert curve of their coordinates and
    split into contiguous, (weight-)balanced chunks.  The optional
    adjacency argument is accepted for API parity (graph-based
    refinement); the SFC split already yields compact connected parts on
    typical meshes.
    """
    n = len(coordinates)
    if n_part < 1:
        raise ValueError(f"n_part must be >= 1, received: {n_part}")
    if n_part > n:
        raise ValueError(
            f"Cannot partition {n} entities into {n_part} parts."
        )
    order = np.argsort(hilbert_distance(coordinates), kind="stable")
    if weights is None:
        # Equal-count contiguous chunks.
        bounds = (np.arange(1, n_part) * n) // n_part
    else:
        w = np.asarray(weights, dtype=np.float64)[order]
        cum = np.cumsum(w)
        total = cum[-1]
        targets = np.arange(1, n_part) * (total / n_part)
        bounds = np.searchsorted(cum, targets)
    labels = np.empty(n, dtype=IntDType)
    chunk_sizes = np.diff(np.concatenate([[0], bounds, [n]])).astype(np.int64)
    labels[order] = np.repeat(np.arange(n_part), chunk_sizes)
    return labels


def labels_to_indices(labels: IntArray) -> List[IntArray]:
    """[0, 1, 0, 2, 2] -> [[0, 2], [1], [3, 4]]."""
    sorter = np.argsort(labels, kind="stable")
    split_indices = np.cumsum(np.bincount(labels)[:-1])
    indices = np.split(sorter, split_indices)
    for index in indices:
        index.sort()
    return indices


def partition_by_label(grid, obj, labels):
    """Partition grid and data object by integer labels."""
    from xugrid_tpu.core.wrap import UgridDataArray, UgridDataset

    if not isinstance(labels, UgridDataArray):
        raise TypeError(
            f"labels must be a UgridDataArray, received: {type(labels).__name__}"
        )
    if not np.issubdtype(labels.dtype, np.integer):
        raise TypeError(f"labels must have integer dtype, received {labels.dtype}")
    if labels.grid != grid:
        raise ValueError("grid of labels does not match xugrid object")
    if tuple(labels.dims) != (grid.core_dimension,):
        raise ValueError(
            f"Can only partition this topology by {grid.core_dimension}, "
            f"found the dimensions: {labels.dims}"
        )

    if isinstance(obj, xdata.Dataset):
        obj_type = UgridDataset
    elif isinstance(obj, xdata.DataArray):
        obj_type = UgridDataArray
    else:
        raise TypeError(
            f"Expected DataArray or Dataset, received: {type(obj).__name__}"
        )

    indices = labels_to_indices(labels.values)
    partitions = []
    for index in indices:
        new_grid, indexes = grid.topology_subset(index, return_index=True)
        indexes = {
            k: v.to_numpy() for k, v in indexes.items() if k in obj.dims
        }
        new_obj = obj.isel(indexes)
        partitions.append(obj_type(new_obj, new_grid))
    return partitions


# ---------------------------------------------------------------------------
# Merging
# ---------------------------------------------------------------------------
def merge_nodes(grids):
    """Deduplicate stacked nodes by exact coordinates; keep first-seen
    order. Returns (unique_xy, per-partition indexes, inverse map)."""
    node_x = np.hstack([grid.node_x for grid in grids])
    node_y = np.hstack([grid.node_y for grid in grids])
    node_xy = np.column_stack((node_x, node_y))
    index, inverse = unique_rows(node_xy)
    unique_nodes = node_xy[index]
    slices = (0,) + tuple(accumulate(grid.n_node for grid in grids))
    sections = np.searchsorted(index, slices[1:-1])
    indexes = np.split(index, sections)
    for partition_index, offset in zip(indexes, slices):
        partition_index -= offset
    return unique_nodes, indexes, inverse


def _merge_connectivity(gathered, slices):
    """Sort rows so [0,1]==[1,0]; keep first occurrence, original order."""
    from xugrid_tpu.utils.native import unique_sorted_rows_native

    native = unique_sorted_rows_native(gathered)
    if native is not None:
        # One native pass: per-row insertion sort + first-seen hash
        # join (no np.sort(axis=1) materialization — it copied and
        # wrote the whole stacked table before the join).
        index = native[0]
    else:
        sorted_rows = np.sort(gathered, axis=1)
        index, _ = unique_rows(sorted_rows)
    merged = gathered[index]
    sections = np.searchsorted(index, slices[1:-1])
    indexes = np.split(index, sections)
    for partition_index, offset in zip(indexes, slices):
        partition_index -= offset
    return merged, indexes


def merge_faces(grids, node_inverse):
    node_offsets = tuple(accumulate([0] + [grid.n_node for grid in grids]))
    n_face = [grid.n_face for grid in grids]
    n_max_node = max(grid.n_max_node_per_face for grid in grids)
    slices = (0,) + tuple(accumulate(n_face))

    all_faces = np.full((sum(n_face), n_max_node), FILL_VALUE, dtype=IntDType)
    for grid, face_offset, node_offset in zip(grids, slices, node_offsets):
        faces = grid.face_node_connectivity
        nf, n_node_per_face = faces.shape
        valid = faces != FILL_VALUE
        all_faces[face_offset : face_offset + nf, :n_node_per_face][valid] = (
            node_inverse[faces[valid] + node_offset]
        )
    return _merge_connectivity(all_faces, slices)


def merge_edges(grids, node_inverse):
    node_offsets = tuple(accumulate([0] + [grid.n_node for grid in grids]))
    n_edge = [grid.n_edge for grid in grids]
    slices = (0,) + tuple(accumulate(n_edge))

    all_edges = np.empty((sum(n_edge), 2), dtype=IntDType)
    for grid, edge_offset, offset in zip(grids, slices, node_offsets):
        edges = grid.edge_node_connectivity
        ne = len(edges)
        all_edges[edge_offset : edge_offset + ne] = node_inverse[edges + offset]
    return _merge_connectivity(all_edges, slices)


def validate_partition_topology(grouped) -> None:
    for name, grids in grouped.items():
        types = {type(grid) for grid in grids}
        if len(types) > 1:
            raise TypeError(
                f"All partition topologies with name {name} should be of "
                f"the same type, received: {types}"
            )
        griddims = list({tuple(sorted(grid.dims)) for grid in grids})
        if len(griddims) > 1:
            raise ValueError(
                f"Dimension names on UGRID topology {name} do not match "
                f"across partitions: {griddims[0]} versus {griddims[1]}"
            )


def group_grids_by_name(partitions):
    grouped = defaultdict(list)
    for partition in partitions:
        for grid in partition.grids:
            grouped[grid.name].append(grid)
    validate_partition_topology(grouped)
    return grouped


def group_data_objects_by_gridname(partitions):
    data_objects = [
        p.obj.to_dataset() if isinstance(p.obj, xdata.DataArray) else p.obj
        for p in partitions
    ]
    grouped = defaultdict(list)
    for partition, obj in zip(partitions, data_objects):
        for grid in partition.grids:
            grouped[grid.name].append(obj)
    return grouped


def validate_partition_objects(objects_by_gridname) -> None:
    for data_objects in objects_by_gridname.values():
        allvars = list({tuple(sorted(ds.data_vars)) for ds in data_objects})
        unique_vars = set(chain(*allvars))
        for var in unique_vars:
            vardims = {
                ds._variables[var].dims
                for ds in data_objects
                if var in ds.data_vars
            }
            if len(vardims) > 1:
                vardims_ls = list(vardims)
                raise ValueError(
                    f"Dimensions for '{var}' do not match across "
                    f"partitions: {vardims_ls[0]} versus {vardims_ls[1]}"
                )


def separate_variables(objects_by_gridname, ugrid_dims):
    """Split variables into UGRID-dim-associated (by dim) and others."""
    validate_partition_objects(objects_by_gridname)

    def remove_item(tup, index):
        return tup[:index] + tup[index + 1 :]

    def all_equal(iterable):
        items = list(iterable)
        return all(element == items[0] for element in items)

    grouped = defaultdict(set)
    other = defaultdict(set)
    for gridname, data_objects in objects_by_gridname.items():
        variables = {
            varname: var
            for obj in data_objects
            for varname, var in obj._variables.items()
        }
        for var, variable in variables.items():
            dims = variable.dims
            shapes = [
                obj._variables[var].shape for obj in data_objects if var in obj
            ]
            intersection = ugrid_dims.intersection(dims)
            if intersection:
                if len(intersection) > 1:
                    raise ValueError(
                        f"{var} contains more than one UGRID dimension: "
                        f"{intersection}"
                    )
                dim = intersection.pop()
                axis = dims.index(dim)
                shapes = [remove_item(shape, axis) for shape in shapes]
                if all_equal(shapes):
                    grouped[dim].add(var)
            elif all_equal(shapes):
                other[gridname].add(var)
    return grouped, other


def merge_data_along_dim(data_objects, variables, merge_dim, indexes, merged_grid):
    """isel per-partition indexes, pad nmax connectivity dims, concat."""
    max_sizes = merged_grid.max_connectivity_sizes
    ugrid_connectivity_dims = set(max_sizes)

    to_merge = []
    for obj, index in zip(data_objects, indexes):
        missing_vars = set(variables).difference(set(obj._variables))
        if missing_vars:
            raise ValueError(f"Missing variables: {missing_vars} in partition")
        selection = obj[sorted(variables)]
        if merge_dim in selection.dims_sizes():
            selection = selection.isel({merge_dim: index})
        present = ugrid_connectivity_dims.intersection(selection.dims_sizes())
        for dim in present:
            nmax = max_sizes[dim]
            size = selection.dims_sizes()[dim]
            if size != nmax:
                selection = _pad_dim(selection, dim, nmax - size)
        to_merge.append(selection)
    return xdata.concat(to_merge, dim=merge_dim)


def _pad_dim(ds: xdata.Dataset, dim: str, count: int) -> xdata.Dataset:
    out = xdata.Dataset(attrs=dict(ds.attrs))
    out._coord_names = set(ds._coord_names)
    for name, var in ds._variables.items():
        if dim in var.dims:
            axis = var.dims.index(dim)
            widths = [(0, 0)] * var.ndim
            widths[axis] = (0, count)
            fill = FILL_VALUE if np.issubdtype(var.dtype, np.integer) else np.nan
            data = np.pad(
                np.asarray(var.data), widths, constant_values=fill
            )
            out._variables[name] = xdata.Variable(var.dims, data, var.attrs)
        else:
            out._variables[name] = var
    return out


def merge_partitions(partitions, merge_ugrid_chunks: bool = True):
    """
    Merge topology and data partitioned along UGRID dimensions into a
    single UgridDataset.

    Parameters
    ----------
    partitions: sequence of UgridDataArray or UgridDataset
    merge_ugrid_chunks: bool
        Accepted for API parity; chunks do not exist in this framework
        (XLA executes eagerly with async dispatch).

    Returns
    -------
    merged: UgridDataset
    """
    from xugrid_tpu.core.wrap import UgridDataArray, UgridDataset

    if len(partitions) == 0:
        raise ValueError("Cannot merge partitions: zero partitions provided.")
    types = {type(obj) for obj in partitions}
    msg = "Expected UgridDataArray or UgridDataset, received: {}"
    if len(types) > 1:
        raise TypeError(msg.format([t.__name__ for t in types]))
    obj_type = types.pop()
    if obj_type not in (UgridDataArray, UgridDataset):
        raise TypeError(msg.format(obj_type.__name__))
    if len(partitions) == 1:
        return next(iter(partitions))

    grids = [grid for p in partitions for grid in p.grids]
    ugrid_dims = {dim for grid in grids for dim in grid.dims}
    grids_by_name = group_grids_by_name(partitions)
    data_objects_by_name = group_data_objects_by_gridname(partitions)
    vars_by_dim, other_vars_by_name = separate_variables(
        data_objects_by_name, ugrid_dims
    )

    merged = xdata.Dataset()
    merged_grids = []
    for gridname, grids in grids_by_name.items():
        data_objects = data_objects_by_name[gridname]
        other_vars = other_vars_by_name[gridname]

        grid = grids[0]
        merged_grid, indexes = grid.merge_partitions(grids)
        merged_grids.append(merged_grid)

        for obj in data_objects:
            present = set(other_vars).intersection(set(obj.data_vars))
            if present:
                merged.update(obj[sorted(present)])

        for dim, dim_indexes in indexes.items():
            variables = vars_by_dim[dim]
            if len(variables) == 0:
                continue
            dim_indexes = [
                idx.to_numpy() if hasattr(idx, "to_numpy") else np.asarray(idx)
                for idx in dim_indexes
            ]
            merged_selection = merge_data_along_dim(
                data_objects, variables, dim, dim_indexes, merged_grid
            )
            merged.update(merged_selection)

    return UgridDataset(merged, merged_grids)
