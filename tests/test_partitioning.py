"""
Partitioning & partition-merge test suite.

Mirrors the reference test strategy (reference tests/test_partitioning.py:
label/partition round-trips, multi-topology merges, validation errors)
against this build's SFC partitioner and sort-based merge kernels
(xugrid_tpu/ugrid/partitioning.py).
"""

import numpy as np
import pytest

import xugrid_tpu as xu
from xugrid_tpu import xdata
from xugrid_tpu.ugrid import partitioning
from xugrid_tpu.xdata import DataArray, Dataset


def generate_mesh_2d(nx, ny, name="mesh2d"):
    points = [
        (x, y) for y in np.linspace(0, ny, ny + 1) for x in np.linspace(0, nx, nx + 1)
    ]
    connectivity = [
        (
            it + jt * (nx + 1),
            it + jt * (nx + 1) + 1,
            it + (jt + 1) * (nx + 1) + 1,
            it + (jt + 1) * (nx + 1),
        )
        for jt in range(ny)
        for it in range(nx)
    ]
    points = np.array(points, dtype=float)
    return xu.Ugrid2d(
        points[:, 0], points[:, 1], -1, np.array(connectivity), name=name
    )


def generate_mesh_1d(n, name="mesh1d"):
    points = [(p, p) for p in np.linspace(0, n, n + 1)]
    connectivity = [(it, it + 1) for it in range(n)]
    points = np.array(points, dtype=float)
    return xu.Ugrid1d(
        points[:, 0], points[:, 1], -1, np.array(connectivity), name=name
    )


def test_labels_to_indices():
    labels = np.array([0, 1, 0, 2, 2])
    indices = partitioning.labels_to_indices(labels)
    assert np.array_equal(indices[0], [0, 2])
    assert np.array_equal(indices[1], [1])
    assert np.array_equal(indices[2], [3, 4])


class TestPartition:
    @pytest.fixture(params=["mesh2d", "mesh1d"])
    def grid(self, request):
        if request.param == "mesh2d":
            return generate_mesh_2d(5, 3)
        return generate_mesh_1d(100)

    def n_core(self, grid):
        return getattr(grid, f"n_{ {v: k for k, v in grid.facets.items()}[grid.core_dimension] }")

    def test_label_partitions(self, grid):
        labels = grid.label_partitions(n_part=2)
        assert isinstance(labels, xu.UgridDataArray)
        assert labels.name == "labels"
        assert labels.dims == (grid.core_dimension,)
        values = np.asarray(labels.values)
        assert values.size == self.n_core(grid)
        assert np.array_equal(np.unique(values), [0, 1])

    def test_partition(self, grid):
        n_part = 2
        parts = grid.partition(n_part=n_part)
        assert len(parts) == n_part
        for part in parts:
            assert isinstance(part, type(grid))
        assert sum(self.n_core(p) for p in parts) == self.n_core(grid)

    def test_label_partitions_with_weights(self, grid):
        n = self.n_core(grid)
        weights = np.ones(n, dtype=int)
        labels = grid.label_partitions(n_part=2, weights=weights)
        assert np.array_equal(np.unique(np.asarray(labels.values)), [0, 1])

        # All weight on the first half: the zero-weight half contributes
        # nothing to imbalance, so labels must still cover every entity.
        weights = np.zeros(n, dtype=int)
        weights[: n // 2] = 1
        labels = grid.label_partitions(n_part=2, weights=weights)
        assert np.asarray(labels.values).size == n

    def test_label_partitions_with_weights__error(self, grid):
        n = self.n_core(grid)
        with pytest.raises(ValueError, match="Wrong shape on weights"):
            grid.label_partitions(n_part=2, weights=np.ones(n + 1, dtype=int))
        with pytest.raises(TypeError, match="Wrong type on weights"):
            grid.label_partitions(n_part=2, weights=np.ones(n, dtype=float))
        with pytest.raises(ValueError, match="Wrong values on weights"):
            grid.label_partitions(n_part=2, weights=np.full(n, -1, dtype=int))

    def test_partition_with_weights(self, grid):
        n = self.n_core(grid)
        parts = grid.partition(n_part=2, weights=np.ones(n, dtype=int))
        assert len(parts) == 2
        assert sum(self.n_core(p) for p in parts) == n


class TestDatasetPartition:
    @pytest.fixture(autouse=True)
    def setup(self):
        self.grid = generate_mesh_2d(4, 4)
        face_dim = self.grid.face_dimension
        node_dim = self.grid.node_dimension
        edge_dim = self.grid.edge_dimension
        ds = Dataset()
        ds["face_z"] = DataArray(
            np.arange(self.grid.n_face, dtype=float), dims=(face_dim,)
        )
        ds["node_z"] = DataArray(
            np.arange(self.grid.n_node, dtype=float), dims=(node_dim,)
        )
        ds["edge_z"] = DataArray(
            np.arange(self.grid.n_edge, dtype=float), dims=(edge_dim,)
        )
        # Variables without a UGRID dimension must pass through merges.
        ds["timeseries"] = DataArray(np.arange(3.0), dims=("time",))
        ds["scalar"] = DataArray(np.array(1.23))
        self.uds = xu.UgridDataset(ds, grids=[self.grid])
        self.obj = self.uds["face_z"]

    def test_partition_by_label__errors(self):
        labels = np.zeros(self.grid.n_face, dtype=int)
        with pytest.raises(TypeError, match="labels must be a UgridDataArray"):
            self.uds.ugrid.partition_by_label(labels)

        float_labels = xu.UgridDataArray(
            DataArray(
                np.zeros(self.grid.n_face), dims=(self.grid.face_dimension,)
            ),
            self.grid,
        )
        with pytest.raises(TypeError, match="integer dtype"):
            self.uds.ugrid.partition_by_label(float_labels)

        node_labels = xu.UgridDataArray(
            DataArray(
                np.zeros(self.grid.n_node, dtype=int),
                dims=(self.grid.node_dimension,),
            ),
            self.grid,
        )
        with pytest.raises(ValueError, match="Can only partition"):
            self.uds.ugrid.partition_by_label(node_labels)

    def test_partition_by_label__dataset(self):
        labels = self.grid.label_partitions(n_part=4)
        parts = self.uds.ugrid.partition_by_label(labels)
        assert len(parts) == 4
        for part in parts:
            assert isinstance(part, xu.UgridDataset)
            assert "face_z" in part.data_vars
            assert "node_z" in part.data_vars
            assert "edge_z" in part.data_vars
            assert "timeseries" in part.data_vars
            assert "scalar" in part.data_vars

    def test_partition_by_label__dataarray(self):
        labels = self.grid.label_partitions(n_part=4)
        parts = self.obj.ugrid.partition_by_label(labels)
        assert len(parts) == 4
        total = 0
        for part in parts:
            assert isinstance(part, xu.UgridDataArray)
            assert part.name == "face_z"
            total += part.size
        assert total == self.grid.n_face

    def test_partition_roundtrip(self):
        parts = self.uds.ugrid.partition(n_part=4)
        merged = xu.merge_partitions(parts)
        assert isinstance(merged, xu.UgridDataset)
        grid = merged.grids[0]
        assert grid.n_face == self.grid.n_face
        assert grid.n_node == self.grid.n_node
        assert grid.n_edge == self.grid.n_edge

        # Faces may be renumbered; values follow their centroid.
        order = np.lexsort(grid.centroids.T)
        ref_order = np.lexsort(self.grid.centroids.T)
        np.testing.assert_allclose(
            np.asarray(merged["face_z"].values)[order],
            np.asarray(self.uds["face_z"].values)[ref_order],
        )
        np.testing.assert_allclose(
            np.sort(np.asarray(merged["node_z"].values)),
            np.sort(np.asarray(self.uds["node_z"].values)),
        )
        np.testing.assert_allclose(
            np.sort(np.asarray(merged["edge_z"].values)),
            np.sort(np.asarray(self.uds["edge_z"].values)),
        )
        np.testing.assert_allclose(
            np.asarray(merged["timeseries"].values), np.arange(3.0)
        )
        assert float(merged["scalar"].values) == pytest.approx(1.23)

    def test_merge_partition_single(self):
        merged = xu.merge_partitions([self.uds])
        assert merged is self.uds

    def test_merge_partitions__errors(self):
        with pytest.raises(ValueError, match="zero partitions"):
            xu.merge_partitions([])

        parts = self.uds.ugrid.partition(n_part=2)
        with pytest.raises(TypeError, match="Expected UgridDataArray or UgridDataset"):
            xu.merge_partitions([parts[0], parts[1]["face_z"]])

        with pytest.raises(TypeError, match="Expected UgridDataArray or UgridDataset"):
            xu.merge_partitions([self.uds.obj, self.uds.obj])

        # Same topology name, different grid type.
        grid1d = generate_mesh_1d(3, name=self.grid.name)
        other = xu.UgridDataset(grids=[grid1d])
        with pytest.raises(TypeError, match="same type"):
            xu.merge_partitions([self.uds, other])

        # Same variable, different dimensions across partitions.
        a = self.uds.ugrid.partition(n_part=2)
        b = [p.copy() for p in a]
        bad = Dataset()
        bad["face_z"] = DataArray(
            np.zeros((2, b[1].grids[0].n_face)),
            dims=("layer", b[1].grids[0].face_dimension),
        )
        bad_part = xu.UgridDataset(bad, grids=[b[1].grids[0]])
        with pytest.raises(ValueError, match="do not match across partitions"):
            xu.merge_partitions([a[0], bad_part])

    def test_merge_partitions_no_duplicates(self):
        face_dim = self.grid.face_dimension
        p1 = self.uds.isel({face_dim: np.arange(0, 10)})
        p2 = self.uds.isel({face_dim: np.arange(6, 16)})
        merged = xu.merge_partitions([p1, p2])
        grid = merged.grids[0]
        assert grid.n_face == self.grid.n_face
        assert grid.n_node == self.grid.n_node
        # Every original face value present exactly once.
        np.testing.assert_allclose(
            np.sort(np.asarray(merged["face_z"].values)),
            np.arange(self.grid.n_face, dtype=float),
        )


class TestMultiTopology2DMergePartitions:
    @pytest.fixture(autouse=True)
    def setup(self):
        grid_a = generate_mesh_2d(2, 3, "first")
        grid_b = generate_mesh_2d(4, 5, "second")
        parts_a = grid_a.partition(n_part=2)
        parts_b = grid_b.partition(n_part=2)

        self.partitions = []
        for part_a, part_b in zip(parts_a, parts_b):
            ds = Dataset()
            ds["a"] = DataArray(
                np.ones(part_a.n_face), dims=(part_a.face_dimension,)
            )
            ds["b"] = DataArray(
                np.full(part_b.n_face, 2.0), dims=(part_b.face_dimension,)
            )
            self.partitions.append(xu.UgridDataset(ds, grids=[part_a, part_b]))
        self.grid_a = grid_a
        self.grid_b = grid_b

    def test_merge_partitions(self):
        merged = xu.merge_partitions(self.partitions)
        assert len(merged.grids) == 2
        by_name = {g.name: g for g in merged.grids}
        assert by_name["first"].n_face == self.grid_a.n_face
        assert by_name["second"].n_face == self.grid_b.n_face
        assert np.asarray(merged["a"].values).shape == (self.grid_a.n_face,)
        assert np.asarray(merged["b"].values).shape == (self.grid_b.n_face,)
        np.testing.assert_allclose(np.asarray(merged["a"].values), 1.0)
        np.testing.assert_allclose(np.asarray(merged["b"].values), 2.0)

    def test_merge_partitions__unique_grid_per_partition(self):
        # A grid appearing in only one partition should survive the merge.
        ds_a = Dataset()
        ds_a["a"] = DataArray(
            np.ones(self.grid_a.n_face), dims=(self.grid_a.face_dimension,)
        )
        ds_b = Dataset()
        ds_b["b"] = DataArray(
            np.full(self.grid_b.n_face, 2.0), dims=(self.grid_b.face_dimension,)
        )
        pa = xu.UgridDataset(ds_a, grids=[self.grid_a])
        pb = xu.UgridDataset(ds_b, grids=[self.grid_b])
        merged = xu.merge_partitions([pa, pb])
        assert len(merged.grids) == 2
        assert set(merged.data_vars) == {"a", "b"}


class TestMergeDataset1D:
    @pytest.fixture(autouse=True)
    def setup(self):
        self.grid = generate_mesh_1d(10)
        ds = Dataset()
        ds["edge_z"] = DataArray(
            np.arange(self.grid.n_edge, dtype=float),
            dims=(self.grid.edge_dimension,),
        )
        ds["node_z"] = DataArray(
            np.arange(self.grid.n_node, dtype=float),
            dims=(self.grid.node_dimension,),
        )
        self.uds = xu.UgridDataset(ds, grids=[self.grid])

    def test_merge_partitions(self):
        parts = self.uds.ugrid.partition(n_part=2)
        merged = xu.merge_partitions(parts)
        grid = merged.grids[0]
        assert grid.n_edge == self.grid.n_edge
        assert grid.n_node == self.grid.n_node
        np.testing.assert_allclose(
            np.sort(np.asarray(merged["edge_z"].values)),
            np.arange(self.grid.n_edge, dtype=float),
        )
        np.testing.assert_allclose(
            np.sort(np.asarray(merged["node_z"].values)),
            np.arange(self.grid.n_node, dtype=float),
        )


class TestMultiTopology1D2DMergePartitions:
    @pytest.fixture(autouse=True)
    def setup(self):
        grid_1d = generate_mesh_1d(10, "network")
        grid_2d = generate_mesh_2d(3, 4, "mesh")
        parts_1d = grid_1d.partition(n_part=2)
        parts_2d = grid_2d.partition(n_part=2)
        self.partitions = []
        for p1, p2 in zip(parts_1d, parts_2d):
            ds = Dataset()
            ds["edge_z"] = DataArray(
                np.ones(p1.n_edge), dims=(p1.edge_dimension,)
            )
            ds["face_z"] = DataArray(
                np.full(p2.n_face, 2.0), dims=(p2.face_dimension,)
            )
            self.partitions.append(xu.UgridDataset(ds, grids=[p1, p2]))
        self.grid_1d = grid_1d
        self.grid_2d = grid_2d

    def test_merge_partitions(self):
        merged = xu.merge_partitions(self.partitions)
        assert len(merged.grids) == 2
        by_name = {g.name: g for g in merged.grids}
        assert isinstance(by_name["network"], xu.Ugrid1d)
        assert isinstance(by_name["mesh"], xu.Ugrid2d)
        assert by_name["network"].n_edge == self.grid_1d.n_edge
        assert by_name["mesh"].n_face == self.grid_2d.n_face
        np.testing.assert_allclose(np.asarray(merged["edge_z"].values), 1.0)
        np.testing.assert_allclose(np.asarray(merged["face_z"].values), 2.0)

    def test_merge_partitions__inconsistent_grid_types(self):
        # Rename the 1d network to clash with the 2d mesh name.
        grid_1d = generate_mesh_1d(10, "mesh")
        ds = Dataset()
        ds["edge_z"] = DataArray(
            np.ones(grid_1d.n_edge), dims=(grid_1d.edge_dimension,)
        )
        bad = xu.UgridDataset(ds, grids=[grid_1d])
        with pytest.raises(TypeError, match="same type"):
            xu.merge_partitions([self.partitions[0], bad])


class TestUniqueRows:
    """Sort-based dedup kernel (device + host paths)."""

    def _check(self, rows):
        from xugrid_tpu.core.dedup import unique_rows

        index, inverse = unique_rows(rows)
        # first-seen order, ascending first-occurrence positions
        assert np.all(np.diff(index) > 0) or len(index) <= 1
        # round trip: every row reconstructs from its unique
        np.testing.assert_array_equal(
            rows[index][inverse].view(np.uint8), rows.view(np.uint8)
        )
        # count matches numpy's void-view unique (bytewise semantics)
        void = np.ascontiguousarray(rows).view(
            np.dtype((np.void, rows.dtype.itemsize * rows.shape[1]))
        )
        assert len(index) == len(np.unique(void))
        return index, inverse

    def test_host_basic(self):
        rows = np.array([[1, 2], [3, 4], [1, 2], [5, 6], [3, 4]])
        index, inverse = self._check(rows)
        np.testing.assert_array_equal(index, [0, 1, 3])
        np.testing.assert_array_equal(inverse, [0, 1, 0, 2, 1])

    def test_signed_zero_and_nan_bytewise(self):
        rows = np.array(
            [[0.0, 1.0], [-0.0, 1.0], [np.nan, 2.0], [np.nan, 2.0], [0.0, 1.0]]
        )
        index, inverse = self._check(rows)
        # bytewise: -0.0 differs from 0.0; identical NaN payloads collapse
        assert len(index) == 3

    def test_device_matches_host(self, monkeypatch):
        from xugrid_tpu.core import dedup

        rng = np.random.default_rng(9)
        rows = rng.integers(0, 50, (3000, 3)).astype(np.int64)
        monkeypatch.setenv("XUGRID_TPU_DEDUP", "host")
        ih, vh = dedup.unique_rows(rows)
        monkeypatch.setenv("XUGRID_TPU_DEDUP", "device")
        id_, vd = dedup.unique_rows(rows)
        np.testing.assert_array_equal(ih, id_)
        np.testing.assert_array_equal(vh, vd)

    def test_device_floats_match_host(self, monkeypatch):
        from xugrid_tpu.core import dedup

        rng = np.random.default_rng(10)
        base = rng.normal(size=(200, 2))
        rows = base[rng.integers(0, 200, 5000)]
        monkeypatch.setenv("XUGRID_TPU_DEDUP", "host")
        ih, vh = dedup.unique_rows(rows)
        monkeypatch.setenv("XUGRID_TPU_DEDUP", "device")
        id_, vd = dedup.unique_rows(rows)
        np.testing.assert_array_equal(ih, id_)
        np.testing.assert_array_equal(vh, vd)

    def test_empty(self):
        from xugrid_tpu.core.dedup import unique_rows

        index, inverse = unique_rows(np.zeros((0, 2)))
        assert len(index) == 0 and len(inverse) == 0
