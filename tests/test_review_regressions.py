"""
Regression tests for the high-effort xdata/spatial review findings:
each test reproduces a confirmed bug from that review and pins the fix.
"""

import numpy as np
import pytest

import xugrid_tpu as xu
from xugrid_tpu import xdata
from xugrid_tpu.xdata import DataArray, Dataset, Variable


class TestVariableIsel:
    def test_multi_indexer_boolean_mask(self):
        # Bool masks in the multi-array-indexer branch were cast to
        # int indices [1,0,1], silently returning wrong rows.
        v = Variable(("x", "y"), np.arange(12).reshape(3, 4))
        out = v.isel({"x": np.array([True, False, True]), "y": [0, 1]})
        np.testing.assert_array_equal(out.data, [[0, 1], [8, 9]])

    def test_single_boolean_mask_still_works(self):
        v = Variable(("x",), np.arange(5.0))
        out = v.isel({"x": np.array([True, False, True, False, False])})
        np.testing.assert_array_equal(out.data, [0.0, 2.0])


class TestPackedFillDecode:
    def test_int_fill_with_scale(self, tmp_path):
        from scipy.io import netcdf_file

        p = tmp_path / "packed.nc"
        with netcdf_file(str(p), "w") as f:
            f.createDimension("x", 3)
            v = f.createVariable("v", np.int16, ("x",))
            v[:] = np.array([100, -32767, 200], dtype=np.int16)
            v._FillValue = np.int16(-32767)
            v.scale_factor = 0.01
        back = xdata.open_dataset(p)
        data = np.asarray(back["v"].data)
        np.testing.assert_allclose(data[[0, 2]], [1.0, 2.0])
        assert np.isnan(data[1])  # sentinel masked BEFORE unpacking


class TestExpandDims:
    def test_coordinate_survives(self):
        ds = Dataset()
        ds["a"] = DataArray(np.arange(3.0), dims=("x",))
        out = ds.expand_dims({"time": [10, 20]})
        assert "time" in out.coords
        sel = out.sel(time=20)
        np.testing.assert_array_equal(np.asarray(sel["a"].data), [0, 1, 2])


class TestZarrOverwrite:
    def test_stale_arrays_removed(self, tmp_path):
        p = tmp_path / "s.zarr"
        ds1 = Dataset()
        ds1["a"] = DataArray(np.arange(3.0), dims=("x",))
        ds1["b"] = DataArray(np.arange(3.0), dims=("x",))
        ds1.to_zarr(p)
        ds2 = Dataset()
        ds2["a"] = DataArray(np.arange(4.0), dims=("x",))
        with pytest.raises(FileExistsError, match="mode='w'"):
            ds2.to_zarr(p)
        ds2.to_zarr(p, mode="w")
        back = xdata.open_zarr(p)
        assert set(back.data_vars) == {"a"}
        assert back["a"].shape == (4,)


class TestSelTolerance:
    def test_tolerance_enforced(self):
        da = DataArray(
            np.arange(3.0), dims=("x",)
        ).assign_coords(x=[0.0, 10.0, 20.0])
        assert float(da.sel(x=9.5, method="nearest").data) == 1.0
        with pytest.raises(KeyError):
            da.sel(x=4.9, method="nearest", tolerance=1.0)

    def test_dataset_sel_tolerance(self):
        ds = Dataset()
        ds["v"] = DataArray(
            np.arange(3.0), dims=("x",)
        ).assign_coords(x=[0.0, 10.0, 20.0])
        out = ds.sel(x=10.4, method="nearest", tolerance=1.0)
        assert float(out["v"].data) == 1.0
        with pytest.raises(KeyError):
            ds.sel(x=4.9, method="nearest", tolerance=1.0)


class TestWhereDrop:
    def test_plain_array_cond(self):
        da = DataArray(np.arange(5.0), dims=("x",))
        out = da.where(
            np.array([True, False, True, False, False]), drop=True
        )
        np.testing.assert_array_equal(np.asarray(out.data), [0.0, 2.0])


class TestIdxReductions:
    def test_idxmax_skips_nan(self):
        da = DataArray(
            np.array([1.0, np.nan, 3.0]), dims=("x",)
        ).assign_coords(x=[10, 20, 30])
        assert int(da.idxmax().data) == 30
        assert int(da.idxmin().data) == 10

    def test_idxmax_skipna_false(self):
        da = DataArray(
            np.array([1.0, np.nan, 3.0]), dims=("x",)
        ).assign_coords(x=[10, 20, 30])
        assert int(da.idxmax(skipna=False).data) == 20  # NaN wins argmax


class TestMeanValueOnEdge:
    def test_edge_point_is_linear_interpolation(self):
        import jax.numpy as jnp

        from xugrid_tpu.spatial.geometry import mean_value_weights

        square = jnp.array(
            [[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]]
        )
        w = np.asarray(
            mean_value_weights(jnp.array([0.25, 0.0]), square, 1e-12)
        )
        np.testing.assert_allclose(w, [0.75, 0.25, 0.0, 0.0], atol=1e-12)

    def test_barycentric_on_edge_via_celltree(self):
        from xugrid_tpu.spatial.celltree import CellTree2d

        nodes = np.array([[0.0, 0.0], [2.0, 0.0], [0.0, 2.0]])
        tree = CellTree2d(nodes, np.array([[0, 1, 2]]), -1)
        fi, w = tree.compute_barycentric_weights(np.array([[1.0, 0.0]]))
        w = np.asarray(w)[0]
        vals = np.array([0.0, 10.0, 100.0])
        # Point midway along the bottom edge: value must be 5.
        np.testing.assert_allclose((w[:3] * vals).sum(), 5.0, atol=1e-6)


class TestCollinearIntersections:
    def test_network_edge_overlap(self):
        net = xu.Ugrid1d(
            np.array([0.0, 2.0, 4.0]),
            np.array([0.0, 0.0, 0.0]),
            -1,
            np.array([[0, 1], [1, 2]]),
        )
        ei, ci, pts = net.intersect_edges(
            np.array([[[0.5, 0.0], [3.5, 0.0]]])
        )
        assert sorted(ci.tolist()) == [0, 1]

    def test_segment_segment_collinear(self):
        import jax.numpy as jnp

        from xugrid_tpu.spatial.geometry import segment_segment_intersection

        hit, pt = segment_segment_intersection(
            jnp.array([0.0, 0.0]), jnp.array([4.0, 0.0]),
            jnp.array([1.0, 0.0]), jnp.array([3.0, 0.0]),
        )
        assert bool(hit)
        np.testing.assert_allclose(np.asarray(pt), [1.0, 0.0])
        # Disjoint collinear segments: no hit.
        hit, _ = segment_segment_intersection(
            jnp.array([0.0, 0.0]), jnp.array([1.0, 0.0]),
            jnp.array([2.0, 0.0]), jnp.array([3.0, 0.0]),
        )
        assert not bool(hit)


class TestNearestPrecision:
    def test_utm_scale_coordinates(self, monkeypatch):
        from xugrid_tpu.spatial import nearest

        # Sources 0.05 m apart at UTM magnitudes: f32 cannot represent
        # the offsets without the local-origin shift.
        base = np.array([500000.0, 4000000.0])
        sources = base + np.array([[0.0, 0.0], [0.05, 0.0], [0.1, 0.0]])
        queries = base + np.array([[0.06, 0.0]])
        monkeypatch.setenv("XUGRID_TPU_NEAREST", "device")
        idx = nearest.nearest_points(sources, queries)
        assert idx[0] == 1


class TestDatasetUpdateSizes:
    def test_conflicting_sizes_rejected(self):
        ds = Dataset()
        ds["a"] = DataArray(np.arange(3.0), dims=("x",))
        other = Dataset()
        other["b"] = DataArray(np.arange(4.0), dims=("x",))
        with pytest.raises(ValueError, match="conflicting size"):
            ds.update(other)


class TestStructuredBounds:
    def test_from_structured2d_bounds_1d_coords(self):
        # x/y naming 1-D coords with explicit bounds: dims were swapped,
        # scrambling face order (review finding, reproduced).
        y_mid = np.array([0.5, 1.5])
        x_mid = np.array([0.5, 1.5, 2.5])
        da = DataArray(
            np.array([[0.0, 1.0, 2.0], [3.0, 4.0, 5.0]]), dims=("y", "x")
        ).assign_coords(y=y_mid, x=x_mid)
        xb = np.column_stack([x_mid - 0.5, x_mid + 0.5])
        yb = np.column_stack([y_mid - 0.5, y_mid + 0.5])
        uda = xu.UgridDataArray.from_structured2d(
            da, x="x", y="y",
            x_bounds=DataArray(xb, dims=("x", "two")),
            y_bounds=DataArray(yb, dims=("y", "two")),
        )
        np.testing.assert_array_equal(
            np.asarray(uda.values), [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]
        )

    def test_dataset_from_structured2d_bounds(self):
        y_mid = np.array([0.5, 1.5])
        x_mid = np.array([0.5, 1.5, 2.5])
        ds = Dataset()
        ds["v"] = DataArray(
            np.arange(6.0).reshape(2, 3), dims=("y", "x")
        ).assign_coords(y=y_mid, x=x_mid)
        ds["xb"] = DataArray(
            np.column_stack([x_mid - 0.5, x_mid + 0.5]), dims=("x", "two")
        )
        ds["yb"] = DataArray(
            np.column_stack([y_mid - 0.5, y_mid + 0.5]), dims=("y", "two")
        )
        uds = xu.UgridDataset.from_structured2d(
            ds,
            topology={
                "mesh2d": {
                    "x": "x", "y": "y",
                    "bounds_x": "xb", "bounds_y": "yb",
                }
            },
        )
        assert "v" in uds.data_vars  # data was silently dropped before
        np.testing.assert_array_equal(
            np.asarray(uds["v"].values), np.arange(6.0)
        )

    def test_equidistance_check_uses_atol(self):
        from xugrid_tpu.regrid.structured import StructuredGrid1d

        da = DataArray(np.zeros(4), dims=("x",)).assign_coords(
            x=[0.0, 1000.0, 2090.0, 3090.0]  # 1000/1090/1000 spacing
        )
        with pytest.raises(ValueError, match="equidistant"):
            StructuredGrid1d(da, "x")

    def test_single_cell_axis_length(self):
        from xugrid_tpu.regrid.structured import StructuredGrid1d

        da = DataArray(np.zeros(1), dims=("y",)).assign_coords(
            y=[0.5], dy=1.0
        )
        g = StructuredGrid1d(da, "y")
        assert g.length.shape == (1,)
        np.testing.assert_allclose(g.length, [1.0])


class TestCentroidLocatorValidation:
    def test_wrong_source_size_raises(self):
        def quads(ns, dx=1.0):
            x = np.arange(ns + 1.0) * dx
            yy, xx = np.meshgrid(x, x, indexing="ij")
            verts = np.column_stack([xx.ravel(), yy.ravel()])
            j, i = np.meshgrid(np.arange(ns), np.arange(ns), indexing="ij")
            nid = lambda a, b: b * (ns + 1) + a  # noqa: E731
            return verts, np.stack(
                [nid(i, j), nid(i + 1, j), nid(i + 1, j + 1), nid(i, j + 1)],
                -1,
            ).reshape(-1, 4)

        sv, sf = quads(4)
        grid = xu.Ugrid2d(sv[:, 0], sv[:, 1], -1, sf)
        src = xu.UgridDataArray(
            DataArray(
                np.arange(16.0), dims=(grid.face_dimension,), name="v"
            ),
            grid,
        )
        tv, tf = quads(2, dx=2.0)
        target = xu.UgridDataArray.from_data(
            np.zeros(4), xu.Ugrid2d(tv[:, 0], tv[:, 1], -1, tf), facet="face"
        )
        rg = xu.CentroidLocatorRegridder(src, target)
        with pytest.raises(ValueError, match="does not match"):
            rg._regrid_array(np.arange(4.0))


class TestTopologyReviewFindings:
    def test_nan_decoded_float_connectivity_with_encoding_fill(self):
        # CF decode replaces fills with NaN and moves the sentinel to
        # encoding; from_dataset must treat NaN as fill regardless.
        from xugrid_tpu.xdata import Variable

        grid = xu.Ugrid2d(
            np.array([0.0, 1.0, 2.0, 0.0, 1.0]),
            np.array([0.0, 0.0, 0.0, 1.0, 1.0]),
            -1,
            np.array([[0, 1, 4, 3], [1, 2, 4, -1]]),
        )
        ds = grid.to_dataset()
        conn_name = "mesh2d_face_nodes"
        conn = np.asarray(ds[conn_name].data, dtype=np.float64)
        conn[conn < 0] = np.nan
        ds._variables[conn_name] = Variable(
            ds[conn_name].dims, conn, dict(ds[conn_name].attrs),
            {"_FillValue": -999.0},
        )
        back = xu.Ugrid2d.from_dataset(ds)
        assert back.n_face == 2
        np.testing.assert_array_equal(
            back.face_node_connectivity[1], [1, 2, 4, -1]
        )

    def test_ugrid1d_clip_box(self):
        net = xu.Ugrid1d(
            np.array([0.0, 1.0, 2.0, 3.0]),
            np.array([0.0, 0.0, 1.0, 1.0]),
            -1,
            np.array([[0, 1], [1, 2], [2, 3]]),
        )
        sub = net.clip_box(-0.5, -0.25, 1.2, 0.25)  # only edge 0 midpoint
        assert sub.n_edge == 1

    def test_contract_vertices_reconvergent_paths(self):
        import scipy.sparse

        from xugrid_tpu.ugrid.connectivity import contract_vertices

        # v -> a -> b, v -> c -> b, b -> k: a braided channel, valid DAG.
        v, a, b, c, k = 0, 1, 2, 3, 4
        edges = np.array([[v, a], [v, c], [a, b], [c, b], [b, k]])
        A = scipy.sparse.coo_matrix(
            (np.ones(len(edges)), (edges[:, 0], edges[:, 1])), shape=(5, 5)
        ).tocsr()
        out = contract_vertices(A, np.array([v, k]))
        assert (np.sort(out, axis=0)[:1] == [[v, k]]).all()

    def test_contract_vertices_true_cycle_raises(self):
        import scipy.sparse

        from xugrid_tpu.ugrid.connectivity import contract_vertices

        edges = np.array([[0, 1], [1, 2], [2, 0]])
        A = scipy.sparse.coo_matrix(
            (np.ones(3), (edges[:, 0], edges[:, 1])), shape=(3, 3)
        ).tocsr()
        with pytest.raises(ValueError, match="cycle"):
            contract_vertices(A, np.array([0]))


class TestAdvisorRound2Fixes:
    """Regressions for the round-2 advisor findings (ADVICE.md)."""

    def test_coarsen_adjusts_all_coords_on_dim(self):
        # A non-index coordinate over the coarsened dim must be pooled
        # too, or its length silently diverges from the dim size.
        da = DataArray(
            np.arange(12.0),
            dims=("x",),
            coords={
                "x": np.arange(12),
                "lon": ("x", np.linspace(0.0, 11.0, 12)),
            },
        )
        out = da.coarsen(x=3).mean()
        assert out.sizes["x"] == 4
        assert out.coords["lon"].shape == (4,)
        np.testing.assert_allclose(out.coords["lon"].values, [1.0, 4.0, 7.0, 10.0])

    def test_idxmax_all_nan_slice_returns_nan(self):
        da = DataArray(
            np.array([[1.0, 3.0, 2.0], [np.nan, np.nan, np.nan]]),
            dims=("r", "x"),
            coords={"x": np.array([10.0, 20.0, 30.0])},
        )
        out = da.idxmax("x")
        assert out.values[0] == 20.0
        assert np.isnan(out.values[1])
        out = da.idxmin("x")
        assert out.values[0] == 10.0
        assert np.isnan(out.values[1])

    def test_groupby_integer_sum_keeps_int_dtype(self):
        da = DataArray(
            np.array([1, 2, 3, 4], dtype=np.int64),
            dims=("x",),
            coords={"g": ("x", np.array([0, 0, 1, 1]))},
        )
        out = da.groupby("g").sum()
        assert out.dtype.kind == "i"
        np.testing.assert_array_equal(out.values, [3, 7])
        out = da.groupby("g").max()
        assert out.dtype.kind == "i"

    def test_groupby_datetime_min_reduces(self):
        times = np.array(
            ["2020-01-02", "2020-01-01", "2020-02-05", "2020-02-01"],
            dtype="datetime64[ns]",
        )
        da = DataArray(
            times,
            dims=("x",),
            coords={"g": ("x", np.array([0, 0, 1, 1]))},
        )
        out = da.groupby("g").min()
        assert out.dtype == times.dtype
        np.testing.assert_array_equal(
            out.values,
            np.array(["2020-01-01", "2020-02-01"], dtype="datetime64[ns]"),
        )

    def test_coarsen_integer_exact_keeps_int_dtype(self):
        da = DataArray(
            np.arange(6, dtype=np.int64),
            dims=("x",),
            coords={"x": np.arange(6)},
        )
        out = da.coarsen(x=2).sum()
        assert out.dtype.kind == "i"
        np.testing.assert_array_equal(out.values, [1, 5, 9])

    def test_reindex_duplicate_labels_raises(self):
        da = DataArray(
            np.arange(3.0),
            dims=("x",),
            coords={"x": np.array([1, 1, 2])},
        )
        with pytest.raises(ValueError, match="duplicate"):
            da.reindex(x=[1, 2])

    def test_reindex_exact_vectorized_matches(self):
        da = DataArray(
            np.arange(5.0),
            dims=("x",),
            coords={"x": np.array([5, 3, 1, 4, 2])},
        )
        out = da.reindex(x=[1, 2, 3, 9])
        np.testing.assert_array_equal(out.values[:3], [2.0, 4.0, 1.0])
        assert np.isnan(out.values[3])


class TestRound3ReviewFindings:
    """Pins for the round-3 diff review (kernel routing + lazy paths)."""

    def _jittered_quads(self, n=24, seed=0):
        rng = np.random.default_rng(seed)
        x = np.arange(n + 1.0)
        yy, xx = np.meshgrid(x, x, indexing="ij")
        verts = np.column_stack([xx.ravel(), yy.ravel()])
        j, i = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        nid = lambda ii, jj: jj * (n + 1) + ii  # noqa: E731
        faces = np.stack(
            [nid(i, j), nid(i + 1, j), nid(i + 1, j + 1), nid(i, j + 1)],
            axis=-1,
        ).reshape(-1, 4)
        jit = rng.uniform(-0.2, 0.2, verts.shape)
        edge = (
            (verts[:, 0] == 0) | (verts[:, 1] == 0)
            | (verts[:, 0] == n) | (verts[:, 1] == n)
        )
        jit[edge] = 0.0
        return xu.Ugrid2d(
            verts[:, 0] + jit[:, 0], verts[:, 1] + jit[:, 1], -1, faces
        )

    def test_grid_hash_excludes_nan_y_boxes(self):
        # A box with finite x but NaN y slipped past the width-only
        # finiteness check into the native binning (NaN→int cast UB).
        from xugrid_tpu.spatial.grid_hash import GridHash

        rng = np.random.default_rng(2)
        lo = rng.uniform(0, 10, (200, 2))
        boxes = np.column_stack(
            [lo[:, 0], lo[:, 1], lo[:, 0] + 0.5, lo[:, 1] + 0.5]
        )
        boxes[7, 1] = np.nan
        boxes[7, 3] = np.nan
        gh = GridHash(boxes)
        hits = gh.query_boxes(np.array([[0.0, 0.0, 10.5, 10.5]]))
        assert 7 not in set(np.asarray(hits[1]).ravel())

    def test_lazy_regrid_zero_length_leading_dim(self, tmp_path):
        # Streamed lazy regrid crashed on time=0 variables:
        # np.concatenate([]) raises on the empty block list.
        grid = self._jittered_quads(n=4, seed=3)
        target = xu.Ugrid2d(
            *_square_target_coords(4), -1, _square_target_faces(4)
        )
        reg = xu.OverlapRegridder(
            xu.UgridDataArray.from_data(
                np.zeros(grid.n_face), grid, facet="face"
            ),
            target=target,
        )

        class _FakeLazy:
            shape = (0, grid.n_face)
            dtype = np.dtype(np.float64)

            def __array__(self, dtype=None, copy=None):
                return np.zeros(self.shape)

            def __getitem__(self, key):
                return np.zeros(self.shape)[key]

        from xugrid_tpu.xdata import lazy as lazy_mod

        orig = lazy_mod.is_lazy
        lazy_mod.is_lazy = lambda x: isinstance(x, _FakeLazy) or orig(x)
        try:
            out = reg._regrid_array(_FakeLazy())
        finally:
            lazy_mod.is_lazy = orig
        assert out.shape[0] == 0


def _square_target_coords(n):
    x = np.arange(n + 1.0)
    yy, xx = np.meshgrid(x, x, indexing="ij")
    verts = np.column_stack([xx.ravel(), yy.ravel()])
    return verts[:, 0], verts[:, 1]


def _square_target_faces(n):
    j, i = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    nid = lambda ii, jj: jj * (n + 1) + ii  # noqa: E731
    return np.stack(
        [nid(i, j), nid(i + 1, j), nid(i + 1, j + 1), nid(i, j + 1)],
        axis=-1,
    ).reshape(-1, 4)


class TestDiaSelectReviewFindings:
    """Pins for the focused interpolate/select review findings."""

    def test_dia_accumulates_duplicate_coo_entries(self, monkeypatch):
        import scipy.sparse

        from xugrid_tpu.ugrid.interpolate import laplace_interpolate

        # Edge (1,2) stored as two duplicate 0.5 entries: DIA assembly
        # overwrote instead of accumulating.
        i = np.array([0, 1, 1, 1, 2, 2, 2, 3])
        j = np.array([1, 0, 2, 2, 1, 1, 3, 2])
        v = np.array([1.0, 1.0, 0.5, 0.5, 0.5, 0.5, 1.0, 1.0])
        W = scipy.sparse.csr_matrix((v, (i, j)), shape=(4, 4))
        data = np.array([10.0, np.nan, np.nan, 20.0])
        monkeypatch.setenv("XUGRID_TPU_CG_DIA", "force")
        got = laplace_interpolate(data, W, direct_solve=False, atol=1e-10)
        want = laplace_interpolate(data, W, direct_solve=True)
        np.testing.assert_allclose(got, want, rtol=1e-6)
        # maximum principle: interior stays inside the known range
        assert got.min() >= 10.0 - 1e-6 and got.max() <= 20.0 + 1e-6

    def test_dia_rtol_uses_unknown_row_norm(self, monkeypatch):
        import scipy.sparse

        from xugrid_tpu.ugrid.interpolate import laplace_interpolate

        # Large known values + small hole: the full-size ||b|| loosened
        # rtol by the known/unknown ratio (err 4.5e-3 vs COO's 6.3e-4).
        n = 60
        idx = np.arange(n * n).reshape(n, n)
        pairs = np.concatenate([
            np.column_stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()]),
            np.column_stack([idx[:-1, :].ravel(), idx[1:, :].ravel()]),
        ])
        i = np.concatenate([pairs[:, 0], pairs[:, 1]])
        j = np.concatenate([pairs[:, 1], pairs[:, 0]])
        W = scipy.sparse.csr_matrix(
            (np.ones(len(i)), (i, j)), shape=(n * n, n * n)
        )
        xs, ys = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        truth = 1000.0 + xs.ravel() * 3.0 + ys.ravel() * 5.0
        data = truth.copy()
        hole = (xs.ravel() >= 20) & (xs.ravel() < 25) \
            & (ys.ravel() >= 20) & (ys.ravel() < 25)
        data[hole] = np.nan
        monkeypatch.setenv("XUGRID_TPU_CG_DIA", "force")
        got = laplace_interpolate(
            data, W, direct_solve=False, rtol=1e-6, atol=0.0
        )
        # harmonic truth: the linear field solves Laplace exactly
        assert np.abs(got[hole] - truth[hole]).max() < 1.5e-3

    def test_select_rejects_inf_sources(self):
        # Infinite sources must not poison whole windows beyond what the
        # reference reduction itself gives: the apply path returns
        # exactly the reference reduction.
        import jax.numpy as jnp

        from xugrid_tpu.core.sparse import PaddedCSR
        from xugrid_tpu.regrid import reduce as reductions
        from xugrid_tpu.regrid.apply import apply_weights

        rng = np.random.default_rng(0)
        n, m, w = 700, 900, 5
        base = (np.arange(n) * m) // n
        indices = np.clip(
            base[:, None] + rng.integers(-5, 6, (n, w)), 0, m - 1
        ).astype(np.int32)
        weights = np.ones((n, w), np.float32)
        source = rng.normal(size=(2, m)).astype(np.float32)
        source[0, 5] = np.inf
        got = apply_weights(
            PaddedCSR(indices, weights, n, m, w), source,
            reductions.median, n,
        )
        vals = source[:, indices]
        want = np.asarray(reductions.median(
            jnp.asarray(np.moveaxis(vals, 0, 1)),
            jnp.asarray(weights[:, None, :]),
        )).T
        np.testing.assert_array_equal(got, want)
        assert np.isfinite(got[1]).all()  # the inf-free slice

    def test_select_percentile_gate_matches_reference(self):
        from xugrid_tpu.core.sparse import PaddedCSR
        from xugrid_tpu.regrid import reduce as reductions
        from xugrid_tpu.regrid.apply import apply_weights

        # One valid entry with weight 0 plus a positive weight on an
        # invalid slot: reference percentile gates on the RAW max weight
        # and returns the value; the kernel used sum(valid)>0 -> NaN.
        rng = np.random.default_rng(9)
        n, m, w = 600, 800, 4
        base = (np.arange(n) * m) // n
        indices = np.clip(
            base[:, None] + rng.integers(-4, 5, (n, w)), 0, m - 1
        ).astype(np.int32)
        weights = rng.uniform(0.5, 1.5, (n, w)).astype(np.float32)
        indices[13, 1:] = -1
        weights[13] = [0.0, 2.0, 0.0, 0.0]
        source = rng.normal(size=(2, m)).astype(np.float32)
        got = apply_weights(
            PaddedCSR(indices, weights, n, m, w), source,
            reductions.median, n,
        )
        import jax.numpy as jnp

        vals = source[:, indices]
        vals = np.where((indices < 0)[None], np.nan, vals)
        want = np.asarray(reductions.median(
            jnp.asarray(np.moveaxis(vals, 0, 1)),
            jnp.asarray(weights[:, None, :]),
        ))
        assert np.isfinite(want[13]).all()
        np.testing.assert_allclose(got, want.T, rtol=2e-5, atol=1e-5)


import contextlib


@contextlib.contextmanager
def _no_native_lib():
    """Force the numpy fallbacks regardless of library availability."""
    from xugrid_tpu.utils import native

    lib, tried = native._LIB, native._TRIED
    native._LIB, native._TRIED = None, True
    try:
        yield
    finally:
        native._LIB, native._TRIED = lib, tried


class TestNativeSpatialReviewFindings:
    """Round-3 native/spatial/lazy review sweep regressions."""

    def test_conn_clip_gate_respects_kcap(self):
        # polygon_clip_areas_conn_native gated only the tree side; a
        # >64-vertex query polygon silently truncated in sh_clip_area's
        # fixed 96-slot working buffers (wrong overlap areas) instead of
        # falling back to another path.
        from xugrid_tpu.utils.native import polygon_clip_areas_conn_native

        mq, mt = 70, 32  # mq + mt > 96: must refuse
        query_xy = np.zeros((1, mq, 2))
        tree_faces = np.zeros((1, mt), dtype=np.int64)
        out = polygon_clip_areas_conn_native(
            np.zeros(1, dtype=np.int64),
            np.zeros(1, dtype=np.int64),
            query_xy,
            tree_faces,
            np.zeros(mt),
            np.zeros(mt),
        )
        assert out is None

    def test_grid_hash_native_matches_numpy_on_boundary_boxes(self):
        # The native query passes computed cell indices with division
        # while binning used reciprocal multiplication; a 1-ulp rounding
        # difference could drop candidate pairs for zero-width boxes on
        # cell boundaries.  Pin native/numpy parity on a stress set of
        # boundary-aligned degenerate boxes.
        from xugrid_tpu.spatial.grid_hash import GridHash
        from xugrid_tpu.utils import native

        if native.get_lib() is None:
            pytest.skip("native library unavailable")
        rng = np.random.default_rng(7)
        centers = rng.uniform(0, 37.3, size=(4000, 2))
        half = rng.uniform(0.001, 0.15, size=(4000, 1))
        boxes = np.concatenate([centers - half, centers + half], axis=1)
        gh = GridHash(boxes)
        # Degenerate (zero-width) queries snapped exactly onto the cell
        # lattice, plus random thin boxes.
        kx = rng.integers(0, gh.nx, 500)
        ky = rng.integers(0, gh.ny, 500)
        gx = gh.xmin + kx * gh.dx
        gy = gh.ymin + ky * gh.dy
        degenerate = np.column_stack([gx, gy, gx, gy])
        qc = rng.uniform(0, 37.3, size=(500, 2))
        thin = np.concatenate([qc, qc + [[1e-9, 0.5]]], axis=1)
        queries = np.concatenate([degenerate, thin])

        q_nat, p_nat = gh.query_boxes(queries)
        # Force the numpy fallback through the same GridHash bins.
        with _no_native_lib():
            q_np, p_np = gh.query_boxes(queries)
        got = set(zip(q_nat.tolist(), p_nat.tolist()))
        want = set(zip(q_np.tolist(), p_np.tolist()))
        assert got == want

    def test_degenerate_tree_edge_no_false_intersection(self):
        from xugrid_tpu.spatial.celltree import _segment_intersections

        p0 = np.array([[0.0, 0.0]])
        p1 = np.array([[1.0, 0.0]])
        # Zero-length tree edge far off the query segment's line.
        q = np.array([[0.5, 5.0]])
        hit, _ = _segment_intersections(p0, p1, q, q)
        assert not hit[0]
        # Zero-length edge ON the segment: still a hit, at the point.
        q_on = np.array([[0.5, 0.0]])
        hit_on, pts = _segment_intersections(p0, p1, q_on, q_on)
        assert hit_on[0]
        np.testing.assert_allclose(pts[0], [0.5, 0.0])

    def test_lazy_zarr_big_endian_store(self, tmp_path):
        # An identity CF transform over a '>f8' store must still emit
        # native-byte-order blocks (the LazyArray dtype claims native).
        import json

        from xugrid_tpu.xdata import io_zarr
        from xugrid_tpu.xdata.lazy import LAZY_MIN_BYTES

        n = LAZY_MIN_BYTES // 8 + 16
        values = np.arange(n, dtype=">f8")
        ds = Dataset()
        ds["v"] = Variable(("x",), values.astype("=f8"))
        io_zarr.to_zarr(ds, tmp_path / "store", mode="w")
        # Rewrite the payload big-endian on disk.
        meta_path = tmp_path / "store" / "v" / ".zarray"
        meta = json.loads(meta_path.read_text())
        meta["dtype"] = ">f8"
        meta_path.write_text(json.dumps(meta))
        import zlib

        (tmp_path / "store" / "v" / "0").write_bytes(
            zlib.compress(values.tobytes(), 4)
        )
        back = io_zarr.open_zarr(tmp_path / "store", lazy=True)
        arr = back["v"].data
        assert getattr(arr, "is_lazy", False)
        block = np.asarray(arr[: 4])
        assert block.dtype.byteorder in ("=", "|", "<")
        np.testing.assert_array_equal(block, [0.0, 1.0, 2.0, 3.0])

    def test_lazy_array_out_of_bounds_raises(self):
        from xugrid_tpu.xdata.lazy import LazyArray

        raw = np.arange(100.0).reshape(100, 1)
        arr = LazyArray(lambda s, e: raw[s:e], (100, 1), np.float64)
        with pytest.raises(IndexError):
            arr[150]
        with pytest.raises(IndexError):
            arr[-150]
        np.testing.assert_array_equal(arr[-1], raw[-1])

    def test_grid_hash_inverted_finite_box(self):
        from xugrid_tpu.spatial.grid_hash import GridHash

        rng = np.random.default_rng(3)
        centers = rng.uniform(0, 10, size=(200, 2))
        boxes = np.concatenate([centers - 0.1, centers + 0.1], axis=1)
        boxes[7] = [3.0, 4.0, 2.0, 1.0]  # finite but inverted
        # Both backends: build must not crash; the inverted primitive
        # and inverted queries are dropped consistently.
        results = []
        for use_native in (True, False):
            ctx = (
                contextlib.nullcontext() if use_native else _no_native_lib()
            )
            with ctx:
                gh = GridHash(boxes)
                q, p = gh.query_boxes(boxes)
            assert 7 not in set(p.tolist())
            assert 7 not in set(q.tolist())
            results.append(set(zip(q.tolist(), p.tolist())))
        assert results[0] == results[1]

    def test_oversize_hits_chunked_parity(self, monkeypatch):
        from xugrid_tpu.spatial import grid_hash as gh_mod
        from xugrid_tpu.spatial.grid_hash import GridHash

        rng = np.random.default_rng(11)
        centers = rng.uniform(0, 10, size=(400, 2))
        half = np.full((400, 1), 0.05)
        # Make 2 primitives (0.5% < p99) huge -> oversize list.
        half[::200] = 4.0
        boxes = np.concatenate([centers - half, centers + half], axis=1)
        gh = GridHash(boxes)
        assert len(gh.oversize) > 0
        queries = np.concatenate(
            [centers - 0.01, centers + 0.01], axis=1
        )
        q1, p1 = gh.query_boxes(queries)
        monkeypatch.setattr(gh_mod, "OVERSIZE_CHUNK_ELEMS", 64)
        q2, p2 = gh.query_boxes(queries)
        assert set(zip(q1.tolist(), p1.tolist())) == set(
            zip(q2.tolist(), p2.tolist())
        )


class TestXdataReviewRound3:
    """Regressions from the round-3 xdata review sweep (10 confirmed
    findings: silent corruption in unstack/groupby/isel, crashes in
    where/dropna/sel, dtype handling in notnull/first/to_zarr, and
    resample bin alignment)."""

    def test_unstack_after_reorder_scatters(self):
        from xugrid_tpu.xdata import DataArray

        da = DataArray(
            np.arange(6.0).reshape(2, 3), dims=("x", "y"),
            coords={"x": [10, 20], "y": [1, 2, 3]},
        )
        s = da.stack(z=("x", "y")).assign_coords(
            lev=("z", [5, 3, 1, 0, 2, 4])
        ).sortby("lev")
        u = s.unstack("z").transpose("x", "y")
        np.testing.assert_array_equal(u.values, da.values)
        np.testing.assert_array_equal(
            np.asarray(u.coords["y"].data), [1, 2, 3]
        )

    def test_groupby_reduce_honors_dim(self):
        from xugrid_tpu.xdata import DataArray

        da = DataArray(
            np.arange(12.0).reshape(4, 3), dims=("t", "y"),
            coords={"t": [0, 1, 2, 3], "g": ("t", ["a", "a", "b", "b"]),
                    "y": [10, 20, 30]},
        )
        out = da.groupby("g").mean("y")
        assert out.dims == ("t",)
        np.testing.assert_allclose(out.values, da.values.mean(axis=1))
        out_all = da.groupby("g").mean(...)
        assert out_all.dims == ("g",)
        np.testing.assert_allclose(
            out_all.values, [da.values[:2].mean(), da.values[2:].mean()]
        )

    def test_groupby_transform_restores_order(self):
        from xugrid_tpu.xdata import DataArray

        da = DataArray(
            np.arange(8.0).reshape(4, 2), dims=("t", "y"),
            coords={"t": [0, 1, 2, 3], "g": ("t", ["b", "a", "b", "a"])},
        )
        tr = da.groupby("g").mean("y")
        np.testing.assert_allclose(tr.values, da.values.mean(axis=1))
        np.testing.assert_array_equal(
            np.asarray(tr.coords["t"].data), [0, 1, 2, 3]
        )

    def test_pointwise_isel(self):
        from xugrid_tpu.xdata import DataArray

        da = DataArray(
            np.arange(12.0).reshape(3, 4), dims=("x", "y"),
            coords={"x": [10, 20, 30], "y": [1, 2, 3, 4]},
        )
        ix = DataArray([0, 1, 2], dims="pts")
        iy = DataArray([0, 1, 2], dims="pts")
        out = da.isel(x=ix, y=iy)
        assert out.dims == ("pts",)
        np.testing.assert_allclose(out.values, [0.0, 5.0, 10.0])
        np.testing.assert_array_equal(
            np.asarray(out.coords["x"].data), [10, 20, 30]
        )
        out2 = da.isel(
            x=DataArray([0, 2], dims="a"), y=DataArray([1, 3], dims="b")
        )
        assert out2.dims == ("a", "b")
        np.testing.assert_allclose(out2.values, [[1, 3], [9, 11]])

    def test_where_drop_with_array_other(self):
        from xugrid_tpu.xdata import DataArray

        da = DataArray(
            np.arange(5.0), dims=("x",), coords={"x": np.arange(5)}
        )
        other = DataArray(
            -np.arange(5.0), dims=("x",), coords={"x": np.arange(5)}
        )
        out = da.where(da > 1.5, other, drop=True)
        np.testing.assert_allclose(out.values, [2.0, 3.0, 4.0])

    def test_dropna_with_string_variable(self):
        from xugrid_tpu.xdata import Dataset

        ds = Dataset({
            "a": ("x", [1.0, np.nan, 3.0]),
            "lab": ("x", np.array(["p", "q", "r"])),
        })
        out = ds.dropna("x")
        np.testing.assert_allclose(np.asarray(out["a"].data), [1.0, 3.0])
        assert np.asarray(out["lab"].data).tolist() == ["p", "r"]

    def test_sel_slice_plus_level(self):
        from xugrid_tpu.xdata import DataArray

        da = DataArray(
            np.arange(6.0), dims=("z",),
            coords={"z": np.arange(6),
                    "lev": ("z", ["a", "b", "a", "b", "a", "b"])},
        )
        out = da.sel(z=slice(0, 4), lev="a")
        np.testing.assert_allclose(out.values, [0.0, 2.0, 4.0])

    def test_notnull_nat(self):
        from xugrid_tpu.xdata import DataArray

        t = np.array(["2020-01-01", "NaT"], dtype="datetime64[ns]")
        da = DataArray(t, dims=("x",))
        np.testing.assert_array_equal(da.notnull().values, [True, False])
        assert int(da.count().values) == 1

    def test_groupby_first_keeps_datetime(self):
        from xugrid_tpu.xdata import DataArray

        t = np.array(
            ["2020-01-01", "2020-03-01", "2020-02-01"],
            dtype="datetime64[ns]",
        )
        da = DataArray(t, dims=("t",),
                       coords={"t": [0, 1, 2], "g": ("t", [0, 0, 1])})
        f = da.groupby("g").first()
        assert f.dtype.kind == "M"
        assert f.values[0] == np.datetime64("2020-01-01")

    def test_resample_emits_empty_bins(self):
        from xugrid_tpu.xdata import DataArray

        t = np.array(["2020-01-01", "2020-01-02", "2020-01-05"],
                     dtype="datetime64[ns]")
        da = DataArray([1.0, 2.0, 4.0], dims=("time",),
                       coords={"time": t})
        r = da.resample(time="1D").mean()
        assert r.sizes["time"] == 5
        assert np.isnan(r.values[2]) and np.isnan(r.values[3])
        c = da.resample(time="1D").count()
        np.testing.assert_array_equal(c.values, [1, 1, 0, 0, 1])

    def test_to_zarr_unicode_strings(self, tmp_path):
        from xugrid_tpu.xdata import Dataset, open_zarr
        from xugrid_tpu.xdata.io_zarr import to_zarr

        ds = Dataset({"s": ("x", np.array(["héllo", "wörld"]))})
        p = str(tmp_path / "t.zarr")
        to_zarr(ds, p)
        back = open_zarr(p)
        vals = [
            v.decode("utf-8") if isinstance(v, bytes) else str(v)
            for v in np.asarray(back["s"].data).tolist()
        ]
        assert vals == ["héllo", "wörld"]

    def test_reindex_nearest_tie_goes_high(self):
        from xugrid_tpu.xdata import DataArray

        da = DataArray([1.0, 2.0], dims=("x",), coords={"x": [0.0, 2.0]})
        out = da.reindex(x=[1.0], method="nearest")
        # pandas breaks exact-distance ties toward the higher label
        np.testing.assert_allclose(out.values, [2.0])

    def test_dataset_reduce_keeps_scalar_coords(self):
        from xugrid_tpu.xdata import Dataset

        ds = Dataset({"a": ("x", [1.0, 2.0])})
        ds = ds.assign_coords(tag=((), 7))
        out = ds.mean()
        assert "tag" in out.coords
