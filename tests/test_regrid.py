"""Regridding subsystem tests."""

import numpy as np
import pytest

import xugrid_tpu as xu
from xugrid_tpu import xdata
from xugrid_tpu.regrid import (
    BarycentricInterpolator,
    CentroidLocatorRegridder,
    NetworkGridder,
    OverlapRegridder,
    RelativeOverlapRegridder,
    StructuredGrid1d,
    StructuredGrid2d,
)
from xugrid_tpu.regrid.overlap_1d import overlap_1d
from xugrid_tpu.regrid import reduce as xreduce


def quad_uda(nx, ny, dx=1.0, x0=0.0, y0=0.0, values=None, name="v"):
    x = x0 + np.arange(nx + 1.0) * dx
    y = y0 + np.arange(ny + 1.0) * dx
    yy, xx = np.meshgrid(y, x, indexing="ij")
    verts = np.column_stack([xx.ravel(), yy.ravel()])

    def nid(i, j):
        return j * (nx + 1) + i

    faces = np.array(
        [
            [nid(i, j), nid(i + 1, j), nid(i + 1, j + 1), nid(i, j + 1)]
            for j in range(ny)
            for i in range(nx)
        ]
    )
    grid = xu.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)
    if values is None:
        values = np.arange(grid.n_face, dtype=float)
    da = xdata.DataArray(values, dims=(grid.face_dimension,), name=name)
    return xu.UgridDataArray(da, grid)


def structured_da(nx, ny, dx=1.0, x0=0.0, y0=0.0, values=None):
    x = x0 + (np.arange(nx) + 0.5) * dx
    y = y0 + (np.arange(ny) + 0.5) * dx
    if values is None:
        values = np.zeros((ny, nx))
    return xdata.DataArray(
        values, coords={"y": y, "x": x}, dims=("y", "x"), name="v"
    )


class TestOverlap1d:
    def test_basic(self):
        source = np.column_stack([np.arange(4.0), np.arange(1.0, 5.0)])
        target = np.array([[0.5, 2.5]])
        s, t, w = overlap_1d(source, target)
        assert np.array_equal(s, [0, 1, 2])
        assert (t == 0).all()
        assert np.allclose(w, [0.5, 1.0, 0.5])

    def test_no_overlap(self):
        source = np.array([[0.0, 1.0]])
        target = np.array([[2.0, 3.0]])
        s, t, w = overlap_1d(source, target)
        assert len(s) == 0

    def test_nan_bounds(self):
        source = np.array([[0.0, 1.0], [np.nan, np.nan], [1.0, 2.0]])
        target = np.array([[0.5, 1.5]])
        s, t, w = overlap_1d(source, target)
        assert np.array_equal(s, [0, 2])
        assert np.allclose(w, [0.5, 0.5])


class TestReductions:
    """Reduction kernels on hand-computed windows."""

    V = np.array([[1.0, 2.0, 3.0, np.nan]])
    W = np.array([[0.5, 0.3, 0.2, 0.0]])

    def run(self, name, v=None, w=None):
        import jax.numpy as jnp

        f = xreduce.ABSOLUTE_OVERLAP_METHODS.get(name) or getattr(xreduce, name)
        v = self.V if v is None else np.atleast_2d(v)
        w = self.W if w is None else np.atleast_2d(w)
        return float(np.asarray(f(jnp.asarray(v), jnp.asarray(w)))[0])

    def test_mean(self):
        assert np.isclose(self.run("mean"), (0.5 + 0.6 + 0.6) / 1.0)

    def test_sum(self):
        assert np.isclose(self.run("sum"), 6.0)

    def test_minimum_maximum(self):
        assert self.run("minimum") == 1.0
        assert self.run("maximum") == 3.0

    def test_harmonic_mean(self):
        expected = 1.0 / (0.5 / 1.0 + 0.3 / 2.0 + 0.2 / 3.0)
        assert np.isclose(self.run("harmonic_mean"), expected)

    def test_geometric_mean(self):
        expected = np.exp(
            0.5 * np.log(1) + 0.3 * np.log(2) + 0.2 * np.log(3)
        )
        assert np.isclose(self.run("geometric_mean"), expected)

    def test_geometric_mean_negative(self):
        assert np.isnan(self.run("geometric_mean", v=[1.0, -2.0], w=[0.5, 0.5]))

    def test_median(self):
        assert self.run("median", v=[1.0, 2.0, 3.0], w=[1, 1, 1]) == 2.0
        assert self.run("median", v=[1.0, 2.0, 3.0, 4.0], w=[1, 1, 1, 1]) == 2.5

    def test_percentiles(self):
        assert self.run("p5", v=[1.0, 2.0, 3.0], w=[1, 1, 1]) <= 1.2
        assert self.run("p95", v=[1.0, 2.0, 3.0], w=[1, 1, 1]) >= 2.8

    def test_mode(self):
        assert self.run("mode", v=[1.0, 1.0, 3.0], w=[1, 1, 1.5]) == 1.0
        # tie -> larger value
        assert self.run("mode", v=[1.0, 3.0], w=[1, 1]) == 3.0

    def test_max_overlap(self):
        assert self.run("max_overlap", v=[1.0, 5.0], w=[2.0, 1.0]) == 1.0

    def test_all_nan(self):
        assert np.isnan(self.run("mean", v=[np.nan, np.nan], w=[1, 1]))

    def test_zero_weights(self):
        assert np.isnan(self.run("mean", v=[1.0, 2.0], w=[0, 0]))
        assert np.isnan(self.run("minimum", v=[1.0, 2.0], w=[0, 0]))

    def test_first_order_conservative(self):
        import jax.numpy as jnp

        f = xreduce.RELATIVE_OVERLAP_METHODS["first_order_conservative"]
        out = float(
            np.asarray(f(jnp.asarray([[2.0, 4.0]]), jnp.asarray([[0.25, 0.5]])))[0]
        )
        assert np.isclose(out, 2.0 * 0.25 + 4.0 * 0.5)


class TestOverlapRegridder:
    def test_mean_coarsen(self):
        # 4x4 -> 2x2 aligned coarsening: mean of each 2x2 block
        source = quad_uda(4, 4)
        target = quad_uda(2, 2, dx=2.0)
        regridder = OverlapRegridder(source, target, method="mean")
        out = regridder.regrid(source)
        assert isinstance(out, xu.UgridDataArray)
        values = np.asarray(out.values)
        v = np.arange(16.0).reshape(4, 4)
        expected = v.reshape(2, 2, 2, 2).mean(axis=(1, 3))
        assert np.allclose(np.sort(values), np.sort(expected.ravel()))

    def test_sum_conservation(self):
        source = quad_uda(4, 4, values=np.random.default_rng(0).uniform(1, 2, 16))
        target = quad_uda(2, 2, dx=2.0)
        regridder = OverlapRegridder(source, target, method="sum")
        out = regridder.regrid(source)
        assert np.isclose(
            np.asarray(out.values).sum(), np.asarray(source.values).sum()
        )

    def test_methods_run(self):
        source = quad_uda(4, 4)
        target = quad_uda(2, 2, dx=2.0)
        for method in ("median", "mode", "minimum", "maximum", "p25", "max_overlap"):
            regridder = OverlapRegridder(source, target, method=method)
            out = regridder.regrid(source)
            assert not np.isnan(np.asarray(out.values)).any()

    def test_custom_method(self):
        import jax.numpy as jnp

        def spread(values, weights):
            valid = ~jnp.isnan(values)
            vmax = jnp.max(jnp.where(valid, values, -jnp.inf), axis=-1)
            vmin = jnp.min(jnp.where(valid, values, jnp.inf), axis=-1)
            return vmax - vmin

        source = quad_uda(4, 4)
        target = quad_uda(2, 2, dx=2.0)
        regridder = OverlapRegridder(source, target, method=spread)
        out = regridder.regrid(source)
        assert np.allclose(np.asarray(out.values), 5.0)

    def test_extra_dims(self):
        source = quad_uda(4, 4)
        data = np.stack([np.arange(16.0), np.arange(16.0) * 2])
        da = xdata.DataArray(
            data,
            dims=("time", source.grid.face_dimension),
            coords={"time": [0, 1]},
            name="v",
        )
        uda = xu.UgridDataArray(da, source.grid)
        target = quad_uda(2, 2, dx=2.0)
        regridder = OverlapRegridder(source, target, method="mean")
        out = regridder.regrid(uda)
        assert out.obj.dims == ("time", target.grid.face_dimension)
        values = np.asarray(out.values)
        assert np.allclose(values[1], values[0] * 2)

    def test_structured_target(self):
        source = quad_uda(4, 4)
        target = structured_da(2, 2, dx=2.0)
        regridder = OverlapRegridder(source, target, method="mean")
        out = regridder.regrid(source)
        assert isinstance(out, xdata.DataArray)
        assert out.dims == ("y", "x")

    def test_structured_source(self):
        values = np.arange(16.0).reshape(4, 4)
        source = structured_da(4, 4, values=values)
        target = quad_uda(2, 2, dx=2.0)
        regridder = OverlapRegridder(source, target, method="mean")
        out = regridder.regrid(source)
        expected = values.reshape(2, 2, 2, 2).mean(axis=(1, 3))
        assert np.allclose(
            np.sort(np.asarray(out.values)), np.sort(expected.ravel())
        )

    def test_weights_roundtrip(self, tmp_path):
        source = quad_uda(4, 4)
        target = quad_uda(2, 2, dx=2.0)
        regridder = OverlapRegridder(source, target, method="mean")
        expected = np.asarray(regridder.regrid(source).values)

        weights = regridder.weights
        path = tmp_path / "weights.nc"
        weights.to_netcdf(path)
        back = xdata.open_dataset(path)
        restored = OverlapRegridder.from_weights(back, target, method="mean")
        result = np.asarray(restored.regrid(source).values)
        assert np.allclose(result, expected)

    def test_weights_as_dataframe(self):
        source = quad_uda(2, 2)
        target = quad_uda(1, 1, dx=2.0)
        regridder = OverlapRegridder(source, target)
        df = regridder.weights_as_dataframe()
        assert set(df.columns) == {"target_index", "source_index", "weight"}
        assert np.isclose(df["weight"].sum(), 4.0)


class TestRelativeOverlapRegridder:
    def test_first_order_conservative(self):
        rng = np.random.default_rng(1)
        source = quad_uda(4, 4, values=rng.uniform(0, 10, 16))
        target = quad_uda(2, 2, dx=2.0)
        regridder = RelativeOverlapRegridder(source, target)
        out = regridder.regrid(source)
        # With source-relative weights, each fully covered source cell
        # contributes its value exactly once across all targets:
        # sum(out) == sum(source).
        assert np.isclose(
            np.asarray(out.values).sum(), np.asarray(source.values).sum()
        )


class TestCentroidLocatorRegridder:
    def test_refine(self):
        source = quad_uda(2, 2, dx=2.0)
        target = quad_uda(4, 4)
        regridder = CentroidLocatorRegridder(source, target)
        out = regridder.regrid(source)
        values = np.asarray(out.values).reshape(4, 4)
        expected = np.repeat(np.repeat(np.arange(4.0).reshape(2, 2), 2, 0), 2, 1)
        assert np.allclose(values, expected)

    def test_out_of_bounds_nan(self):
        source = quad_uda(2, 2)
        target = quad_uda(2, 2, x0=10.0)
        regridder = CentroidLocatorRegridder(source, target)
        out = regridder.regrid(source)
        assert np.isnan(np.asarray(out.values)).all()


class TestBarycentricInterpolator:
    def test_linear_precision(self):
        # Linear field interpolated at fine-target centroids: barycentric
        # interpolation over voronoi is exact for linear functions in the
        # interior.
        def f(c):
            return 2.0 * c[:, 0] + 3.0 * c[:, 1] + 1.0

        source = quad_uda(8, 8, values=None)
        source = quad_uda(8, 8, values=f(source.grid.centroids))
        target = quad_uda(12, 12, dx=0.5, x0=1.0, y0=1.0)
        regridder = BarycentricInterpolator(source, target)
        out = regridder.regrid(source)
        values = np.asarray(out.values)
        expected = f(target.grid.centroids)
        # interior faces only (away from source exterior)
        interior = (
            (target.grid.centroids[:, 0] > 2)
            & (target.grid.centroids[:, 0] < 6)
            & (target.grid.centroids[:, 1] > 2)
            & (target.grid.centroids[:, 1] < 6)
        )
        assert np.allclose(values[interior], expected[interior], atol=1e-8)

    def test_structured_source_bilinear(self):
        values = np.add.outer(np.arange(4.0), np.arange(4.0) * 2)
        source = structured_da(4, 4, values=values)
        target = quad_uda(6, 6, dx=0.5, x0=0.5, y0=0.5)
        regridder = BarycentricInterpolator(source, target)
        out = regridder.regrid(source)
        cx = target.grid.centroids[:, 0]
        cy = target.grid.centroids[:, 1]
        expected = (cy - 0.5) + 2 * (cx - 0.5)
        assert np.allclose(np.asarray(out.values), expected, atol=1e-8)


class TestStructuredToStructured:
    def test_overlap_mean(self):
        values = np.arange(16.0).reshape(4, 4)
        source = structured_da(4, 4, values=values)
        target = structured_da(2, 2, dx=2.0)
        regridder = OverlapRegridder(source, target, method="mean")
        out = regridder.regrid(source)
        expected = values.reshape(2, 2, 2, 2).mean(axis=(1, 3))
        assert np.allclose(np.asarray(out.data), expected)

    def test_decreasing_y(self):
        values = np.arange(16.0).reshape(4, 4)
        y = (np.arange(4)[::-1] + 0.5) * 1.0
        x = (np.arange(4) + 0.5) * 1.0
        source = xdata.DataArray(
            values, coords={"y": y, "x": x}, dims=("y", "x"), name="v"
        )
        target = structured_da(2, 2, dx=2.0)
        regridder = OverlapRegridder(source, target, method="mean")
        out = regridder.regrid(source)
        # rows of source are ordered y=3.5..0.5; target y=0.5, 1.5 ascending
        expected = values[::-1].reshape(2, 2, 2, 2).mean(axis=(1, 3))
        assert np.allclose(np.asarray(out.data), expected)


class TestNetworkGridder:
    def test_intersection_mean(self):
        # horizontal line through a 4x4 grid at y = 1.5, edge values 1..
        network = xu.Ugrid1d(
            np.array([0.0, 2.0, 4.0]),
            np.array([1.5, 1.5, 1.5]),
            -1,
            np.array([[0, 1], [1, 2]]),
        )
        uda = xu.UgridDataArray(
            xdata.DataArray(
                np.array([10.0, 20.0]), dims=(network.edge_dimension,), name="q"
            ),
            network,
        )
        target = quad_uda(4, 4)
        gridder = NetworkGridder(network, target.grid, method="mean")
        out = gridder.regrid(uda)
        values = np.asarray(out.values).reshape(4, 4)
        # row j=1 (y in [1, 2]) is crossed; first two columns edge 0, rest edge 1
        assert np.allclose(values[1], [10.0, 10.0, 20.0, 20.0])
        assert np.isnan(values[0]).all()
        assert np.isnan(values[2:]).all()


class TestReductionsRandomized:
    """Property checks against numpy semantics on random windows."""

    def _case(self, seed):
        rng = np.random.default_rng(seed)
        n, w = 64, 7
        values = rng.normal(size=(n, w))
        values[rng.random((n, w)) < 0.2] = np.nan
        weights = rng.uniform(0.1, 2.0, (n, w))
        weights[rng.random((n, w)) < 0.2] = 0.0
        return values, weights

    def _masked(self, values, weights):
        # mean weights by w; the unweighted reductions (min/max/sum/
        # median/percentile) include every finite value - zero weights
        # only occur as padding, which the apply path NaN-masks upstream.
        return np.isfinite(values)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_mean_matches_numpy(self, seed):
        values, weights = self._case(seed)
        out = np.asarray(xreduce.mean(values, weights))
        mask = np.isfinite(values) & (weights > 0)
        for i in range(len(values)):
            if mask[i].any():
                expected = np.average(
                    values[i][mask[i]], weights=weights[i][mask[i]]
                )
                assert np.isclose(out[i], expected)
            else:
                assert np.isnan(out[i])

    @pytest.mark.parametrize("seed", [0, 1])
    def test_minmax_match_numpy(self, seed):
        values, weights = self._case(seed)
        mask = self._masked(values, weights)
        mn = np.asarray(xreduce.minimum(values, weights))
        mx = np.asarray(xreduce.maximum(values, weights))
        for i in range(len(values)):
            if mask[i].any():
                assert np.isclose(mn[i], values[i][mask[i]].min())
                assert np.isclose(mx[i], values[i][mask[i]].max())

    @pytest.mark.parametrize("seed", [0, 1])
    def test_sum_matches_numpy(self, seed):
        values, weights = self._case(seed)
        mask = self._masked(values, weights)
        out = np.asarray(xreduce.sum(values, weights))
        for i in range(len(values)):
            if mask[i].any():
                assert np.isclose(out[i], values[i][mask[i]].sum())

    @pytest.mark.parametrize("seed", [0, 1])
    def test_median_matches_numpy(self, seed):
        values, weights = self._case(seed)
        mask = self._masked(values, weights)
        out = np.asarray(xreduce.median(values, weights))
        for i in range(len(values)):
            if mask[i].any():
                assert np.isclose(out[i], np.median(values[i][mask[i]]))

    @pytest.mark.parametrize("p", [5, 25, 75, 95])
    def test_percentiles_match_numpy(self, p):
        values, weights = self._case(3)
        mask = self._masked(values, weights)
        method = xreduce.create_percentile_method(p)
        out = np.asarray(method(values, weights))
        for i in range(len(values)):
            if mask[i].any():
                assert np.isclose(
                    out[i], np.percentile(values[i][mask[i]], p)
                )

    def test_mode_picks_most_frequent(self):
        values = np.array([[1.0, 2.0, 2.0, 3.0, np.nan]])
        weights = np.ones((1, 5))
        out = np.asarray(xreduce.mode(values, weights))
        assert out[0] == 2.0

    def test_max_overlap_picks_heaviest(self):
        values = np.array([[1.0, 2.0, 3.0]])
        weights = np.array([[0.2, 5.0, 0.3]])
        out = np.asarray(xreduce.max_overlap(values, weights))
        assert out[0] == 2.0


class TestFromDatasetRoundTrip:
    """from_dataset reconstructs both topology kinds (the reference
    raises UnboundLocalError on structured targets,
    xugrid/regrid/regridder.py:334-361)."""

    def _roundtrip(self, source, target, tmp_path):
        regridder = OverlapRegridder(source, target, method="mean")
        expected = regridder.regrid(source)
        path = tmp_path / "weights.nc"
        regridder.to_dataset().to_netcdf(path)
        back = xdata.open_dataset(path)
        restored = OverlapRegridder.from_dataset(back)
        result = restored.regrid(source)
        return expected, result

    def test_structured_target(self, tmp_path):
        source = quad_uda(4, 4, values=np.arange(16.0))
        target = structured_da(2, 2, dx=2.0)
        expected, result = self._roundtrip(source, target, tmp_path)
        np.testing.assert_allclose(
            np.asarray(result.data), np.asarray(expected.data)
        )
        # user-facing coordinate names survive the round trip
        assert set(expected.dims) == set(result.dims)
        assert "y" in result.dims and "x" in result.dims

    def test_unstructured_target(self, tmp_path):
        source = structured_da(4, 4, values=np.arange(16.0).reshape(4, 4))
        target = quad_uda(2, 2, dx=2.0)
        expected, result = self._roundtrip(source, target, tmp_path)
        np.testing.assert_allclose(
            np.asarray(result.values), np.asarray(expected.values)
        )

    def test_structured_source_and_target(self, tmp_path):
        source = structured_da(4, 4, values=np.arange(16.0).reshape(4, 4))
        target = structured_da(2, 2, dx=2.0)
        expected, result = self._roundtrip(source, target, tmp_path)
        np.testing.assert_allclose(
            np.asarray(result.data), np.asarray(expected.data)
        )
        assert "y" in result.dims and "x" in result.dims


class TestChunkedApply:
    """Out-of-core chunking over extra dims (the dask map_blocks analog,
    reference regridder.py:167-186): results identical to one-shot."""

    def test_chunked_matches_unchunked(self, monkeypatch):
        rng = np.random.default_rng(4)
        values = rng.normal(size=(7, 16))
        values[:, ::5] = np.nan
        source = quad_uda(4, 4, values=None)
        grid = source.ugrid.grid
        src = xu.UgridDataArray(
            xdata.DataArray(
                values, dims=("time", grid.face_dimension), name="v"
            ),
            grid,
        )
        target = quad_uda(2, 2, dx=2.0)
        rg = OverlapRegridder(src, target, method="mean")
        expected = np.asarray(rg.regrid(src).values)
        # Budget of one source+target slice -> row-by-row chunks.
        monkeypatch.setenv(
            "XUGRID_TPU_APPLY_CHUNK_BYTES", str(4 * (16 + 4) + 1)
        )
        chunked = np.asarray(rg.regrid(src).values)
        np.testing.assert_allclose(chunked, expected, equal_nan=True)

    def test_chunked_3d_stack(self, monkeypatch):
        rng = np.random.default_rng(6)
        source = quad_uda(4, 4)
        grid = source.ugrid.grid
        src = xu.UgridDataArray(
            xdata.DataArray(
                rng.normal(size=(3, 2, 16)),
                dims=("time", "layer", grid.face_dimension),
                name="v",
            ),
            grid,
        )
        target = quad_uda(2, 2, dx=2.0)
        rg = OverlapRegridder(src, target, method="sum")
        expected = np.asarray(rg.regrid(src).values)
        monkeypatch.setenv("XUGRID_TPU_APPLY_CHUNK_BYTES", "200")
        chunked = np.asarray(rg.regrid(src).values)
        assert chunked.shape == (3, 2, 4)
        np.testing.assert_allclose(chunked, expected, equal_nan=True)
