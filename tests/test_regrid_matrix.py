"""
Regridder parametrization matrix: every regridder class over every
structured/unstructured source-target combination, with NaN-bearing
sources and weight-dataset round trips (reference:
tests/test_regrid/test_regridder.py:16-405 parametrizes the same grid
combinations over all four regridder classes).
"""

import numpy as np
import pytest

import xugrid_tpu as xu
from xugrid_tpu import xdata
from xugrid_tpu.xdata import DataArray


NX = 6  # source cells per side; domain is [0, 6] x [0, 6]


def unstructured_uda(nx=NX, dx=1.0, x0=0.0, values=None):
    x = np.arange(nx + 1.0) * dx + x0
    yy, xx = np.meshgrid(x, x, indexing="ij")
    verts = np.column_stack([xx.ravel(), yy.ravel()])
    j, i = np.meshgrid(np.arange(nx), np.arange(nx), indexing="ij")
    nid = lambda ii, jj: jj * (nx + 1) + ii  # noqa: E731
    faces = np.stack(
        [nid(i, j), nid(i + 1, j), nid(i + 1, j + 1), nid(i, j + 1)], axis=-1
    ).reshape(-1, 4)
    grid = xu.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)
    if values is None:
        values = field_at(grid.centroids[:, 0], grid.centroids[:, 1])
    return xu.UgridDataArray(
        DataArray(values, dims=(grid.face_dimension,), name="v"), grid
    )


def structured_da(nx=NX, dx=1.0, x0=0.0, values=None):
    x = (np.arange(nx) + 0.5) * dx + x0
    if values is None:
        yy, xx = np.meshgrid(x, x, indexing="ij")
        values = field_at(xx, yy)
    da = DataArray(values, dims=("y", "x"), name="v")
    return da.assign_coords(y=x, x=x)


def field_at(x, y):
    """A linear field: exact for barycentric, analytic for means."""
    return 2.0 * np.asarray(x) + 3.0 * np.asarray(y) + 1.0


def output_values(out):
    if isinstance(out, xu.UgridDataArray):
        return np.asarray(out.values).ravel()
    return np.asarray(out.data).ravel()


def target_centroids(target):
    if isinstance(target, xu.UgridDataArray):
        c = target.ugrid.grid.centroids
        return c[:, 0], c[:, 1]
    x = np.asarray(target["x"].data)
    y = np.asarray(target["y"].data)
    yy, xx = np.meshgrid(y, x, indexing="ij")
    return xx.ravel(), yy.ravel()


GRID_KINDS = ["unstructured", "structured"]


def make(kind, **kw):
    return unstructured_uda(**kw) if kind == "unstructured" else structured_da(**kw)


@pytest.fixture(params=GRID_KINDS)
def source_kind(request):
    return request.param


@pytest.fixture(params=GRID_KINDS)
def target_kind(request):
    return request.param


class TestAllCombinations:
    def test_overlap_mean_linear_field(self, source_kind, target_kind):
        # Interior target cells of a coarser grid: the area-weighted mean
        # of a linear field equals the field at the target centroid.
        source = make(source_kind)
        target = make(target_kind, nx=3, dx=2.0)
        rg = xu.OverlapRegridder(source, target, method="mean")
        out = output_values(rg.regrid(source))
        tx, ty = target_centroids(target)
        np.testing.assert_allclose(out, field_at(tx, ty), rtol=1e-12)

    def test_relative_overlap_conservative(self, source_kind, target_kind):
        # first_order_conservative conserves the integral: a constant-1
        # source regridded to 2x2-cell targets yields 4 (source cells
        # fully covered) per target, 36 in total.
        if source_kind == "unstructured":
            src = unstructured_uda(values=np.ones(NX * NX))
        else:
            src = structured_da(values=np.ones((NX, NX)))
        target = make(target_kind, nx=3, dx=2.0)
        rg = xu.RelativeOverlapRegridder(
            src, target, method="first_order_conservative"
        )
        out = output_values(rg.regrid(src))
        np.testing.assert_allclose(out, 4.0, rtol=1e-12)
        np.testing.assert_allclose(out.sum(), NX * NX, rtol=1e-12)

    def test_centroid_locator(self, source_kind, target_kind):
        # Fine targets inside coarse sources: pure value gather.
        source = make(source_kind, nx=3, dx=2.0)
        target = make(target_kind, nx=6, dx=0.5, x0=1.0)
        rg = xu.CentroidLocatorRegridder(source, target)
        out = output_values(rg.regrid(source))
        tx, ty = target_centroids(target)
        # Source cell centers: ((2i+1), (2j+1)) for i,j in 0..2.
        sx = 2.0 * np.floor(tx / 2.0) + 1.0
        sy = 2.0 * np.floor(ty / 2.0) + 1.0
        np.testing.assert_allclose(out, field_at(sx, sy), rtol=1e-12)

    def test_barycentric_linear_exact(self, source_kind, target_kind):
        # Barycentric/bilinear interpolation reproduces a linear field
        # exactly in the interior.
        source = make(source_kind)
        target = make(target_kind, nx=4, dx=0.75, x0=1.6)
        rg = xu.BarycentricInterpolator(source, target)
        out = output_values(rg.regrid(source))
        tx, ty = target_centroids(target)
        expected = field_at(tx, ty)
        inside = (
            (tx > 1.0) & (tx < 5.0) & (ty > 1.0) & (ty < 5.0)
        )
        np.testing.assert_allclose(
            out[inside], expected[inside], rtol=1e-10
        )

    @pytest.mark.parametrize(
        "method", ["mean", "sum", "minimum", "maximum", "median", "mode"]
    )
    def test_overlap_methods_with_nan_source(
        self, source_kind, target_kind, method
    ):
        # NaN sources: reductions skip NaNs; all-NaN windows yield NaN.
        rng = np.random.default_rng(5)
        mids = np.arange(NX) + 0.5
        yy, xx = np.meshgrid(mids, mids, indexing="ij")
        vals = field_at(xx, yy)  # (y, x) layout
        vals[rng.random(vals.shape) < 0.3] = np.nan
        if source_kind == "unstructured":
            src = unstructured_uda(values=vals.ravel())
        else:
            src = structured_da(values=vals)
        target = make(target_kind, nx=2, dx=3.0)
        rg = xu.OverlapRegridder(src, target, method=method)
        out = output_values(rg.regrid(src))
        assert out.shape == (4,)
        # Each 3x3 target block still has non-NaN sources at 30% drop.
        assert np.isfinite(out).all()

    def test_weights_roundtrip_from_dataset(
        self, source_kind, target_kind, tmp_path
    ):
        source = make(source_kind)
        target = make(target_kind, nx=3, dx=2.0)
        rg = xu.OverlapRegridder(source, target, method="mean")
        expected = output_values(rg.regrid(source))
        path = tmp_path / "w.nc"
        rg.to_dataset().to_netcdf(path)
        restored = xu.OverlapRegridder.from_dataset(xdata.open_dataset(path))
        result = output_values(restored.regrid(source))
        np.testing.assert_allclose(result, expected, rtol=1e-12)


class TestExtraDimensions:
    def test_time_layer_broadcast(self, source_kind):
        # Extra (time, layer) dims ride the minor axis of the apply.
        rng = np.random.default_rng(8)
        mids = np.arange(NX) + 0.5
        yy, xx = np.meshgrid(mids, mids, indexing="ij")
        base = field_at(xx, yy)  # (y, x) layout
        stack = base[None, None] + rng.normal(
            scale=0.0, size=(3, 2, NX, NX)
        )
        if source_kind == "unstructured":
            grid = unstructured_uda().ugrid.grid
            src = xu.UgridDataArray(
                DataArray(
                    stack.reshape(3, 2, -1),
                    dims=("time", "layer", grid.face_dimension),
                    name="v",
                ),
                grid,
            )
        else:
            x = np.arange(NX) + 0.5
            src = DataArray(
                stack, dims=("time", "layer", "y", "x"), name="v"
            ).assign_coords(y=x, x=x)
        target = unstructured_uda(nx=3, dx=2.0)
        rg = xu.OverlapRegridder(src, target, method="mean")
        out = rg.regrid(src)
        values = np.asarray(
            out.values if isinstance(out, xu.UgridDataArray) else out.data
        )
        assert values.shape[:2] == (3, 2)
        # All slices identical input -> identical output.
        np.testing.assert_allclose(values[0, 0], values[2, 1], rtol=1e-12)
        tx, ty = target_centroids(target)
        np.testing.assert_allclose(
            values[0, 0].ravel(), field_at(tx, ty), rtol=1e-10
        )


class TestNetworkGridder:
    def test_network_intersection_lengths(self):
        # A straight channel across a 2x2 quad target: summed
        # intersection length per face.
        network = xu.Ugrid1d(
            np.array([-1.0, 5.0]),
            np.array([1.0, 1.0]),
            -1,
            np.array([[0, 1]]),
        )
        uda1d = xu.UgridDataArray(
            DataArray(
                np.array([2.0]), dims=(network.edge_dimension,), name="q"
            ),
            network,
        )
        target = unstructured_uda(nx=2, dx=2.0)
        gridder = xu.NetworkGridder(uda1d, target, method="mean")
        out = gridder.regrid(uda1d)
        values = np.asarray(out.values)
        # The channel crosses the bottom row of faces only.
        c = target.ugrid.grid.centroids
        bottom = c[:, 1] < 2.0
        assert np.isfinite(values[bottom]).all()
        np.testing.assert_allclose(values[bottom], 2.0)
        assert np.isnan(values[~bottom]).all()
