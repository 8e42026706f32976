"""
Interpolation test suite: Laplace (Jacobi-CG / direct) and nearest fill.

Mirrors reference tests/test_interpolate.py scenarios. The reference's
sequential ILU0 preconditioner is inherently serial and is replaced by a
Jacobi-preconditioned CG (xugrid_tpu/ugrid/interpolate.py); the tests
therefore assert numerics against the direct solve, not the ILU0 path.
"""

import numpy as np
import pytest
from scipy import sparse

import xugrid_tpu as xu
from xugrid_tpu.ugrid import interpolate
from xugrid_tpu.xdata import DataArray


def chain_connectivity(n):
    """Symmetric adjacency of a 1D chain 0-1-2-...-(n-1)."""
    i = np.repeat(np.arange(n - 1), 2)
    j = i.copy()
    i[::2] += 0
    j[::2] += 1
    i[1::2] += 1
    j[1::2] += 0
    data = np.ones_like(i, dtype=float)
    return sparse.coo_matrix((data, (i, j)), shape=(n, n)).tocsr()


class TestLaplaceInterpolate:
    def test_non_square_raises(self):
        con = sparse.coo_matrix(
            (np.ones(2), ([0, 1], [1, 2])), shape=(4, 5)
        ).tocsr()
        data = np.array([1.0, np.nan, np.nan, 5.0])
        with pytest.raises(ValueError, match="not a square matrix"):
            interpolate.laplace_interpolate(data, con, use_weights=False)

    def test_chain_exact(self):
        # Dirichlet 1.0 / 5.0 at the ends -> linear profile.
        con = chain_connectivity(5)
        data = np.array([1.0, np.nan, np.nan, np.nan, 5.0])
        expected = np.arange(1.0, 6.0)
        actual = interpolate.laplace_interpolate(
            data, con, use_weights=False, direct_solve=True
        )
        np.testing.assert_allclose(actual, expected)
        actual = interpolate.laplace_interpolate(
            data, con, use_weights=False, direct_solve=False, atol=1e-10
        )
        np.testing.assert_allclose(actual, expected, atol=1e-6)

    def test_use_weights(self):
        # Distance weights: node 1 sits 3x closer to node 2 than node 0.
        n = 3
        w01, w12 = 1.0, 3.0
        i = np.array([0, 1, 1, 2])
        j = np.array([1, 0, 2, 1])
        w = np.array([w01, w01, w12, w12])
        con = sparse.coo_matrix((w, (i, j)), shape=(n, n)).tocsr()
        data = np.array([0.0, np.nan, 4.0])
        actual = interpolate.laplace_interpolate(
            data, con, use_weights=True, direct_solve=True
        )
        # (w01*0 + w12*4) / (w01 + w12) = 3.0
        np.testing.assert_allclose(actual, [0.0, 3.0, 4.0])

    def test_batched_rows(self):
        con = chain_connectivity(5)
        data = np.array(
            [
                [1.0, np.nan, np.nan, np.nan, 5.0],
                [2.0, np.nan, np.nan, np.nan, 10.0],
            ]
        )
        actual = interpolate.laplace_interpolate(
            data, con, use_weights=False, direct_solve=True
        )
        np.testing.assert_allclose(actual[0], np.arange(1.0, 6.0))
        np.testing.assert_allclose(actual[1], np.arange(2.0, 12.0, 2.0))

    def test_disconnected_component_stays_nan(self):
        # Two chains: 0-1-2 (has known values) and 3-4 (all NaN).
        i = np.array([0, 1, 1, 2, 3, 4])
        j = np.array([1, 0, 2, 1, 4, 3])
        con = sparse.coo_matrix(
            (np.ones(6), (i, j)), shape=(5, 5)
        ).tocsr()
        labels = np.array([0, 0, 0, 1, 1])
        data = np.array([1.0, np.nan, 3.0, np.nan, np.nan])
        actual = interpolate.laplace_interpolate(
            data,
            con,
            use_weights=False,
            components_labels=labels,
            direct_solve=True,
        )
        np.testing.assert_allclose(actual[:3], [1.0, 2.0, 3.0])
        assert np.isnan(actual[3:]).all()

    def test_all_nan_raises(self):
        con = chain_connectivity(3)
        with pytest.raises(ValueError, match="All values are NA"):
            interpolate.laplace_interpolate(
                np.full(3, np.nan), con, use_weights=False
            )

    def test_no_nan_returns_copy(self):
        con = chain_connectivity(3)
        data = np.array([1.0, 2.0, 3.0])
        out = interpolate.laplace_interpolate(data, con, use_weights=False)
        np.testing.assert_allclose(out, data)
        out[0] = 99.0
        assert data[0] == 1.0


class TestNearestInterpolate:
    def test_basic(self):
        coords = np.column_stack([np.arange(5.0), np.zeros(5)])
        data = np.array([1.0, np.nan, np.nan, np.nan, 5.0])
        out = interpolate.nearest_interpolate(coords, data, np.inf)
        np.testing.assert_allclose(out, [1.0, 1.0, 1.0, 5.0, 5.0])

    def test_max_distance(self):
        coords = np.column_stack([np.arange(5.0), np.zeros(5)])
        data = np.array([1.0, np.nan, np.nan, np.nan, 5.0])
        out = interpolate.nearest_interpolate(coords, data, 1.5)
        np.testing.assert_allclose(out[[0, 1, 3, 4]], [1.0, 1.0, 5.0, 5.0])
        assert np.isnan(out[2])

    def test_all_nan_raises(self):
        coords = np.zeros((3, 2))
        with pytest.raises(ValueError, match="All values are NA"):
            interpolate.nearest_interpolate(coords, np.full(3, np.nan), 1.0)


class TestAccessorInterpolate:
    @pytest.fixture
    def uda(self):
        grid = xu.Ugrid2d(
            *np.array(
                [
                    [0.0, 0.0],
                    [1.0, 0.0],
                    [2.0, 0.0],
                    [0.0, 1.0],
                    [1.0, 1.0],
                    [2.0, 1.0],
                ]
            ).T,
            -1,
            np.array([[0, 1, 4, 3], [1, 2, 5, 4]]),
        )
        data = np.array([2.0, np.nan])
        return xu.UgridDataArray(
            DataArray(data, dims=(grid.face_dimension,), name="z"), grid
        )

    def test_interpolate_na(self, uda):
        out = uda.ugrid.interpolate_na()
        np.testing.assert_allclose(np.asarray(out.values), [2.0, 2.0])

    def test_laplace_interpolate_accessor(self, uda):
        out = uda.ugrid.laplace_interpolate(direct_solve=True)
        np.testing.assert_allclose(np.asarray(out.values), [2.0, 2.0])

    def test_interpolate_na_extra_dim(self, uda):
        values = np.stack(
            [np.asarray(uda.values), 2 * np.asarray(uda.values)]
        )
        da = DataArray(
            values, dims=("layer", uda.grid.face_dimension), name="z"
        )
        uda2 = xu.UgridDataArray(da, uda.grid)
        out = uda2.ugrid.interpolate_na()
        np.testing.assert_allclose(
            np.asarray(out.values), [[2.0, 2.0], [4.0, 4.0]]
        )


class TestChebyshevPreconditioner:
    def _grid_problem(self, n_side=60, frac=0.03, seed=2):
        import scipy.sparse

        n = n_side * n_side
        idx = np.arange(n).reshape(n_side, n_side)
        r = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
        c = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
        rr = np.concatenate([r, c])
        cc = np.concatenate([c, r])
        W = scipy.sparse.coo_matrix(
            (np.ones(len(rr)), (rr, cc)), shape=(n, n)
        ).tocsr()
        rng = np.random.default_rng(seed)
        truth = np.sin(np.linspace(0, 6, n)) * 3.0
        known = rng.random(n) < frac
        vals = np.where(known, truth, np.nan)
        return vals, W

    def test_matches_direct_solve(self):
        vals, W = self._grid_problem()
        direct = interpolate.laplace_interpolate(vals, W, direct_solve=True)
        pcg = interpolate.laplace_interpolate(
            vals, W, maxiter=5000, atol=1e-9, precondition_degree=4
        )
        np.testing.assert_allclose(pcg, direct, atol=1e-6)

    def test_degree_reduces_iterations(self):
        vals, W = self._grid_problem()
        interpolate.laplace_interpolate(
            vals, W, maxiter=5000, atol=1e-8, precondition_degree=1
        )
        it_jacobi = interpolate.last_solve_info["iterations"]
        interpolate.laplace_interpolate(
            vals, W, maxiter=5000, atol=1e-8, precondition_degree=4
        )
        it_cheb = interpolate.last_solve_info["iterations"]
        assert it_cheb < 0.5 * it_jacobi
        assert it_cheb > 0

    def test_bucketing_pads_consistently(self):
        # A non-power-of-two unknown count must not perturb the solution.
        vals, W = self._grid_problem(n_side=37)
        direct = interpolate.laplace_interpolate(vals, W, direct_solve=True)
        pcg = interpolate.laplace_interpolate(
            vals, W, maxiter=5000, atol=1e-9, precondition_degree=4
        )
        np.testing.assert_allclose(pcg, direct, atol=1e-6)


def test_interpolate_na_batches_matching_slices(monkeypatch):
    """interpolate_na over a time dimension whose slices share one NaN
    pattern must issue ONE batched Laplace solve (right-hand sides on
    the batch axis), not one solve per slice (VERDICT r3 item 8;
    reference broadcasts via apply_ufunc,
    /root/reference/xugrid/ugrid/interpolate.py:333-351)."""
    conn = _grid_adjacency(12, 12)
    n = conn.shape[0]
    rng = np.random.default_rng(21)
    base = rng.normal(size=n)
    base[rng.random(n) < 0.4] = np.nan
    stack = np.stack([base, base * 2.0 + 1.0, base - 3.0])
    da = DataArray(stack, dims=("time", "node"))

    calls = []
    orig = interpolate.laplace_interpolate

    def spy(data, *args, **kwargs):
        calls.append(np.atleast_2d(np.asarray(data)).shape)
        return orig(data, *args, **kwargs)

    monkeypatch.setattr(interpolate, "laplace_interpolate", spy)
    out = interpolate.interpolate_na_helper(
        da, "node", interpolate.laplace_interpolate,
        {"connectivity": conn, "atol": 1e-9},
    )
    assert calls == [(3, n)]  # one batched solve, all three slices
    # Values match the per-slice solves.
    for k in range(3):
        single = orig(stack[k], conn, atol=1e-9)
        np.testing.assert_allclose(
            np.asarray(out.data)[k], single, rtol=1e-5, atol=1e-6
        )

    # Mismatched NaN patterns fall back to per-slice solves.
    stack2 = stack.copy()
    stack2[1, np.flatnonzero(~np.isnan(base))[:3]] = np.nan
    da2 = DataArray(stack2, dims=("time", "node"))
    calls.clear()
    out2 = interpolate.interpolate_na_helper(
        da2, "node", interpolate.laplace_interpolate,
        {"connectivity": conn, "atol": 1e-9},
    )
    assert len(calls) == 3
    assert np.isfinite(np.asarray(out2.data)).all()


def test_multi_rhs_batches_one_gather_solve(monkeypatch):
    """A 2-D stack of time slices sharing one NaN pattern must ride
    ONE CG solve with the right-hand sides batched — not E sequential
    solves (reference: interpolate_na broadcasting via
    dask='parallelized', xugrid/ugrid/interpolate.py:333-351)."""
    monkeypatch.setenv("XUGRID_TPU_CG_DIA", "0")

    calls = []
    real_cg = interpolate.cg_solve

    def counting_cg(rows, cols, vals, diag, b, x0, *a, **kw):
        calls.append(np.atleast_2d(b).shape[0])
        return real_cg(rows, cols, vals, diag, b, x0, *a, **kw)

    monkeypatch.setattr(interpolate, "cg_solve", counting_cg)

    conn = _grid_adjacency(14, 14)
    n = conn.shape[0]
    rng = np.random.default_rng(9)
    base = rng.normal(size=n)
    base[rng.random(n) < 0.4] = np.nan
    scales = 1.0 + 0.25 * np.arange(6)
    stack = base[None, :] * scales[:, None]   # shared NaN pattern

    out = interpolate.laplace_interpolate(
        stack, conn, direct_solve=False, atol=1e-9
    )
    # One solve carrying all 6 RHS.
    assert calls == [6]
    # Laplace is linear: slice k must equal scales[k] * slice 0.
    single = interpolate.laplace_interpolate(
        stack[0], conn, direct_solve=False, atol=1e-9
    )
    for k, s in enumerate(scales):
        np.testing.assert_allclose(out[k], single * s, rtol=1e-5,
                                   atol=1e-6)


def _grid_adjacency(nx, ny, drop_frac=0.0, seed=0):
    """Symmetric 4-neighbor adjacency of an nx*ny raster, optionally
    with a random subset of nodes removed (banded but irregular)."""
    idx = np.arange(nx * ny).reshape(ny, nx)
    pairs = []
    pairs.append(np.column_stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()]))
    pairs.append(np.column_stack([idx[:-1, :].ravel(), idx[1:, :].ravel()]))
    ij = np.concatenate(pairs)
    if drop_frac:
        rng = np.random.default_rng(seed)
        keep_node = rng.random(nx * ny) >= drop_frac
        ij = ij[keep_node[ij[:, 0]] & keep_node[ij[:, 1]]]
    i = np.concatenate([ij[:, 0], ij[:, 1]])
    j = np.concatenate([ij[:, 1], ij[:, 0]])
    w = np.ones(len(i))
    return sparse.coo_matrix((w, (i, j)), shape=(nx * ny, nx * ny)).tocsr()


class TestDiaStencilSolve:
    """The DIA (shifted-stream) PCG vs the COO formulation: both must
    produce the same interpolation on banded Laplace graphs."""

    @pytest.mark.parametrize(
        "nx,ny,drop,nan_frac",
        [(16, 16, 0.0, 0.3), (24, 9, 0.0, 0.6), (12, 12, 0.15, 0.4)],
    )
    def test_matches_coo_path(self, monkeypatch, nx, ny, drop, nan_frac):
        conn = _grid_adjacency(nx, ny, drop_frac=drop, seed=3)
        rng = np.random.default_rng(nx * 100 + ny)
        data = rng.normal(size=conn.shape[0])
        data[rng.random(conn.shape[0]) < nan_frac] = np.nan
        if np.isnan(data).all() or not np.isnan(data).any():
            data[:2] = [1.0, np.nan]

        monkeypatch.setenv("XUGRID_TPU_CG_DIA", "force")
        out_dia = interpolate.laplace_interpolate(
            data, conn, direct_solve=False, atol=1e-8
        )
        monkeypatch.setenv("XUGRID_TPU_CG_DIA", "0")
        out_coo = interpolate.laplace_interpolate(
            data, conn, direct_solve=False, atol=1e-8
        )
        known = ~np.isnan(data)
        np.testing.assert_allclose(out_dia[known], data[known])
        np.testing.assert_allclose(out_dia, out_coo, rtol=1e-5, atol=1e-6)

    def test_batched_rhs_matches_single(self, monkeypatch):
        monkeypatch.setenv("XUGRID_TPU_CG_DIA", "force")
        conn = _grid_adjacency(10, 10)
        rng = np.random.default_rng(5)
        base = rng.normal(size=conn.shape[0])
        base[rng.random(conn.shape[0]) < 0.5] = np.nan
        stack = np.stack([base, base * 2.0 + 1.0])
        out2 = interpolate.laplace_interpolate(
            stack, conn, direct_solve=False, atol=1e-9
        )
        out0 = interpolate.laplace_interpolate(
            stack[0], conn, direct_solve=False, atol=1e-9
        )
        np.testing.assert_allclose(out2[0], out0, rtol=1e-5, atol=1e-7)
        # Laplace is affine: a*x+b solves to a*sol+b.
        np.testing.assert_allclose(
            out2[1], out0 * 2.0 + 1.0, rtol=1e-4, atol=1e-5
        )

    def test_assembly_cache_hit_and_no_false_sharing(self, monkeypatch):
        # The matrix-dependent assembly is cached by content hash
        # (1M-node solves were dominated by re-assembly).  A repeat
        # solve must be bit-identical, and a DIFFERENT matrix with the
        # same shape/NaN pattern must not reuse the wrong entry.
        monkeypatch.setenv("XUGRID_TPU_CG_DIA", "force")
        interpolate._DIA_ASSEMBLY.clear()
        conn = _grid_adjacency(12, 12)
        rng = np.random.default_rng(11)
        data = rng.normal(size=conn.shape[0])
        data[rng.random(conn.shape[0]) < 0.4] = np.nan
        out1 = interpolate.laplace_interpolate(
            data, conn, direct_solve=False, atol=1e-9
        )
        assert len(interpolate._DIA_ASSEMBLY) == 1
        out2 = interpolate.laplace_interpolate(
            data, conn, direct_solve=False, atol=1e-9
        )
        assert np.array_equal(out1, out2, equal_nan=True)
        conn2 = conn.copy()
        conn2.data = conn2.data * 3.0
        out3 = interpolate.laplace_interpolate(
            data, conn2, direct_solve=False, atol=1e-9
        )
        oracle3 = interpolate.laplace_interpolate(
            data, conn2, direct_solve=True
        )
        np.testing.assert_allclose(out3, oracle3, rtol=1e-5, atol=1e-6)
        assert len(interpolate._DIA_ASSEMBLY) == 2

    def test_rcm_bands_shuffled_graph_into_dia(self, monkeypatch):
        # A randomly relabeled banded graph has arbitrary raw offsets;
        # the RCM retry must band it back into the DIA budget and
        # return solutions in the ORIGINAL node order.
        monkeypatch.setenv("XUGRID_TPU_CG_DIA", "force")
        interpolate._DIA_ASSEMBLY.clear()
        conn = _grid_adjacency(20, 10)
        n = conn.shape[0]
        rng = np.random.default_rng(8)
        perm = rng.permutation(n)
        shuffled = conn[perm, :][:, perm].tocsr()
        data = rng.normal(size=n)
        data[rng.random(n) < 0.4] = np.nan

        # Raw offsets exceed the DIA budget on the shuffled labels.
        coo = shuffled.tocoo()
        mask = np.isnan(data)
        uu = mask[coo.row] & mask[coo.col] & (coo.row != coo.col)
        assert len(np.unique(coo.col[uu] - coo.row[uu])) > interpolate._DIA_MAX_K

        out = interpolate.laplace_interpolate(
            data, shuffled, direct_solve=False, atol=1e-9
        )
        assert interpolate.last_solve_info["mode"] == "dia"
        oracle = interpolate.laplace_interpolate(
            data, shuffled, direct_solve=True
        )
        np.testing.assert_allclose(out, oracle, rtol=1e-5, atol=1e-6)

    def test_rcm_gather_path_matches_direct(self, monkeypatch):
        # Shuffled graph, DIA disabled, unknown system above the RCM
        # threshold: the CG path permutes for locality and must
        # un-permute the solutions.
        monkeypatch.setenv("XUGRID_TPU_CG_DIA", "0")
        monkeypatch.setenv("XUGRID_TPU_CG_RCM", "1")
        conn = _grid_adjacency(90, 90)
        n = conn.shape[0]
        rng = np.random.default_rng(9)
        perm = rng.permutation(n)
        shuffled = conn[perm, :][:, perm].tocsr()
        data = rng.normal(size=n)
        data[rng.random(n) < 0.8] = np.nan
        assert np.isnan(data).sum() > 4096  # crosses the RCM gate
        out = interpolate.laplace_interpolate(
            data, shuffled, direct_solve=False, atol=1e-9, maxiter=2000
        )
        oracle = interpolate.laplace_interpolate(
            data, shuffled, direct_solve=True
        )
        np.testing.assert_allclose(out, oracle, rtol=1e-4, atol=1e-5)

    def test_dia_engages_on_structured(self, monkeypatch):
        # On a banded graph the auto mode must pick DIA (the gather/COO
        # branches would otherwise hide regressions in this test file).
        called = {}
        orig = interpolate._try_dia_solve

        def spy(*a, **k):
            out = orig(*a, **k)
            called["result"] = out is not None
            return out

        monkeypatch.setattr(interpolate, "_try_dia_solve", spy)
        monkeypatch.setenv("XUGRID_TPU_CG_DIA", "auto")
        conn = _grid_adjacency(8, 8)
        data = np.ones(64)
        data[10:40] = np.nan
        interpolate.laplace_interpolate(data, conn, direct_solve=False)
        assert called.get("result") is True


def test_prep_and_device_caches_correct_across_data_changes(monkeypatch):
    """The content-keyed cache of laplace_interpolate (system
    extraction/RCM) must be transparent: a second solve with DIFFERENT
    data on the SAME matrix/NaN pattern hits the cache and still
    matches the direct solve, and changing the matrix must miss (no
    collisions)."""
    monkeypatch.setenv("XUGRID_TPU_CG_DIA", "0")
    interpolate._LAPLACE_PREP.clear()

    conn = _grid_adjacency(13, 13)
    n = conn.shape[0]
    rng = np.random.default_rng(17)
    nanmask = rng.random(n) < 0.35
    data1 = rng.normal(size=n)
    data1[nanmask] = np.nan
    out1 = interpolate.laplace_interpolate(data1, conn, atol=1e-10)
    assert len(interpolate._LAPLACE_PREP) == 1
    # Same matrix + pattern, different values: full cache-hit path.
    data2 = rng.normal(size=n) * 3.0 + 1.0
    data2[nanmask] = np.nan
    out2 = interpolate.laplace_interpolate(data2, conn, atol=1e-10)
    assert len(interpolate._LAPLACE_PREP) == 1          # prep hit
    ref2 = interpolate.laplace_interpolate(
        data2, conn, direct_solve=True
    )
    np.testing.assert_allclose(out2, ref2, atol=1e-5)
    np.testing.assert_allclose(out2[~nanmask], data2[~nanmask])

    # Different matrix content: must MISS (a collision would silently
    # solve the wrong system).
    conn3 = conn.copy()
    conn3.data = conn3.data * 2.0
    out3 = interpolate.laplace_interpolate(data2, conn3, atol=1e-10)
    assert len(interpolate._LAPLACE_PREP) == 2
    ref3 = interpolate.laplace_interpolate(
        data2, conn3, direct_solve=True
    )
    np.testing.assert_allclose(out3, ref3, atol=1e-5)
    interpolate._LAPLACE_PREP.clear()
