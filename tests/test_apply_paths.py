"""
The regrid apply path (regrid/apply.py) against a plain oracle: the
reduce registry (pinned to the reference's numba kernels by
tests/test_golden.py) applied to windows gathered with numpy.

Covers every built-in reduction, NaN-bearing sources, float32 and
float64, and the window shapes that stress the padded layout: ragged
rows, empty blocks, long runs, wide windows, a ragged tail and mostly
empty rows.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from xugrid_tpu.core.sparse import MatrixCOO, PaddedCSR
from xugrid_tpu.regrid import reduce as reductions
from xugrid_tpu.regrid.apply import (
    _pad_minor,
    apply_coo_gather,
    apply_weights,
)

ORACLES = {
    "mean": reductions.mean,
    "sum": reductions.sum,
    "first_order_conservative": reductions.first_order_conservative,
    "conductance": reductions.conductance,
    "harmonic_mean": reductions.harmonic_mean,
    "geometric_mean": reductions.geometric_mean,
    "min": reductions.minimum,
    "max": reductions.maximum,
    "max_overlap": reductions.max_overlap,
    "mode": reductions.mode,
    "median": reductions.median,
    "p10": reductions.create_percentile_method(10),
    "p90": reductions.create_percentile_method(90),
}

SHAPES = [
    "random", "empty_blocks", "longrun_spill", "wide_window", "tail_pad",
    "empty_rows",
]


def make_case(n=700, m=900, w=6, n_extra=5, seed=0, nan_frac=0.0,
              positive=False):
    rng = np.random.default_rng(seed)
    base = (np.arange(n) * m) // n
    offs = rng.integers(-15, 16, size=(n, w))
    indices = np.clip(base[:, None] + offs, 0, m - 1).astype(np.int32)
    # ragged windows: pad a random suffix of each row
    keep = rng.integers(1, w + 1, size=n)
    mask = np.arange(w)[None, :] < keep[:, None]
    indices = np.where(mask, indices, -1)
    # a few empty rows
    empty = rng.random(n) < 0.02
    indices[empty] = -1
    weights = rng.uniform(0.1, 2.0, size=(n, w)).astype(np.float32)
    weights[~mask] = 0.0
    source = rng.normal(size=(n_extra, m)).astype(np.float32)
    if positive:
        source = np.abs(source) + 0.1
    if nan_frac:
        nan_mask = rng.random(source.shape) < nan_frac
        source[nan_mask] = np.nan
    return indices, weights, source


def make_shape(shape, seed, nan_frac, positive):
    """(indices, weights, source) for one named window shape."""
    rng = np.random.default_rng(seed)
    if shape == "random":
        return make_case(seed=seed, nan_frac=nan_frac, positive=positive)
    if shape == "empty_blocks":
        # Whole runs of targets without any window entry.
        indices, weights, source = make_case(
            n=1100, m=800, w=5, n_extra=3, seed=seed, nan_frac=nan_frac,
            positive=positive,
        )
        indices[256:768] = -1
        weights[256:768] = 0.0
        return indices, weights, source
    if shape == "longrun_spill":
        # Long runs of consecutive sources per target.
        n, m, w = 300, 2000, 40
        base = rng.integers(0, m - w, n)
        indices = (base[:, None] + np.argsort(rng.random((n, w)), axis=1))
        weights = rng.uniform(0.1, 1, (n, w))
    elif shape == "wide_window":
        # Windows whose entries lie far apart in the source, and enough
        # slices to pad the minor axis to 128.
        n, w = 200, 30
        indices = np.arange(w)[None] * 384 + rng.integers(0, 100, (n, 1))
        m = int(indices.max()) + 1
        weights = rng.uniform(0.1, 1, (n, w))
        source = rng.normal(size=(100, m))
        return _finish(indices, weights, source, rng, nan_frac, positive)
    elif shape == "tail_pad":
        # A ragged tail: the last half-block of targets is empty.
        n, m, w = 513, 4000, 5
        indices = rng.integers(0, m, (n, w))
        indices[256:512] = -1
        weights = rng.uniform(0.1, 2, (n, w))
    else:  # empty_rows
        n, m, w = 400, 600, 4
        indices = rng.integers(0, m, (n, w))
        keep = np.arange(w)[None] < rng.integers(0, w + 1, n)[:, None]
        indices = np.where(keep & (rng.random(n) < 0.5)[:, None], indices, -1)
        weights = rng.uniform(0.1, 2, (n, w))
    source = rng.normal(size=(1 if shape == "tail_pad" else 2, m))
    return _finish(indices, weights, source, rng, nan_frac, positive)


def _finish(indices, weights, source, rng, nan_frac, positive):
    indices = np.asarray(indices, np.int32)
    weights = np.where(indices >= 0, weights, 0.0).astype(np.float32)
    source = source.astype(np.float32)
    if positive:
        source = np.abs(source) + 0.1
    if nan_frac:
        source[rng.random(source.shape) < nan_frac] = np.nan
    return indices, weights, source


def oracle_apply(method, indices, weights, source):
    pad = indices < 0
    vals = source[:, np.maximum(indices, 0)]          # (E, n, w)
    vals = np.where(pad[None], np.nan, vals)
    out = ORACLES[method](
        jnp.asarray(np.moveaxis(vals, 0, 1)),          # (n, E, w)
        jnp.asarray(weights[:, None, :]),
    )
    return np.asarray(out).T                           # (E, n)


def padded(indices, weights, m):
    n, w = indices.shape
    return PaddedCSR(indices, weights, n, m, w)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("nan_frac", [0.0, 0.15])
@pytest.mark.parametrize("method", list(ORACLES))
def test_apply_weights_matches_oracle(method, nan_frac, shape, dtype):
    positive = method in ("harmonic_mean", "geometric_mean")
    indices, weights, source = make_shape(
        shape, seed=len(method) + 7 * SHAPES.index(shape),
        nan_frac=nan_frac, positive=positive,
    )
    if method == "mode":
        # Repeated values, so that modes are not decided by weight alone.
        source = np.round(source * 2.0) / 2.0
    source = source.astype(dtype)
    weights = weights.astype(dtype)
    got = apply_weights(
        padded(indices, weights, source.shape[1]), source,
        ORACLES[method], len(indices),
    )
    want = oracle_apply(method, indices, weights, source)
    assert got.shape == want.shape and got.dtype == dtype
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    tol = 2e-5 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize(
    "n_extra,expected", [(1, 8), (8, 8), (9, 16), (95, 96), (96, 128),
                         (129, 256)],
)
def test_pad_minor(n_extra, expected):
    assert _pad_minor(n_extra) == expected


def test_apply_weights_leading_dims_and_integer_source():
    """Leading dims are packed on the minor axis and restored; integer
    sources are reduced in float64."""
    indices, weights, _ = make_case(n=50, m=60, w=3, seed=2)
    source = np.arange(3 * 4 * 60).reshape(3, 4, 60)
    got = apply_weights(
        padded(indices, weights, 60), source, reductions.mean, 50
    )
    assert got.shape == (3, 4, 50) and got.dtype == np.float64
    want = oracle_apply(
        "mean", indices, weights, source.reshape(12, 60).astype(np.float64)
    )
    np.testing.assert_allclose(got.reshape(12, 50), want, rtol=1e-12)


def test_apply_weights_dtype_argument_casts_source():
    indices, weights, source = make_case(n=40, m=50, w=3, seed=3)
    got = apply_weights(
        padded(indices, weights, 50), source.astype(np.float64),
        reductions.sum, 40, dtype=np.float32,
    )
    assert got.dtype == np.float32


def test_apply_coo_gather_matches_take():
    rng = np.random.default_rng(5)
    m, n = 90, 70
    row = rng.permutation(n)[:50]
    col = rng.integers(0, m, 50)
    coo = MatrixCOO.from_triplet(row, col, np.ones(50), n=n, m=m)
    source = rng.normal(size=(2, 3, m))
    got = apply_coo_gather(coo.row, coo.col, source, n)
    want = np.full((2, 3, n), np.nan)
    want[..., row] = source[..., col]
    assert got.shape == (2, 3, n)
    np.testing.assert_array_equal(got, want)
