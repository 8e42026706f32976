"""
The regrid apply kernel: weights × source values → target values.

This is the hot loop of the framework (reference: the numba
``prange``-parallel CSR row loop, xugrid/regrid/regridder.py:34-69).

Design, two layers, both plain XLA:

* PaddedCSR dense windows turn the ragged CSR loop into one gather plus
  a vectorized reduction over the window axis — no data-dependent
  control flow.
* **Slice-minor layout**: the extra (time/layer) dimension is placed on
  the minor axis, so each gathered element is a contiguous row of all
  slices (one row gather per window entry instead of one scalar gather
  per entry and slice).  Small slice counts are padded up to a
  multiple of 8.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from xugrid_tpu.core.sparse import PaddedCSR


def _pad_minor(n_extra: int) -> int:
    """Minor-axis padding: at least 8, multiples of 8, full 128 when close."""
    if n_extra >= 96:
        return -(-n_extra // 128) * 128
    return max(8, -(-n_extra // 8) * 8)


@partial(jax.jit, static_argnums=(3,))
def _apply_windowed_T(sourceT, indices, weights, reduction):
    """
    sourceT: (m, E) source values, slices on the minor axis.
    indices: (n_target, w_max) int32, -1 padded.
    weights: (n_target, w_max), 0 padded.
    reduction: f(values (..., w), weights (..., w)) reducing the last axis.

    Returns (n_target, E).
    """
    pad = indices < 0
    vals = sourceT[jnp.maximum(indices, 0).reshape(-1)]
    vals = vals.reshape(indices.shape + (sourceT.shape[1],))  # (n, w, E)
    vals = jnp.where(pad[..., None], jnp.nan, vals)
    # Reduction API works on the trailing axis: (n, E, w).
    vals = jnp.swapaxes(vals, -1, -2)
    return reduction(vals, weights[:, None, :])


@partial(jax.jit, static_argnums=(3,))
def _apply_coo_gather_T(sourceT, row, col, n_target):
    """CentroidLocator apply: out[row] = source[col] (pure row gather)."""
    out = jnp.full((n_target, sourceT.shape[1]), jnp.nan, dtype=sourceT.dtype)
    return out.at[row].set(sourceT[col])


def apply_weights(
    weights: PaddedCSR,
    source: np.ndarray,
    reduction,
    target_size: int,
    dtype=None,
):
    """
    Apply regridding weights over the flattened source.

    source: (..., m) array; leading dims are packed onto the minor axis.
    Returns (..., n_target) numpy array.
    """
    source = np.asarray(source)
    leading = source.shape[:-1]
    source2d = source.reshape((-1, source.shape[-1]))
    if dtype is not None:
        source2d = source2d.astype(dtype)
    if not np.issubdtype(source2d.dtype, np.floating):
        source2d = source2d.astype(np.float64)

    n_extra = source2d.shape[0]
    E = _pad_minor(n_extra)
    sourceT = np.zeros((source2d.shape[1], E), dtype=source2d.dtype)
    sourceT[:, :n_extra] = source2d.T

    out = _apply_windowed_T(
        jnp.asarray(sourceT),
        jnp.asarray(weights.indices),
        jnp.asarray(weights.weights),
        reduction,
    )
    out = np.asarray(out)[:, :n_extra].T
    return out.reshape(leading + (target_size,))


def apply_coo_gather(row, col, source: np.ndarray, target_size: int):
    """CentroidLocator apply over the flattened source (slice-minor)."""
    source = np.asarray(source)
    leading = source.shape[:-1]
    source2d = source.reshape((-1, source.shape[-1]))
    if not np.issubdtype(source2d.dtype, np.floating):
        source2d = source2d.astype(np.float64)
    n_extra = source2d.shape[0]
    E = _pad_minor(n_extra)
    sourceT = np.zeros((source2d.shape[1], E), dtype=source2d.dtype)
    sourceT[:, :n_extra] = source2d.T
    out = _apply_coo_gather_T(
        jnp.asarray(sourceT), jnp.asarray(row), jnp.asarray(col), target_size
    )
    out = np.asarray(out)[:, :n_extra].T
    return out.reshape(leading + (target_size,))
