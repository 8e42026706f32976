"""
Batched nearest-neighbor queries on device.

The reference's nearest lookups go through scipy KDTree with thread
workers (xugrid/ugrid/ugridbase.py:1114-1123, 1275-1303).  Tree descent
is scalar, branchy work.  The device formulation is brute force per
SOURCE TILE with a running (best distance, best index) reduction —
dense, branch-free, batched over every query at once.  For P queries
and M sources this is O(P * M) work instead of O(P log M) scalar steps,
which pays off for large query batches until M grows huge, at which
point the host KDTree (C, threaded) is used instead.  ``nearest_points``
picks automatically.

Distances are formed from coordinate differences, not from the
expansion |q|^2 + |s|^2 - 2 q.s: in float32 that expansion cancels
catastrophically (|q|^2 ~ 1e5 against a nearest d^2 ~ 0.1 on a 1000 m
mesh) and mis-orders near-ties.  Coordinates travel as float32 hi/lo
pairs around a local origin, so the difference of two nearby points is
accurate to float32 precision of the difference itself.
"""

from __future__ import annotations

import os
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

#: source-tile length per scan step.
TILE = 2048

#: device path engages above this many query-source pairs.  The
#: crossover sits high: the threaded KDTree handles 3e8 pairs in tens
#: of milliseconds, and the device path compiles once per query-count
#: bucket (force with XUGRID_TPU_NEAREST=device).
_MIN_WORK = 1 << 36
#: ...and below this many sources (tiling the queries too would win
#: back more range, but the KDTree is already fine there).
_MAX_SOURCES = 1 << 21


def _split(xy: np.ndarray):
    """float64 -> (hi, lo) float32 pair with hi + lo == xy to ~2^-48."""
    hi = xy.astype(np.float32)
    lo = (xy - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


@partial(jax.jit, static_argnames=("n_tiles",))
def _nearest_device(q_hi, q_lo, s_hi, s_lo, n_tiles: int):
    """(P, 2) queries vs (n_tiles * TILE, 2) sources, each as hi/lo
    float32 pairs -> (best_d2, idx)."""
    tiles_hi = s_hi.reshape(n_tiles, TILE, 2)
    tiles_lo = s_lo.reshape(n_tiles, TILE, 2)

    def body(carry, inp):
        best_d2, best_idx = carry
        t_hi, t_lo, t = inp
        # hi - hi is exact for nearby points (Sterbenz); lo - lo adds
        # the rest.  (P, T) per axis.
        dx = (q_hi[:, None, 0] - t_hi[None, :, 0]) + (
            q_lo[:, None, 0] - t_lo[None, :, 0]
        )
        dy = (q_hi[:, None, 1] - t_hi[None, :, 1]) + (
            q_lo[:, None, 1] - t_lo[None, :, 1]
        )
        d2 = dx * dx + dy * dy
        arg = jnp.argmin(d2, axis=1)
        tile_d2 = jnp.min(d2, axis=1)
        better = tile_d2 < best_d2
        best_d2 = jnp.where(better, tile_d2, best_d2)
        best_idx = jnp.where(
            better, (t * TILE + arg).astype(jnp.int32), best_idx
        )
        return (best_d2, best_idx), None

    init = (
        jnp.full(q_hi.shape[0], jnp.inf, q_hi.dtype),
        jnp.full(q_hi.shape[0], -1, jnp.int32),
    )
    (best_d2, best_idx), _ = jax.lax.scan(
        body, init,
        (tiles_hi, tiles_lo, jnp.arange(n_tiles, dtype=jnp.int32)),
    )
    return best_d2, best_idx


def nearest_points(
    sources: np.ndarray,
    queries: np.ndarray,
    max_distance: float = np.inf,
    tree=None,
):
    """
    Index of the nearest source per query (-1 beyond ``max_distance``).

    Dispatches between the device brute-force kernel and the host
    KDTree by problem shape and backend; XUGRID_TPU_NEAREST=
    device|host overrides.  ``tree`` may pass a prebuilt
    scipy KDTree over ``sources`` so repeated host-path lookups skip
    the O(M log M) construction (the grids cache theirs).
    """
    sources = np.ascontiguousarray(sources, dtype=np.float64)
    queries = np.atleast_2d(np.ascontiguousarray(queries, dtype=np.float64))
    P, M = len(queries), len(sources)
    mode = os.environ.get("XUGRID_TPU_NEAREST", "auto")
    use_device = mode == "device" or (
        mode == "auto"
        and P * M >= _MIN_WORK
        and M <= _MAX_SOURCES
        and jax.default_backend() != "cpu"
    )
    if not use_device or M == 0:
        if tree is None:
            from scipy.spatial import KDTree

            tree = KDTree(sources)
        _, indices = tree.query(
            queries, distance_upper_bound=max_distance, workers=-1
        )
        indices = np.asarray(indices, dtype=np.int64)
        indices[indices == M] = -1
        return indices

    n_tiles = -(-M // TILE)
    # Local origin: keeps large-magnitude coordinate systems (UTM ~1e6)
    # in the range where the hi/lo split is exact.
    origin = sources.mean(axis=0)
    # Pad with a huge FINITE coordinate: its squared distance is ~1e36,
    # never a winner, whereas inf pads would give inf - inf = NaN
    # differences — and NaN WINS argmin.
    padded = np.full((n_tiles * TILE, 2), 1e18)
    padded[:M] = sources - origin
    # Bucket the query count to powers of two so repeated calls reuse
    # compiles (pad queries join some tile's argmin harmlessly).
    P_pad = 1 << max(int(np.ceil(np.log2(max(P, 1)))), 3)
    q_pad = np.zeros((P_pad, 2))
    q_pad[:P] = queries - origin
    q_hi, q_lo = _split(q_pad)
    s_hi, s_lo = _split(padded)
    d2, idx = _nearest_device(
        jnp.asarray(q_hi), jnp.asarray(q_lo),
        jnp.asarray(s_hi), jnp.asarray(s_lo), n_tiles,
    )
    idx = np.asarray(idx[:P], dtype=np.int64)
    if np.isfinite(max_distance):
        idx = np.where(np.asarray(d2[:P]) <= max_distance**2, idx, -1)
    return idx
