"""
Regridding reduction methods as vectorized JAX kernels.

Each reduction maps a padded neighbor window to one value per target:
``f(values (..., w), weights (..., w)) -> (...)``.  Padded slots carry
``value = NaN, weight = 0``.  NaN/zero-weight semantics match the
reference's scalar numba kernels exactly (xugrid/regrid/reduce.py:16-272)
— but where the reference runs a serial loop per target row, these run
as dense ops over the whole (n_target, w_max) window on the device.

The serial in-place partition selection of the reference's percentile
(reduce.py:161-203, nanpercentile.py) becomes a sort along the trailing
axis — O(w log w) with tiny w, fully parallel over targets.
"""

from __future__ import annotations

from typing import Callable

import jax.numpy as jnp


def _valid(values):
    return ~jnp.isnan(values)


def mean(values, weights):
    valid = _valid(values)
    w = jnp.where(valid, weights, 0.0)
    vsum = jnp.sum(w * jnp.where(valid, values, 0.0), axis=-1)
    wsum = jnp.sum(w, axis=-1)
    return jnp.where(wsum > 0, vsum / jnp.where(wsum == 0, 1.0, wsum), jnp.nan)


def harmonic_mean(values, weights):
    use = _valid(values) & (values != 0.0) & (weights > 0.0)
    w = jnp.where(use, weights, 0.0)
    w_sum = jnp.sum(w, axis=-1)
    v_agg = jnp.sum(
        jnp.where(use, w / jnp.where(use, values, 1.0), 0.0), axis=-1
    )
    ok = (v_agg != 0.0) & (w_sum != 0.0)
    return jnp.where(ok, w_sum / jnp.where(ok, v_agg, 1.0), jnp.nan)


def geometric_mean(values, weights):
    normsum = jnp.sum(weights, axis=-1, keepdims=True)
    w = weights / jnp.where(normsum == 0.0, 1.0, normsum)
    use = _valid(values) & (values > 0.0) & (w > 0.0)
    v_agg = jnp.sum(
        jnp.where(use, w * jnp.log(jnp.abs(jnp.where(use, values, 1.0))), 0.0),
        axis=-1,
    )
    w_sum = jnp.sum(jnp.where(use, w, 0.0), axis=-1)
    any_negative = jnp.any(_valid(values) & (values < 0.0), axis=-1)
    ok = (w_sum != 0.0) & ~any_negative & (normsum[..., 0] != 0.0)
    return jnp.where(
        ok, jnp.exp(v_agg / jnp.where(ok, w_sum, 1.0)), jnp.nan
    )


def sum(values, weights):  # noqa: A001 - name parity with reference
    valid = _valid(values)
    v_sum = jnp.sum(jnp.where(valid, values, 0.0), axis=-1)
    w_sum = jnp.sum(jnp.where(valid, weights, 0.0), axis=-1)
    return jnp.where(w_sum != 0.0, v_sum, jnp.nan)


def minimum(values, weights):
    valid = _valid(values)
    v_min = jnp.min(jnp.where(valid, values, jnp.inf), axis=-1)
    w_max = jnp.max(jnp.where(valid, weights, 0.0), axis=-1)
    return jnp.where(w_max > 0.0, v_min, jnp.nan)


def maximum(values, weights):
    valid = _valid(values)
    v_max = jnp.max(jnp.where(valid, values, -jnp.inf), axis=-1)
    w_max = jnp.max(jnp.where(valid, weights, 0.0), axis=-1)
    return jnp.where(w_max > 0.0, v_max, jnp.nan)


def mode(values, weights):
    """Area-weighted mode; ties resolve to the largest value."""
    valid = _valid(values)
    w = jnp.where(valid, weights, 0.0)
    # Group totals via pairwise equality over the (small) window axis.
    equal = values[..., :, None] == values[..., None, :]  # (..., w, w)
    totals = jnp.sum(equal * w[..., None, :], axis=-1)
    totals = jnp.where(valid, totals, -jnp.inf)
    # Lexicographic (total, value) maximum: max total first, then the
    # largest value among the rows achieving it (tie-break parity).
    safe_vals = jnp.where(valid, values, -jnp.inf)
    max_total = jnp.max(totals, axis=-1, keepdims=True)
    is_best = totals == max_total
    candidate_vals = jnp.where(is_best, safe_vals, -jnp.inf)
    mode_value = jnp.max(candidate_vals, axis=-1)
    w_max = jnp.max(w, axis=-1)
    any_valid = jnp.any(valid, axis=-1)
    return jnp.where(any_valid & (w_max > 0.0), mode_value, jnp.nan)


def max_overlap(values, weights):
    """Value of the source with the largest weight; ties -> larger value."""
    valid = _valid(values)
    w = jnp.where(valid, weights, -jnp.inf)
    w_max = jnp.max(w, axis=-1)
    is_best = w == w_max[..., None]
    candidate_vals = jnp.where(is_best & valid, values, -jnp.inf)
    v_best = jnp.max(candidate_vals, axis=-1)
    return jnp.where(
        jnp.any(valid, axis=-1) & (w_max > 0.0), v_best, jnp.nan
    )


def first_order_conservative(values, weights):
    """Σ v·w with relative weights (area fraction of the source)."""
    valid = _valid(values)
    w = jnp.where(valid, weights, 0.0)
    v_agg = jnp.sum(w * jnp.where(valid, values, 0.0), axis=-1)
    w_sum = jnp.sum(w, axis=-1)
    return jnp.where(w_sum != 0.0, v_agg, jnp.nan)


conductance = first_order_conservative


def create_percentile_method(p: float) -> Callable:
    """Reduction computing the p-th percentile (NaN-skipping, linear
    interpolation between closest ranks)."""
    if not (0.0 <= p <= 100.0):
        raise ValueError(
            f"percentile must be in the range [0, 100], received: {p}"
        )

    def percentile(values, weights):
        w_max = jnp.max(weights, axis=-1)
        valid = _valid(values)
        n = jnp.sum(valid, axis=-1)
        # Sort with NaN pushed to the end (+inf).
        sorted_vals = jnp.sort(jnp.where(valid, values, jnp.inf), axis=-1)
        rank = 1.0 + (n - 1.0) * (p / 100.0)
        f = jnp.floor(rank)
        m = rank - f
        lo_idx = jnp.clip(f.astype(jnp.int32) - 1, 0, values.shape[-1] - 1)
        hi_idx = jnp.clip(lo_idx + 1, 0, values.shape[-1] - 1)
        # Do not step past the last valid value.
        hi_idx = jnp.minimum(hi_idx, jnp.maximum(n - 1, 0).astype(jnp.int32))
        lower = jnp.take_along_axis(sorted_vals, lo_idx[..., None], axis=-1)[..., 0]
        upper = jnp.take_along_axis(sorted_vals, hi_idx[..., None], axis=-1)[..., 0]
        result = lower * (1.0 - m) + upper * m
        if p == 0:
            result = minimum(values, weights)
        elif p == 100:
            result = maximum(values, weights)
        return jnp.where((n > 0) & (w_max > 0.0), result, jnp.nan)

    percentile.__name__ = f"p{p}"
    return percentile


median = create_percentile_method(50)


ABSOLUTE_OVERLAP_METHODS = {
    "mean": mean,
    "harmonic_mean": harmonic_mean,
    "geometric_mean": geometric_mean,
    "sum": sum,
    "minimum": minimum,
    "maximum": maximum,
    "mode": mode,
    "median": median,
    "max_overlap": max_overlap,
}
for _p in (5, 10, 25, 50, 75, 90, 95):
    ABSOLUTE_OVERLAP_METHODS[f"p{_p}"] = create_percentile_method(_p)

RELATIVE_OVERLAP_METHODS = {
    "conductance": conductance,
    "first_order_conservative": first_order_conservative,
}
