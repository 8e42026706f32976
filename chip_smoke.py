"""
Smoke run of the main path on one NVIDIA GPU, through the public API,
at the sizes users run.  Each phase is checked against a plain
numpy/scipy reference computed on the host in float64.

Phases (one process, x64 off):

1. overlap regrid, 1M jittered quads -> 512² raster, 20 time slices:
   ``OverlapRegridder`` mean / maximum / median and
   ``CentroidLocatorRegridder``;
2. nearest face centroid for 2^17 points on the device route;
3. Laplace fill of 1M nodes with 30% gaps, on a structured (banded, DIA
   solver) mesh and on a shuffled Delaunay mesh (COO/windowed CG);
4. partition(4) + merge_partitions round trip of the 1M-face data.

``--four`` runs only the sharded path (halo regrid, smoothing, sharded
CG) over a flat mesh of four GPUs on the same 1M-face mesh.

Prints one line per phase, the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``.  Exits non-zero, without
that line, when no GPU is found or any phase fails.

Usage: python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

#: bench.py's default configuration (1M source faces).
N_SIDE, T_SIDE, N_EXTRA, SEED = 1000, 512, 20, 42
#: source values replaced by NaN, to exercise the NaN semantics.
NAN_FRAC = 0.02
N_QUERIES = 1 << 17
LAPLACE_SIDE = 999  # (LAPLACE_SIDE + 1)² = 1M nodes
GAP_FRAC = 0.3


# -- bookkeeping -------------------------------------------------------------
_COMPILE_S = [0.0]


def _on_event(event, duration, **_):
    if event.startswith("/jax/core/compile/"):
        _COMPILE_S[0] += duration


jax.monitoring.register_event_duration_secs_listener(_on_event)


def timed(fn):
    """(result, wall seconds, compile seconds) of ``fn()``, blocked on
    its (host) result."""
    c0 = _COMPILE_S[0]
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0, _COMPILE_S[0] - c0


def report(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(phase, err, tol, **fields):
    report(phase, max_err=err, tol=tol, **fields)
    if not err <= tol:
        raise AssertionError(f"{phase}: error {err} above tolerance {tol}")


def card_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def require_gpu(count: int):
    devices = jax.devices()
    if not devices or devices[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: jax.devices()[0] is {devices[0] if devices else None}"
        )
    if len(devices) < count:
        raise SystemExit(f"need {count} GPUs, found {len(devices)}")
    return devices


# -- host references ---------------------------------------------------------
def windows_from_csr(indptr, indices, data):
    """(n, w) -1/0 padded index and weight windows, built with numpy."""
    counts = np.diff(indptr)
    n, w = len(counts), max(int(counts.max()), 1)
    idx = np.full((n, w), -1, np.int64)
    wts = np.zeros((n, w), np.float64)
    slot = np.arange(len(indices)) - np.repeat(indptr[:-1], counts)
    rows = np.repeat(np.arange(n), counts)
    idx[rows, slot] = indices
    wts[rows, slot] = data
    return idx, wts


def reference_reduce(method, idx, wts, source):
    """float64 host reduction of (E, m) ``source`` over the windows,
    with the NaN semantics of regrid/reduce.py.  Returns (E, n)."""
    vals = source.astype(np.float64)[:, np.maximum(idx, 0)]  # (E, n, w)
    valid = (idx >= 0)[None] & ~np.isnan(vals)
    wv = np.where(valid, wts[None], 0.0)
    if method == "mean":
        wsum = wv.sum(-1)
        num = (wv * np.where(valid, vals, 0.0)).sum(-1)
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(wsum > 0, num / wsum, np.nan)
    if method == "maximum":
        vmax = np.where(valid, vals, -np.inf).max(-1)
        return np.where(wv.max(-1) > 0, vmax, np.nan)
    if method == "median":
        n_valid = valid.sum(-1)
        ordered = np.sort(np.where(valid, vals, np.inf), axis=-1)
        rank = 1.0 + (n_valid - 1.0) * 0.5
        lo = np.clip(np.floor(rank).astype(np.int64) - 1, 0, idx.shape[1] - 1)
        hi = np.minimum(np.minimum(lo + 1, idx.shape[1] - 1),
                        np.maximum(n_valid - 1, 0))
        frac = rank - np.floor(rank)
        lower = np.take_along_axis(ordered, lo[..., None], -1)[..., 0]
        upper = np.take_along_axis(ordered, hi[..., None], -1)[..., 0]
        with np.errstate(invalid="ignore"):
            out = lower * (1.0 - frac) + upper * frac
        gate = (n_valid > 0) & (wts.max(-1)[None] > 0)
        return np.where(gate, out, np.nan)
    raise ValueError(method)


def points_in_quads(points, quads):
    """Each point inside (or on) its counter-clockwise quad."""
    inside = np.ones(len(points), bool)
    for k in range(4):
        a, b = quads[:, k], quads[:, (k + 1) % 4]
        cross = (b[:, 0] - a[:, 0]) * (points[:, 1] - a[:, 1]) - (
            b[:, 1] - a[:, 1]
        ) * (points[:, 0] - a[:, 0])
        inside &= cross >= -1e-9
    return inside


# -- phases ------------------------------------------------------------------
def make_regrid_case(n_side=N_SIDE, t_side=T_SIDE, n_extra=N_EXTRA, seed=SEED):
    import xugrid_tpu as xu
    from __graft_entry__ import jittered_quad_grid, raster_grid
    from xugrid_tpu import xdata

    grid = jittered_quad_grid(n_side, seed=seed)
    target = raster_grid(t_side, float(n_side))
    rng = np.random.default_rng(seed)
    values = rng.normal(size=(n_extra, grid.n_face)).astype(np.float32)
    values[rng.random(values.shape) < NAN_FRAC] = np.nan
    uda = xu.UgridDataArray(
        xdata.DataArray(values, dims=("time", grid.face_dimension), name="v"),
        grid,
    )
    return grid, target, uda


def phase_regrid(grid, target, uda):
    import xugrid_tpu as xu
    from xugrid_tpu.regrid.apply import _apply_windowed_T, _pad_minor
    from xugrid_tpu.regrid import reduce

    source = np.asarray(uda.values)
    for method in ("mean", "maximum", "median"):
        regridder, build_s, _ = timed(
            lambda: xu.OverlapRegridder(uda, target, method=method)
        )
        _, first_s, compile_s = timed(lambda: regridder.regrid(uda).values)
        out, wall_s, _ = timed(lambda: np.asarray(regridder.regrid(uda).values))
        csr = regridder._weights
        idx, wts = windows_from_csr(csr.indptr, csr.indices, csr.data)
        want = reference_reduce(method, idx, wts, source)
        got = out.reshape(want.shape)
        nan_ok = np.array_equal(np.isnan(got), np.isnan(want))
        fin = ~np.isnan(want)
        extra = {}
        if method == "mean":
            # f32 accumulation: error relative to the weighted mean of
            # |v| over the window (the sum's own scale).
            vals = np.abs(source.astype(np.float64))[:, np.maximum(idx, 0)]
            valid = (idx >= 0)[None] & ~np.isnan(vals)
            wv = np.where(valid, wts[None], 0.0)
            with np.errstate(invalid="ignore", divide="ignore"):
                scale = (wv * np.where(valid, vals, 0.0)).sum(-1) / wv.sum(-1)
            err = float(np.max(np.abs(got[fin] - want[fin]) / scale[fin]))
            tol = 1e-5
            padded = regridder._padded_weights
            E = _pad_minor(source.shape[0])
            mem = _apply_windowed_T.lower(
                jax.ShapeDtypeStruct((grid.n_face, E), np.float32),
                jax.ShapeDtypeStruct(padded.indices.shape, np.int32),
                jax.ShapeDtypeStruct(padded.weights.shape, np.float32),
                reduce.mean,
            ).compile().memory_analysis()
            extra = dict(
                nnz=int(csr.nnz), w_max=int(padded.w_max),
                apply_temp_bytes=int(mem.temp_size_in_bytes),
                apply_arg_bytes=int(mem.argument_size_in_bytes),
            )
        else:
            # Selection returns input values: exact against the float64
            # result rounded to float32.
            err = float(np.max(np.abs(got[fin] - want[fin].astype(np.float32)),
                               initial=0.0))
            tol = 0.0
        if not nan_ok:
            err = float("inf")
        check(f"regrid_{method}", err, tol, build_s=build_s, first_s=first_s,
              compile_s=compile_s, wall_s=wall_s, shape=list(got.shape),
              **extra)

    # CentroidLocator: out[target] = source[face holding its centroid].
    regridder, build_s, _ = timed(
        lambda: xu.CentroidLocatorRegridder(uda, target)
    )
    _, first_s, compile_s = timed(lambda: regridder.regrid(uda).values)
    out, wall_s, _ = timed(lambda: np.asarray(regridder.regrid(uda).values))
    coo = regridder._weights
    want = np.full((source.shape[0], target.n_face), np.nan, np.float32)
    want[:, coo.row] = np.take(source, coo.col, axis=1)
    got = out.reshape(want.shape)
    located = np.zeros(target.n_face, bool)
    located[coo.row] = True
    quads = grid.node_coordinates[grid.face_node_connectivity[coo.col]]
    contained = points_in_quads(target.centroids[coo.row], quads)
    exact = np.array_equal(got, want, equal_nan=True)
    err = 0.0 if exact and located.all() and contained.all() else float("inf")
    check("regrid_centroid_locator", err, 0.0, build_s=build_s,
          first_s=first_s, compile_s=compile_s, wall_s=wall_s,
          located=int(located.sum()), contained=int(contained.sum()))


def phase_nearest(grid, n_queries=N_QUERIES, seed=SEED):
    from scipy.spatial import KDTree

    rng = np.random.default_rng(seed + 1)
    lo, hi = grid.node_coordinates.min(0), grid.node_coordinates.max(0)
    points = rng.uniform(lo, hi, (n_queries, 2))
    centroids = grid.face_coordinates
    previous = os.environ.get("XUGRID_TPU_NEAREST")
    os.environ["XUGRID_TPU_NEAREST"] = "device"
    try:
        _, first_s, compile_s = timed(lambda: grid.locate_nearest_face(points))
        got, wall_s, _ = timed(lambda: grid.locate_nearest_face(points))
    finally:
        if previous is None:
            del os.environ["XUGRID_TPU_NEAREST"]
        else:
            os.environ["XUGRID_TPU_NEAREST"] = previous
    d_true, _ = KDTree(centroids).query(points)
    d_got = np.hypot(*(centroids[got] - points).T)
    # Ties allowed: any source at the minimum distance is right.
    err = float(np.max((d_got - d_true) / np.maximum(d_true, 1e-300)))
    check("nearest_device", err, 1e-6, first_s=first_s, compile_s=compile_s,
          wall_s=wall_s, queries=n_queries, sources=len(centroids))


def laplace_relative_residual(conn, filled, gaps):
    """||(D - W) x||_unknowns / ||W_uk x_k||, assembled in float64."""
    W = conn.tocsr().astype(np.float64)
    x = np.asarray(filled, np.float64)
    deg = np.asarray(W.sum(axis=1)).ravel()
    resid = (deg * x - W @ x)[gaps]
    known = np.where(gaps, 0.0, x)
    b = (W @ known)[gaps]
    return float(np.linalg.norm(resid) / np.linalg.norm(b))


def _laplace(phase, grid, seed):
    import xugrid_tpu as xu
    from xugrid_tpu.ugrid import interpolate

    rng = np.random.default_rng(seed)
    x, y = grid.node_coordinates.T
    values = np.sin(x / 17.0) * np.cos(y / 23.0) * 10.0 + 5.0
    gaps = rng.random(grid.n_node) < GAP_FRAC
    values[gaps] = np.nan
    uda = xu.UgridDataArray.from_data(values, grid, facet="node")
    _, first_s, compile_s = timed(
        lambda: uda.ugrid.laplace_interpolate().values
    )
    out, wall_s, _ = timed(
        lambda: np.asarray(uda.ugrid.laplace_interpolate().values)
    )
    info = dict(interpolate.last_solve_info)
    conn = grid.get_connectivity_matrix(grid.node_dimension, xy_weights=True)
    err = laplace_relative_residual(conn, out, gaps)
    assert np.isfinite(out).all(), f"{phase}: unfilled nodes remain"
    assert np.array_equal(out[~gaps], values[~gaps]), f"{phase}: known moved"
    check(phase, err, 1e-4, first_s=first_s, compile_s=compile_s,
          wall_s=wall_s, n_node=grid.n_node, n_unknown=int(gaps.sum()),
          solver=info.get("mode"), iterations=info.get("iterations"))
    return info


def banded_grid(n_side=LAPLACE_SIDE):
    import xugrid_tpu as xu

    x = np.linspace(0.0, float(n_side), n_side + 1)
    return xu.Ugrid2d.from_structured_intervals1d(x, x)


def delaunay_grid(n_points, seed=SEED):
    """Seeded random points, scipy Delaunay, node order shuffled so no
    incidental bandedness survives."""
    from scipy.spatial import Delaunay

    import xugrid_tpu as xu

    rng = np.random.default_rng(seed)
    side = np.sqrt(n_points)
    points = rng.uniform(0.0, side, (n_points, 2))
    tri = Delaunay(points)
    perm = rng.permutation(n_points)
    inv = np.empty(n_points, np.int64)
    inv[perm] = np.arange(n_points)
    faces = inv[tri.simplices]
    # counter-clockwise faces
    p = points[tri.simplices]
    area2 = (p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1]) - (
        p[:, 2, 0] - p[:, 0, 0]
    ) * (p[:, 1, 1] - p[:, 0, 1])
    faces[area2 < 0] = faces[area2 < 0][:, ::-1]
    shuffled = points[perm]
    return xu.Ugrid2d(shuffled[:, 0], shuffled[:, 1], -1, faces)


def phase_laplace(n_side=LAPLACE_SIDE, seed=SEED):
    info = _laplace("laplace_banded", banded_grid(n_side), seed)
    assert info.get("mode") == "dia", f"banded mesh took {info.get('mode')}"
    info = _laplace(
        "laplace_delaunay", delaunay_grid((n_side + 1) ** 2, seed), seed
    )
    assert info.get("mode") == "cg", f"Delaunay mesh took {info.get('mode')}"


def phase_partition(grid, uda, n_part=4):
    import xugrid_tpu as xu

    parts, part_s, _ = timed(lambda: uda.ugrid.partition(n_part=n_part))
    merged, merge_s, _ = timed(lambda: xu.merge_partitions(parts))
    mgrid = merged.grids[0]
    assert (mgrid.n_face, mgrid.n_node) == (grid.n_face, grid.n_node)
    # Faces may be renumbered; values follow their centroid.
    order = np.lexsort(mgrid.centroids.T)
    ref = np.lexsort(grid.centroids.T)
    same_faces = np.array_equal(mgrid.centroids[order], grid.centroids[ref])
    got = np.asarray(merged["v"].values)[..., order]
    want = np.asarray(uda.values)[..., ref]
    exact = same_faces and np.array_equal(got, want, equal_nan=True)
    check("partition_merge", 0.0 if exact else float("inf"), 0.0,
          partition_s=part_s, merge_s=merge_s, n_part=n_part,
          n_face=grid.n_face)


def phase_four(n_side=N_SIDE, t_side=T_SIDE, seed=SEED, n_devices=4):
    from jax.sharding import Mesh

    from __graft_entry__ import jittered_quad_grid, raster_grid, sharded_checks

    mesh = Mesh(np.array(jax.devices()[:n_devices]), ("faces",))
    stats, wall_s, compile_s = timed(
        lambda: sharded_checks(
            mesh, jittered_quad_grid(n_side, seed=seed),
            raster_grid(t_side, float(n_side)),
        )
    )
    err = max(stats["regrid_vs_all-gather_max_rel"],
              stats["regrid_vs_single-device_max_rel"])
    check("sharded", err, 1e-6, wall_s=wall_s, compile_s=compile_s, **stats)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the sharded phase on four GPUs")
    args = parser.parse_args(argv)
    devices = require_gpu(4 if args.four else 1)
    jax.config.update("jax_enable_x64", False)
    from xugrid_tpu.utils import native
    from xugrid_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    report("setup", native_lib=native.get_lib() is not None,
           jax=jax.__version__, devices=len(devices))
    t0 = time.perf_counter()
    if args.four:
        phase_four()
    else:
        grid, target, uda = make_regrid_case()
        phase_regrid(grid, target, uda)
        phase_nearest(grid)
        phase_laplace()
        phase_partition(grid, uda)
    report("total", wall_s=time.perf_counter() - t0)
    print(card_name_and_power(), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind, "count": len(devices)},
    }))


if __name__ == "__main__":
    main()
