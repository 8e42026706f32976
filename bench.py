"""
Benchmark: 1M-face overlap regrid (weight build + apply) and celltree
point location, per BASELINE.json.

Prints ONE JSON line:
  {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...}

The primary metric is the regrid apply throughput in **true** GB/s: the
minimal traffic a perfect kernel must move (window indices + weights
once, the source field once, the output once — no padding).
``pct_of_hbm_peak`` relates it to the device's memory bandwidth from
``PEAKS``; a device missing from that table is an error.
``vs_baseline`` compares against a scipy CSR matvec on the local host
CPU — a proxy for (not a measurement of) the reference's multithreaded
numba apply; see the ``baseline_note`` field.

Runs on jax.devices()[0] and names it, with the card's name and power
limit, in the result.  Set BENCH_SMALL=1 for a quick small run,
BENCH_XL=1 for the 10M-face north-star config.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

import jax
import jax.numpy as jnp

from xugrid_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

SMALL = os.environ.get("BENCH_SMALL") == "1"
XL = os.environ.get("BENCH_XL") == "1"


def best_of(fn, n=2):
    """Run ``fn`` ``n`` times, return (best_seconds, last_result): the
    min over a couple of runs is the stable measure of host phases."""
    best = np.inf
    out = None
    for _ in range(1 if SMALL else n):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return best, out

#: Published peaks per ``device_kind``: memory bandwidth in GB/s.
#: Source: NVIDIA H100 data sheet (SXM part, 80 GB HBM3 at 3.35 TB/s).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0},
}

#: Two-point rep counts for the slope timer.  Low/high must share ONE
#: compiled executable (n_reps is a dynamic fori_loop bound), so the
#: fixed per-call cost F (dispatch, host sync) cancels exactly:
#:   per_pass = (T_hi - T_lo) / (hi - lo).
REPS_LO, REPS_HI = (2, 8) if SMALL else ((10, 40) if XL else (20, 100))


def device_peaks(device) -> dict:
    try:
        return PEAKS[device.device_kind]
    except KeyError:
        raise SystemExit(
            f"no published peak for device kind {device.device_kind!r} "
            f"({device.platform}); add it to bench.PEAKS with its source"
        ) from None


def card_name_and_power() -> str | None:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def slope_time(call):
    """Per-pass seconds via the two-point slope estimator.

    ``call(n_reps)`` must run n_reps passes inside ONE jit dispatch and
    block on the result; n_reps must be a dynamic (non-static) argument
    so both points share one executable.  Returns
    (per_pass_s, dispatch_overhead_s); each point is best-of-2.
    """
    call(REPS_LO)  # compile + warm
    t_lo = t_hi = np.inf
    for _ in range(1 if SMALL else 2):
        t0 = time.perf_counter()
        call(REPS_LO)
        t_lo = min(t_lo, time.perf_counter() - t0)
        t0 = time.perf_counter()
        call(REPS_HI)
        t_hi = min(t_hi, time.perf_counter() - t0)
    p = (t_hi - t_lo) / (REPS_HI - REPS_LO)
    if p <= 0.0:
        # Work too small to resolve against the call's own jitter: report
        # the upper bound (the whole high call per pass), not a slope.
        p = t_hi / REPS_HI
    return p, max(t_lo - REPS_LO * p, 0.0)


def quad_mesh(nx, ny, dx=1.0):
    x = np.arange(nx + 1.0) * dx
    y = np.arange(ny + 1.0) * dx
    yy, xx = np.meshgrid(y, x, indexing="ij")
    verts = np.column_stack([xx.ravel(), yy.ravel()])
    j, i = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    nid = lambda ii, jj: jj * (nx + 1) + ii  # noqa: E731
    faces = np.stack(
        [nid(i, j), nid(i + 1, j), nid(i + 1, j + 1), nid(i, j + 1)], axis=-1
    ).reshape(-1, 4)
    return verts, faces


def _host_calibration():
    """Memcpy GB/s + random-access ns, measured BEFORE any big
    allocations.  Every host-bound number (merge, locate, bvh build,
    weight build, cpu_csr baseline) scales with the host's memory
    system; recording it lets runs on different hosts be compared.
    Reports the BEST of several short trials plus the median."""
    cal = np.arange(12_500_000, dtype=np.int64)   # 100 MB
    ridx = np.random.default_rng(0).integers(0, len(cal), 1_000_000)
    copies, gathers = [], []
    for _ in range(6):
        t0 = time.perf_counter()
        _ = cal.copy()
        copies.append(cal.nbytes / (time.perf_counter() - t0) / 1e9)
        t0 = time.perf_counter()
        _ = cal[ridx]
        gathers.append((time.perf_counter() - t0) / len(ridx) * 1e9)
    return (
        round(max(copies), 2), round(float(np.median(copies)), 2),
        round(min(gathers), 1), round(float(np.median(gathers)), 1),
    )


def main():
    device = jax.devices()[0]
    peaks = device_peaks(device)
    (host_memcpy_best, host_memcpy_med,
     host_gather_best, host_gather_med) = _host_calibration()
    import xugrid_tpu as xu
    from xugrid_tpu.core.sparse import MatrixCSR, PaddedCSR
    from xugrid_tpu.regrid import reduce as reductions
    from xugrid_tpu.regrid.apply import _apply_windowed_T, _pad_minor

    if SMALL:
        n_side, t_side, n_extra, n_points = 100, 64, 4, 4096
    elif XL:
        # BASELINE.json north star: 10M-face mesh, national-scale raster.
        n_side, t_side, n_extra, n_points = 3163, 1024, 20, 1_000_000
    else:
        n_side, t_side, n_extra, n_points = 1000, 512, 20, 1_000_000

    rng = np.random.default_rng(42)

    # --- source mesh: n_side^2 quads, jittered interior nodes ----------
    verts, faces = quad_mesh(n_side, n_side)
    jitter = rng.uniform(-0.15, 0.15, verts.shape)
    edge = (
        (verts[:, 0] == 0)
        | (verts[:, 1] == 0)
        | (verts[:, 0] == n_side)
        | (verts[:, 1] == n_side)
    )
    jitter[edge] = 0.0
    verts = verts + jitter
    grid = xu.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)

    # --- weight build: overlap with a t_side^2 raster -------------------
    dx = n_side / t_side
    tverts, tfaces = quad_mesh(t_side, t_side, dx=dx)
    target = xu.Ugrid2d(tverts[:, 0], tverts[:, 1], -1, tfaces)

    def build_tree():
        grid._celltree = None
        return grid.celltree

    bvh_build_s, tree = best_of(build_tree)

    weight_build_s, (ti, si, areas) = best_of(
        lambda: tree.intersect_faces(
            target.node_coordinates, target.face_node_connectivity, -1
        )
    )
    csr = MatrixCSR.from_triplet(ti, si, areas, n=target.n_face, m=grid.n_face)
    padded = PaddedCSR.from_csr(csr, dtype=np.float32)

    # --- true per-pass traffic (all n_extra slices ride one pass) -------
    # indices+weights once, source once, output once; no padding.
    true_bytes = (
        csr.nnz * (4 + 4)
        + grid.n_face * n_extra * 4
        + target.n_face * n_extra * 4
    )

    source = rng.normal(size=(n_extra, grid.n_face)).astype(np.float32)

    # --- XLA window-gather apply (the general path) ----------------------
    # Slice-minor layout: the extra dimension on the minor axis so every
    # gather fetches a contiguous row (see regrid/apply.py).
    E = _pad_minor(n_extra)
    sourceT = np.zeros((grid.n_face, E), dtype=np.float32)
    sourceT[:, :n_extra] = source.T
    src_d = jnp.asarray(sourceT)

    # Chunk the target dimension so the (n, w, E) gather intermediate
    # stays within device memory at the 10M-face scale.
    n_chunks = max(1, -(-padded.n * padded.w_max * E // 200_000_000))
    rows = -(-padded.n // n_chunks)
    n_pad_rows = n_chunks * rows
    idx_p = np.full((n_pad_rows, padded.w_max), -1, padded.indices.dtype)
    idx_p[: padded.n] = padded.indices
    w_p = np.zeros((n_pad_rows, padded.w_max), padded.weights.dtype)
    w_p[: padded.n] = padded.weights
    idx_d = jnp.asarray(idx_p.reshape(n_chunks, rows, padded.w_max))
    w_d = jnp.asarray(w_p.reshape(n_chunks, rows, padded.w_max))

    # Loop the passes inside one jit call so per-call dispatch does not
    # enter the per-pass time.
    from functools import partial

    @partial(jax.jit, static_argnums=(3,))
    def apply_reps(srcT, idx, w, reduction, n_reps):
        def body(i, carry):
            src, acc = carry

            def chunk_body(c, acc2):
                out = _apply_windowed_T(src, idx[c], w[c], reduction)
                return acc2 + jnp.nansum(out)

            acc = jax.lax.fori_loop(0, idx.shape[0], chunk_body, acc)
            # Carry the source and touch ONE element per rep: defeats
            # loop-invariant hoisting of the apply without re-streaming
            # the whole array (the old +i*1e-12 full-array perturbation
            # added a spurious HBM read+write per rep).
            src = src.at[0, 0].add(jnp.float32(1e-12))
            return (src, acc)

        _, acc = jax.lax.fori_loop(
            0, n_reps, body, (srcT, jnp.float32(0.0))
        )
        return acc

    checksum = float(
        apply_reps(src_d, idx_d, w_d, reductions.mean, jnp.int32(REPS_LO))
    )
    xla_apply_s, dispatch_overhead_s = slope_time(
        lambda r: float(
            apply_reps(src_d, idx_d, w_d, reductions.mean, jnp.int32(r))
        )
    )
    apply_gbps = true_bytes / xla_apply_s / 1e9

    # --- celltree locate throughput -------------------------------------
    # Free the apply's device buffers first: at the 10M-face scale the
    # source slabs are GBs of HBM and the locate kernels need headroom.
    import gc

    del src_d, idx_d, w_d
    gc.collect()

    pts = rng.uniform(0.5, n_side - 0.5, (n_points, 2))
    found = tree.locate_points(pts)  # compile + warm
    # Best-of-5: the min is the stable measure of the pipeline's cost.
    best_locate_s = np.inf
    for _ in range(5):
        t0 = time.perf_counter()
        found = tree.locate_points(pts)
        best_locate_s = min(best_locate_s, time.perf_counter() - t0)
    locate_qps = n_points / best_locate_s
    hit_rate = float((found >= 0).mean())

    # --- 4-way partition/merge round trip (sort-based dedup kernel) ----
    from xugrid_tpu.ugrid.partitioning import labels_to_indices, partition_labels

    labels = partition_labels(grid.centroids, 4)
    parts = [
        grid.topology_subset(index)
        for index in labels_to_indices(labels)
    ]
    merge_s, (merged_grid, _) = best_of(
        lambda: parts[0].merge_partitions(parts)
    )
    assert merged_grid.n_face == grid.n_face

    # --- host CPU baseline: scipy CSR matvec (the C-speed equivalent of
    # the reference's numba apply loop, single-threaded on this host) ---
    import scipy.sparse

    W = scipy.sparse.csr_matrix(
        (csr.data, csr.indices, csr.indptr), shape=(csr.n, csr.m)
    ).astype(np.float32)
    wsum = np.asarray(W.sum(axis=1)).ravel()
    wsum[wsum == 0] = 1.0
    _ = W @ source[0]  # warm
    t0 = time.perf_counter()
    for k in range(n_extra):
        _ = (W @ source[k]) / wsum
    cpu_apply_s = time.perf_counter() - t0
    cpu_gbps = true_bytes / cpu_apply_s / 1e9

    result = {
        "metric": f"{grid.n_face}-face overlap regrid apply throughput",
        "value": round(apply_gbps, 3),
        "unit": "GB/s (true bytes)",
        "vs_baseline": round(apply_gbps / cpu_gbps, 3),
        "baseline_note": (
            "vs_baseline is measured against a single-threaded scipy CSR "
            "matvec on this host, a proxy for (not a measurement of) the "
            "reference's multithreaded numba apply on a many-core node"
        ),
        # A FRACTION expressed in percent (1.0 == 1% of the peak).
        "pct_of_hbm_peak": round(100.0 * apply_gbps / peaks["hbm_gbps"], 2),
        "true_bytes_per_pass": int(true_bytes),
        "apply_s_per_pass": xla_apply_s,
        "weight_build_s": weight_build_s,
        "bvh_build_s": bvh_build_s,
        "cpu_csr_gbps_true": cpu_gbps,
        "locate_queries_per_s": locate_qps,
        "locate_hit_rate": hit_rate,
        "merge_4way_s": merge_s,
        "host_memcpy_gbps_best": host_memcpy_best,
        "host_memcpy_gbps_median": host_memcpy_med,
        "host_random_access_ns_best": host_gather_best,
        "host_random_access_ns_median": host_gather_med,
        "nnz": int(csr.nnz),
        "n_extra": n_extra,
        "checksum": checksum,
        "timing_method": (
            f"two-point slope over one executable (reps {REPS_LO}/"
            f"{REPS_HI}); cancels the per-call fixed cost"
        ),
        "dispatch_overhead_s": dispatch_overhead_s,
        "device": {
            "platform": device.platform,
            "kind": device.device_kind,
            "count": len(jax.devices()),
            "card": card_name_and_power(),
        },
        "peaks": peaks,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
