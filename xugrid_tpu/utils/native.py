"""
ctypes bindings for the native host kernels (csrc/host_kernels.cpp).

The shared library is compiled on demand with g++ into
``<repo>/.native_build`` (``XUGRID_TPU_BUILD_DIR`` overrides); every
entry point has a pure-numpy fallback so the framework works without a
toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_LIB = None
_TRIED = False

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
_SOURCE = _REPO_ROOT / "csrc" / "host_kernels.cpp"
_BUILD_DIR = Path(
    os.environ.get("XUGRID_TPU_BUILD_DIR", _REPO_ROOT / ".native_build")
)


#: -ffp-contract=off: the exact-geometry kernels (clip, PIP, mean-value
#: weights) document bit-for-bit parity with their numpy/device
#: fallbacks; FMA contraction under -O3 -march=native breaks it at
#: 1 ulp on boundary-grazing inputs (inside/outside flips between
#: native-present and fallback environments).
_CFLAGS = (
    "-O3", "-march=native", "-ffp-contract=off",
    "-shared", "-fPIC", "-std=c++17", "-pthread",
) + tuple(os.environ.get("XUGRID_TPU_NATIVE_CFLAGS", "").split())


def _compile() -> Path | None:
    if not _SOURCE.exists():
        return None
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Flags participate in the cache name: a flags-only change must not
    # keep serving a stale library (mtime covers the source only).
    import hashlib

    tag = hashlib.blake2b(
        " ".join(_CFLAGS).encode(), digest_size=6
    ).hexdigest()
    lib_path = _BUILD_DIR / f"libhost_kernels-{tag}.so"
    if lib_path.exists() and lib_path.stat().st_mtime >= _SOURCE.stat().st_mtime:
        return lib_path
    # Compile to a process-unique temp path and publish with an atomic
    # rename: concurrent builders (pytest + bench, shard workers) must
    # never observe — or dlopen — a half-written library.
    tmp_path = lib_path.with_suffix(f".so.tmp{os.getpid()}")
    cmd = [
        "g++",
        *_CFLAGS,
        str(_SOURCE),
        "-o",
        str(tmp_path),
    ]
    try:
        subprocess.run(
            cmd, check=True, capture_output=True, timeout=120
        )
        os.replace(tmp_path, lib_path)
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        try:
            tmp_path.unlink(missing_ok=True)
        except OSError:
            pass
        return None
    return lib_path


def get_lib():
    """The loaded native library, or None when unavailable."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _compile()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.kd_order.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.kd_order.restype = None
    lib.hilbert_distance.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.hilbert_distance.restype = None
    _c_double_p = ctypes.POINTER(ctypes.c_double)
    _c_int64_p = ctypes.POINTER(ctypes.c_int64)
    lib.face_bbox.argtypes = [
        _c_int64_p,
        ctypes.c_int64,
        ctypes.c_int64,
        _c_double_p,
        _c_double_p,
        _c_double_p,
    ]
    lib.face_bbox.restype = None
    lib.pad_and_bbox.argtypes = [
        _c_int64_p,
        ctypes.c_int64,
        ctypes.c_int64,
        _c_double_p,
        _c_double_p,
        _c_double_p,
        _c_double_p,
    ]
    lib.pad_and_bbox.restype = None
    _gh_common = [
        _c_double_p,
        ctypes.c_int64,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_int64,
        ctypes.c_int64,
    ]
    lib.grid_hash_count.argtypes = _gh_common + [_c_int64_p]
    lib.grid_hash_count.restype = ctypes.c_int64
    lib.grid_hash_fill.argtypes = (
        [_c_double_p, _c_int64_p, ctypes.c_int64]
        + _gh_common[2:]
        + [_c_int64_p, _c_int64_p]
    )
    lib.grid_hash_fill.restype = None
    _pts_common = [
        _c_double_p,
        ctypes.c_int64,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_int64,
        ctypes.c_int64,
        _c_int64_p,
        _c_int64_p,
        _c_double_p,
    ]
    lib.grid_hash_points_count.argtypes = _pts_common + [_c_int64_p]
    lib.grid_hash_points_count.restype = None
    lib.grid_hash_points_fill.argtypes = _pts_common + [
        _c_int64_p,
        _c_int64_p,
        _c_int64_p,
    ]
    lib.grid_hash_points_fill.restype = None
    _box_common = [
        _c_double_p,
        ctypes.c_int64,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_int64,
        ctypes.c_int64,
        _c_int64_p,
        _c_int64_p,
        _c_double_p,
    ]
    lib.grid_hash_boxes_count.argtypes = _box_common + [_c_int64_p]
    lib.grid_hash_boxes_count.restype = None
    lib.grid_hash_boxes_fill.argtypes = _box_common + [
        _c_int64_p,
        _c_int64_p,
        _c_int64_p,
    ]
    lib.grid_hash_boxes_fill.restype = None
    lib.polygon_clip_areas.argtypes = [
        _c_int64_p,
        _c_int64_p,
        ctypes.c_int64,
        _c_double_p,
        ctypes.c_int64,
        _c_double_p,
        ctypes.c_int64,
        _c_double_p,
    ]
    lib.polygon_clip_areas.restype = None
    _c_uint8_p = ctypes.POINTER(ctypes.c_uint8)
    lib.points_in_polygons.argtypes = [
        _c_double_p,
        _c_int64_p,
        ctypes.c_int64,
        _c_double_p,
        ctypes.c_int64,
        ctypes.c_double,
        _c_uint8_p,
    ]
    lib.points_in_polygons.restype = None
    lib.clip_segments_by_faces.argtypes = [
        _c_double_p,
        _c_double_p,
        _c_int64_p,
        ctypes.c_int64,
        _c_double_p,
        ctypes.c_int64,
        _c_uint8_p,
        _c_double_p,
        _c_double_p,
    ]
    lib.clip_segments_by_faces.restype = None
    lib.mean_value_weights.argtypes = [
        _c_double_p,
        _c_int64_p,
        ctypes.c_int64,
        _c_double_p,
        ctypes.c_int64,
        ctypes.c_double,
        _c_double_p,
    ]
    lib.mean_value_weights.restype = None
    lib.unique_rows_hash.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_int64,
        _c_int64_p,
        _c_int64_p,
    ]
    lib.unique_rows_hash.restype = ctypes.c_int64
    lib.unique_sorted_rows_hash.argtypes = [
        _c_int64_p,
        ctypes.c_int64,
        ctypes.c_int64,
        _c_int64_p,
        _c_int64_p,
    ]
    lib.unique_sorted_rows_hash.restype = ctypes.c_int64
    lib.topo_sort_dfs.argtypes = [
        _c_int64_p,
        _c_int64_p,
        ctypes.c_int64,
        _c_int64_p,
    ]
    lib.topo_sort_dfs.restype = ctypes.c_int64
    lib.contract_vertices_walk.argtypes = [
        _c_int64_p,
        _c_int64_p,
        ctypes.c_int64,
        _c_int64_p,
        ctypes.c_int64,
        _c_int64_p,
        ctypes.c_int64,
    ]
    lib.contract_vertices_walk.restype = ctypes.c_int64
    lib.snap_to_nearest_greedy.argtypes = [
        _c_int64_p,
        _c_int64_p,
        _c_double_p,
        ctypes.c_int64,
        _c_int64_p,
        ctypes.c_int64,
        ctypes.c_double,
        _c_int64_p,
    ]
    lib.snap_to_nearest_greedy.restype = None
    lib.locate_points_hash.argtypes = [
        _c_double_p,
        ctypes.c_int64,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_int64,
        ctypes.c_int64,
        _c_int64_p,
        _c_int64_p,
        _c_double_p,
        _c_double_p,
        ctypes.c_int64,
        _c_int64_p,
    ]
    lib.locate_points_hash.restype = None
    lib.polygon_clip_areas_conn.argtypes = [
        _c_int64_p,
        _c_int64_p,
        ctypes.c_int64,
        _c_double_p,
        ctypes.c_int64,
        _c_int64_p,
        ctypes.c_int64,
        _c_double_p,
        _c_double_p,
        _c_double_p,
    ]
    lib.polygon_clip_areas_conn.restype = None
    lib.face_centroids.argtypes = [
        _c_int64_p,
        ctypes.c_int64,
        ctypes.c_int64,
        _c_double_p,
        _c_double_p,
        _c_double_p,
    ]
    lib.face_centroids.restype = None
    lib.csr_from_triplet.argtypes = [
        _c_int64_p,
        _c_int64_p,
        _c_double_p,
        ctypes.c_int64,
        ctypes.c_int64,
        _c_int64_p,
        _c_int64_p,
        _c_double_p,
    ]
    lib.csr_from_triplet.restype = None
    lib.padded_layout.argtypes = [
        _c_int64_p,
        _c_int64_p,
        _c_double_p,
        ctypes.c_int64,
        ctypes.c_int64,
        _c_int64_p,
        _c_int64_p,
        _c_int64_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.padded_layout.restype = ctypes.c_int64
    _LIB = lib
    return _LIB


def kd_order_native(xy: np.ndarray, n_levels: int, capacity: int):
    """Native kd_order, or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    xy = np.ascontiguousarray(xy, dtype=np.float64)
    out = np.empty(len(xy), dtype=np.int64)
    lib.kd_order(
        xy.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(xy),
        n_levels,
        capacity,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out


def face_bbox_native(faces: np.ndarray, x: np.ndarray, y: np.ndarray):
    """Native per-face AABBs, or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    faces = np.ascontiguousarray(faces, dtype=np.int64)
    x = np.ascontiguousarray(x, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64)
    n, nv = faces.shape
    out = np.empty((n, 4), dtype=np.float64)
    _dp = ctypes.POINTER(ctypes.c_double)
    lib.face_bbox(
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        nv,
        x.ctypes.data_as(_dp),
        y.ctypes.data_as(_dp),
        out.ctypes.data_as(_dp),
    )
    return out


def pad_and_bbox_native(faces: np.ndarray, x: np.ndarray, y: np.ndarray):
    """
    Fused padded polygon buffer (n, nv, 2) + per-face AABBs (n, 4) in a
    single native pass, or None when the library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    faces = np.ascontiguousarray(faces, dtype=np.int64)
    x = np.ascontiguousarray(x, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64)
    n, nv = faces.shape
    poly_xy = np.empty((n, nv, 2), dtype=np.float64)
    bbox = np.empty((n, 4), dtype=np.float64)
    _dp = ctypes.POINTER(ctypes.c_double)
    lib.pad_and_bbox(
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        nv,
        x.ctypes.data_as(_dp),
        y.ctypes.data_as(_dp),
        poly_xy.ctypes.data_as(_dp),
        bbox.ctypes.data_as(_dp),
    )
    return poly_xy, bbox


def grid_hash_bins_native(
    boxes: np.ndarray,
    ids: np.ndarray,
    xmin: float,
    ymin: float,
    dx: float,
    dy: float,
    nx: int,
    ny: int,
):
    """
    Native grid-hash binning: (bin_start (nx*ny+1), bin_prims (total)),
    or None when the library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    boxes = np.ascontiguousarray(boxes, dtype=np.float64)
    if ids is not None:
        ids = np.ascontiguousarray(ids, dtype=np.int64)
    k = len(boxes)
    bin_start = np.zeros(nx * ny + 1, dtype=np.int64)
    _dp = ctypes.POINTER(ctypes.c_double)
    _ip = ctypes.POINTER(ctypes.c_int64)
    total = lib.grid_hash_count(
        boxes.ctypes.data_as(_dp),
        k,
        xmin,
        ymin,
        dx,
        dy,
        nx,
        ny,
        bin_start.ctypes.data_as(_ip),
    )
    bin_prims = np.empty(total, dtype=np.int64)
    cursor = bin_start[:-1].copy()
    lib.grid_hash_fill(
        boxes.ctypes.data_as(_dp),
        ids.ctypes.data_as(_ip) if ids is not None else None,
        k,
        xmin,
        ymin,
        dx,
        dy,
        nx,
        ny,
        cursor.ctypes.data_as(_ip),
        bin_prims.ctypes.data_as(_ip),
    )
    return bin_start, bin_prims


def grid_hash_query_points_native(
    pts: np.ndarray,
    tol: float,
    xmin: float,
    ymin: float,
    dx: float,
    dy: float,
    nx: int,
    ny: int,
    bin_start: np.ndarray,
    bin_prims: np.ndarray,
    boxes: np.ndarray,
):
    """
    Native point candidate join: (pair_q, pair_p) int64 arrays, or None
    when the library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    bin_start = np.ascontiguousarray(bin_start, dtype=np.int64)
    bin_prims = np.ascontiguousarray(bin_prims, dtype=np.int64)
    boxes = np.ascontiguousarray(boxes, dtype=np.float64)
    nq = len(pts)
    counts = np.empty(nq, dtype=np.int64)
    _dp = ctypes.POINTER(ctypes.c_double)
    _ip = ctypes.POINTER(ctypes.c_int64)
    common = (
        pts.ctypes.data_as(_dp),
        nq,
        tol,
        xmin,
        ymin,
        dx,
        dy,
        nx,
        ny,
        bin_start.ctypes.data_as(_ip),
        bin_prims.ctypes.data_as(_ip),
        boxes.ctypes.data_as(_dp),
    )
    lib.grid_hash_points_count(*common, counts.ctypes.data_as(_ip))
    offsets = np.zeros(nq, dtype=np.int64)
    np.cumsum(counts[:-1], out=offsets[1:])
    total = int(offsets[-1] + counts[-1]) if nq else 0
    pair_q = np.empty(total, dtype=np.int64)
    pair_p = np.empty(total, dtype=np.int64)
    lib.grid_hash_points_fill(
        *common,
        offsets.ctypes.data_as(_ip),
        pair_q.ctypes.data_as(_ip),
        pair_p.ctypes.data_as(_ip),
    )
    return pair_q, pair_p


def grid_hash_query_boxes_native(
    qb: np.ndarray,
    xmin: float,
    ymin: float,
    dx: float,
    dy: float,
    nx: int,
    ny: int,
    bin_start: np.ndarray,
    bin_prims: np.ndarray,
    boxes: np.ndarray,
):
    """
    Native box candidate join with inline canonical-cell dedup:
    (pair_q, pair_p) int64 arrays, or None when the library is
    unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    qb = np.ascontiguousarray(qb, dtype=np.float64)
    bin_start = np.ascontiguousarray(bin_start, dtype=np.int64)
    bin_prims = np.ascontiguousarray(bin_prims, dtype=np.int64)
    boxes = np.ascontiguousarray(boxes, dtype=np.float64)
    nq = len(qb)
    counts = np.empty(nq, dtype=np.int64)
    _dp = ctypes.POINTER(ctypes.c_double)
    _ip = ctypes.POINTER(ctypes.c_int64)
    common = (
        qb.ctypes.data_as(_dp),
        nq,
        xmin,
        ymin,
        dx,
        dy,
        nx,
        ny,
        bin_start.ctypes.data_as(_ip),
        bin_prims.ctypes.data_as(_ip),
        boxes.ctypes.data_as(_dp),
    )
    lib.grid_hash_boxes_count(*common, counts.ctypes.data_as(_ip))
    offsets = np.zeros(nq, dtype=np.int64)
    if nq:
        np.cumsum(counts[:-1], out=offsets[1:])
    total = int(offsets[-1] + counts[-1]) if nq else 0
    pair_q = np.empty(total, dtype=np.int64)
    pair_p = np.empty(total, dtype=np.int64)
    lib.grid_hash_boxes_fill(
        *common,
        offsets.ctypes.data_as(_ip),
        pair_q.ctypes.data_as(_ip),
        pair_p.ctypes.data_as(_ip),
    )
    return pair_q, pair_p


def polygon_clip_areas_native(
    pair_q: np.ndarray,
    pair_p: np.ndarray,
    query_xy: np.ndarray,
    tree_xy: np.ndarray,
):
    """
    Native convex clip areas per candidate pair (Sutherland-Hodgman), or
    None when the library is unavailable or the combined vertex count
    could overflow the kernel's fixed working buffer (kCap=96: a
    convex-convex intersection has at most m+k vertices).
    """
    lib = get_lib()
    if lib is None or query_xy.shape[1] + tree_xy.shape[1] > 96:
        return None
    pair_q = np.ascontiguousarray(pair_q, dtype=np.int64)
    pair_p = np.ascontiguousarray(pair_p, dtype=np.int64)
    query_xy = np.ascontiguousarray(query_xy, dtype=np.float64)
    tree_xy = np.ascontiguousarray(tree_xy, dtype=np.float64)
    n = len(pair_q)
    areas = np.empty(n, dtype=np.float64)
    _dp = ctypes.POINTER(ctypes.c_double)
    _ip = ctypes.POINTER(ctypes.c_int64)
    lib.polygon_clip_areas(
        pair_q.ctypes.data_as(_ip),
        pair_p.ctypes.data_as(_ip),
        n,
        query_xy.ctypes.data_as(_dp),
        query_xy.shape[1],
        tree_xy.ctypes.data_as(_dp),
        tree_xy.shape[1],
        areas.ctypes.data_as(_dp),
    )
    return areas


def points_in_polygons_native(
    pts: np.ndarray, prims: np.ndarray, poly_xy: np.ndarray, tol: float
):
    """Native pairwise point-in-polygon, or None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    prims = np.ascontiguousarray(prims, dtype=np.int64)
    poly_xy = np.ascontiguousarray(poly_xy, dtype=np.float64)
    n = len(pts)
    out = np.empty(n, dtype=np.uint8)
    _dp = ctypes.POINTER(ctypes.c_double)
    _ip = ctypes.POINTER(ctypes.c_int64)
    lib.points_in_polygons(
        pts.ctypes.data_as(_dp),
        prims.ctypes.data_as(_ip),
        n,
        poly_xy.ctypes.data_as(_dp),
        poly_xy.shape[1],
        float(tol),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out.astype(bool)


def clip_segments_by_faces_native(
    p0: np.ndarray, p1: np.ndarray, prims: np.ndarray, poly_xy: np.ndarray
):
    """Native pairwise segment clip: (valid, t0, t1) or None."""
    lib = get_lib()
    if lib is None:
        return None
    p0 = np.ascontiguousarray(p0, dtype=np.float64)
    p1 = np.ascontiguousarray(p1, dtype=np.float64)
    prims = np.ascontiguousarray(prims, dtype=np.int64)
    poly_xy = np.ascontiguousarray(poly_xy, dtype=np.float64)
    n = len(prims)
    valid = np.empty(n, dtype=np.uint8)
    t0 = np.empty(n, dtype=np.float64)
    t1 = np.empty(n, dtype=np.float64)
    _dp = ctypes.POINTER(ctypes.c_double)
    lib.clip_segments_by_faces(
        p0.ctypes.data_as(_dp),
        p1.ctypes.data_as(_dp),
        prims.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        poly_xy.ctypes.data_as(_dp),
        poly_xy.shape[1],
        valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        t0.ctypes.data_as(_dp),
        t1.ctypes.data_as(_dp),
    )
    return valid.astype(bool), t0, t1


def mean_value_weights_native(
    pts: np.ndarray, prims: np.ndarray, poly_xy: np.ndarray, tol: float
):
    """Native pairwise mean-value coordinates, or None when unavailable."""
    lib = get_lib()
    if lib is None or poly_xy.shape[1] > 64:
        return None
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    prims = np.ascontiguousarray(prims, dtype=np.int64)
    poly_xy = np.ascontiguousarray(poly_xy, dtype=np.float64)
    n = len(pts)
    out = np.empty((n, poly_xy.shape[1]), dtype=np.float64)
    _dp = ctypes.POINTER(ctypes.c_double)
    lib.mean_value_weights(
        pts.ctypes.data_as(_dp),
        prims.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        poly_xy.ctypes.data_as(_dp),
        poly_xy.shape[1],
        float(tol),
        out.ctypes.data_as(_dp),
    )
    return out


def hilbert_distance_native(xy: np.ndarray, order: int = 16):
    """Native Hilbert distances, or None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    xy = np.ascontiguousarray(xy, dtype=np.float64)
    lo = xy.min(axis=0)
    hi = xy.max(axis=0)
    extent = np.maximum(hi - lo, 1e-300)
    out = np.empty(len(xy), dtype=np.uint64)
    lib.hilbert_distance(
        xy.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(xy),
        order,
        float(lo[0]),
        float(lo[1]),
        float(extent[0]),
        float(extent[1]),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    return out


def unique_rows_hash_native(rows: np.ndarray):
    """
    Hash-based bytewise row dedup in first-seen order: (rep, inverse,
    count), or None when the library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows)
    n = len(rows)
    row_bytes = rows.dtype.itemsize * int(np.prod(rows.shape[1:]))
    rep = np.empty(n, dtype=np.int64)
    inverse = np.empty(n, dtype=np.int64)
    _ip = ctypes.POINTER(ctypes.c_int64)
    count = lib.unique_rows_hash(
        rows.ctypes.data_as(ctypes.c_char_p),
        n,
        row_bytes,
        rep.ctypes.data_as(_ip),
        inverse.ctypes.data_as(_ip),
    )
    return rep[:count], inverse, int(count)


def unique_sorted_rows_native(rows: np.ndarray):
    """
    Orientation-insensitive row dedup: rows of int64 node ids are
    canonicalized by sorting WITHIN each row, then deduplicated
    bytewise in first-seen order — all in one native pass (no
    np.sort(axis=1) materialization).  Returns (rep, inverse, count),
    or None when the library is unavailable or the width exceeds 64.
    """
    lib = get_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    n, width = rows.shape
    if width > 64:
        return None
    rep = np.empty(n, dtype=np.int64)
    inverse = np.empty(n, dtype=np.int64)
    _ip = ctypes.POINTER(ctypes.c_int64)
    count = lib.unique_sorted_rows_hash(
        rows.ctypes.data_as(_ip),
        n,
        width,
        rep.ctypes.data_as(_ip),
        inverse.ctypes.data_as(_ip),
    )
    if count < 0:
        return None
    return rep[:count], inverse, int(count)


def topo_sort_dfs_native(indptr: np.ndarray, indices: np.ndarray, m: int):
    """Native DFS topological sort: order array, or None (library
    unavailable).  Raises ValueError on a cycle."""
    lib = get_lib()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    out = np.empty(m, dtype=np.int64)
    _ip = ctypes.POINTER(ctypes.c_int64)
    rc = lib.topo_sort_dfs(
        indptr.ctypes.data_as(_ip),
        indices.ctypes.data_as(_ip),
        m,
        out.ctypes.data_as(_ip),
    )
    if rc == -1:
        raise ValueError("The graph contains at least one cycle")
    return out


def contract_vertices_native(
    indptr: np.ndarray, indices: np.ndarray, m: int, keep: np.ndarray
):
    """Native downstream-walk contraction: (n_edge, 2) array, or None
    (library unavailable).  Raises ValueError on a cycle."""
    lib = get_lib()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    keep = np.ascontiguousarray(keep, dtype=np.int64)
    # The C kernel writes keep-flags with no bounds check: an
    # out-of-range index corrupts the heap/segfaults instead of
    # raising like the numpy fallback.
    if len(keep) and (keep.min() < 0 or keep.max() >= m):
        raise IndexError(
            f"contract_vertices: keep indices out of range [0, {m})"
        )
    _ip = ctypes.POINTER(ctypes.c_int64)
    cap = max(4 * len(indices), 4 * len(keep), 1024)
    while True:
        out = np.empty((cap, 2), dtype=np.int64)
        rc = lib.contract_vertices_walk(
            indptr.ctypes.data_as(_ip),
            indices.ctypes.data_as(_ip),
            m,
            keep.ctypes.data_as(_ip),
            len(keep),
            out.ctypes.data_as(_ip),
            cap,
        )
        if rc == -1:
            raise ValueError("The graph contains at least one cycle")
        if rc == -2:
            cap *= 4
            continue
        return out[:rc]


def snap_to_nearest_native(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    n: int,
    candidates: np.ndarray,
    max_distance: float,
):
    """Native greedy snap assignment: visited array, or None."""
    lib = get_lib()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    data = np.ascontiguousarray(data, dtype=np.float64)
    candidates = np.ascontiguousarray(candidates, dtype=np.int64)
    visited = np.empty(n, dtype=np.int64)
    _ip = ctypes.POINTER(ctypes.c_int64)
    lib.snap_to_nearest_greedy(
        indptr.ctypes.data_as(_ip),
        indices.ctypes.data_as(_ip),
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n,
        candidates.ctypes.data_as(_ip),
        len(candidates),
        float(max_distance),
        visited.ctypes.data_as(_ip),
    )
    return visited


def locate_points_hash_native(
    pts: np.ndarray,
    tol: float,
    grid_hash,
    poly_xy: np.ndarray,
):
    """Fused grid-hash + exact point location: lowest containing face
    per point (-1 miss), or None when the library is unavailable or the
    hash carries oversize primitives (those bypass the bins)."""
    lib = get_lib()
    if lib is None or len(grid_hash.oversize) > 0:
        return None
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    poly_xy = np.ascontiguousarray(poly_xy, dtype=np.float64)
    boxes = np.ascontiguousarray(grid_hash.boxes, dtype=np.float64)
    out = np.empty(len(pts), dtype=np.int64)
    _dp = ctypes.POINTER(ctypes.c_double)
    _ip = ctypes.POINTER(ctypes.c_int64)
    lib.locate_points_hash(
        pts.ctypes.data_as(_dp),
        len(pts),
        float(tol),
        grid_hash.xmin,
        grid_hash.ymin,
        grid_hash.dx,
        grid_hash.dy,
        grid_hash.nx,
        grid_hash.ny,
        np.ascontiguousarray(grid_hash.bin_start, np.int64).ctypes.data_as(_ip),
        np.ascontiguousarray(grid_hash.bin_prims, np.int64).ctypes.data_as(_ip),
        boxes.ctypes.data_as(_dp),
        poly_xy.ctypes.data_as(_dp),
        poly_xy.shape[1],
        out.ctypes.data_as(_ip),
    )
    return out


def polygon_clip_areas_conn_native(
    pair_q: np.ndarray,
    pair_p: np.ndarray,
    query_xy: np.ndarray,
    tree_faces: np.ndarray,
    x: np.ndarray,
    y: np.ndarray,
):
    """Clip areas gathering tree polygons from connectivity (skips the
    padded tree vertex buffer), or None when unavailable."""
    lib = get_lib()
    # Same kCap=96 working-buffer guard as polygon_clip_areas_native:
    # the Sutherland-Hodgman kernel silently truncates once the subject
    # plus clip vertex counts exceed the cap (wrong overlap areas).
    if (
        lib is None
        or tree_faces.shape[1] > 32
        or query_xy.shape[1] + tree_faces.shape[1] > 96
    ):
        return None
    pair_q = np.ascontiguousarray(pair_q, dtype=np.int64)
    pair_p = np.ascontiguousarray(pair_p, dtype=np.int64)
    query_xy = np.ascontiguousarray(query_xy, dtype=np.float64)
    tree_faces = np.ascontiguousarray(tree_faces, dtype=np.int64)
    x = np.ascontiguousarray(x, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64)
    areas = np.empty(len(pair_q), dtype=np.float64)
    _dp = ctypes.POINTER(ctypes.c_double)
    _ip = ctypes.POINTER(ctypes.c_int64)
    lib.polygon_clip_areas_conn(
        pair_q.ctypes.data_as(_ip),
        pair_p.ctypes.data_as(_ip),
        len(pair_q),
        query_xy.ctypes.data_as(_dp),
        query_xy.shape[1],
        tree_faces.ctypes.data_as(_ip),
        tree_faces.shape[1],
        x.ctypes.data_as(_dp),
        y.ctypes.data_as(_dp),
        areas.ctypes.data_as(_dp),
    )
    return areas


def face_centroids_native(faces: np.ndarray, x: np.ndarray, y: np.ndarray):
    """Native area-weighted polygon centroids, or None when the library
    is unavailable.  One pass per face — the numpy path's padded closed
    coordinate temporaries cost ~60 s at 10M quads on the bench host."""
    lib = get_lib()
    if lib is None:
        return None
    # Degenerate (n, 3) connectivities carrying fills would need
    # numpy's negative-index wraparound; leave them to the fallback.
    if faces.shape[1] == 3 and faces.min() < 0:
        return None
    faces = np.ascontiguousarray(faces, dtype=np.int64)
    x = np.ascontiguousarray(x, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64)
    out = np.empty((len(faces), 2), dtype=np.float64)
    _dp = ctypes.POINTER(ctypes.c_double)
    lib.face_centroids(
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        faces.shape[0],
        faces.shape[1],
        x.ctypes.data_as(_dp),
        y.ctypes.data_as(_dp),
        out.ctypes.data_as(_dp),
    )
    return out


def csr_from_triplet_native(
    row: np.ndarray, col: np.ndarray, data: np.ndarray, n: int
):
    """Stable counting-sort CSR build (exact parity with the numpy
    stable-argsort path), or None when the library is unavailable.
    Returns (data_sorted, col_sorted, indptr)."""
    lib = get_lib()
    if lib is None:
        return None
    # Dtype passthrough parity with the numpy path (non-f64 data stays
    # untouched there) and memory safety: an out-of-range row would be
    # an IndexError in numpy but heap corruption in C.
    if np.asarray(data).dtype != np.float64:
        return None
    row = np.ascontiguousarray(row, dtype=np.int64)
    if len(row) and (row.min() < 0 or row.max() >= n):
        return None
    col = np.ascontiguousarray(col, dtype=np.int64)
    data = np.ascontiguousarray(data, dtype=np.float64)
    nnz = len(row)
    indptr = np.empty(n + 1, dtype=np.int64)
    out_col = np.empty(nnz, dtype=np.int64)
    out_data = np.empty(nnz, dtype=np.float64)
    _dp = ctypes.POINTER(ctypes.c_double)
    _ip = ctypes.POINTER(ctypes.c_int64)
    lib.csr_from_triplet(
        row.ctypes.data_as(_ip),
        col.ctypes.data_as(_ip),
        data.ctypes.data_as(_dp),
        nnz,
        n,
        indptr.ctypes.data_as(_ip),
        out_col.ctypes.data_as(_ip),
        out_data.ctypes.data_as(_dp),
    )
    return out_data, out_col, indptr


def padded_layout_native(
    target_index: np.ndarray,
    source_index: np.ndarray,
    weights: np.ndarray,
    torder: np.ndarray,
    sremap: np.ndarray,
    n: int,
):
    """Fused Hilbert-layout PaddedCSR build (see csrc padded_layout),
    or None when unavailable / target_index is not grouped-sorted.
    Returns (indices int32 (n, w_max), weights f32 (n, w_max))."""
    lib = get_lib()
    if lib is None:
        return None
    target_index = np.ascontiguousarray(target_index, dtype=np.int64)
    source_index = np.ascontiguousarray(source_index, dtype=np.int64)
    weights = np.ascontiguousarray(weights, dtype=np.float64)
    torder = np.ascontiguousarray(torder, dtype=np.int64)
    sremap = np.ascontiguousarray(sremap, dtype=np.int64)
    nnz = len(target_index)
    if nnz and (
        target_index.min() < 0 or target_index.max() >= n
        or source_index.min() < 0 or source_index.max() >= len(sremap)
    ):
        return None
    starts = np.empty(n + 1, dtype=np.int64)
    _ip = ctypes.POINTER(ctypes.c_int64)
    _dp = ctypes.POINTER(ctypes.c_double)
    w_max = lib.padded_layout(
        target_index.ctypes.data_as(_ip),
        source_index.ctypes.data_as(_ip),
        weights.ctypes.data_as(_dp),
        nnz, n,
        torder.ctypes.data_as(_ip),
        sremap.ctypes.data_as(_ip),
        starts.ctypes.data_as(_ip),
        0, None, None,
    )
    if w_max < 0:
        return None
    w_max = max(int(w_max), 1)
    out_idx = np.empty((n, w_max), dtype=np.int32)
    out_w = np.empty((n, w_max), dtype=np.float32)
    lib.padded_layout(
        target_index.ctypes.data_as(_ip),
        source_index.ctypes.data_as(_ip),
        weights.ctypes.data_as(_dp),
        nnz, n,
        torder.ctypes.data_as(_ip),
        sremap.ctypes.data_as(_ip),
        starts.ctypes.data_as(_ip),
        w_max,
        out_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_w.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out_idx, out_w
