"""
CellTree2d / EdgeCellTree2d: the spatial index facade.

API-compatible with the numba_celltree classes the reference delegates
to (SURVEY.md §2.9: locate_points, intersect_edges, intersect_faces,
compute_barycentric_weights), split between host and device:

* candidate joins run on the **host grid-hash** (spatial/grid_hash.py):
  irregular work is vectorized numpy index arithmetic, which profiling
  showed beats BVH traversal kernels by orders of magnitude at the
  1M-primitive scale;
* exact geometry (point-in-polygon, segment clipping, polygon overlap
  areas, barycentric weights) runs as **dense jitted device kernels**
  over the emitted candidate pairs, chunked to bound per-launch time;
* the overlap-area join (setup-time weight builds) prefers the **native
  host clip** (csrc polygon_clip_areas): it is f64-exact — the device
  kernel computes in f32 when x64 is off, losing slivers below f32
  resolution — and avoids a device call per chunk.

The flat BVH (spatial/bvh.py, spatial/queries.py) remains available for
tree-based traversal experiments.

Convention: joins return ``(query_index, tree_index, payload)``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax.numpy as jnp

from xugrid_tpu.spatial import queries as q
from xugrid_tpu.spatial.bvh import edge_bounding_boxes, face_bounding_boxes
from xugrid_tpu.spatial.geometry import pad_polygons
from xugrid_tpu.spatial.grid_hash import GridHash
from xugrid_tpu.utils.profiling import timed


def _batch_size(n: int) -> int:
    return max(8, q.next_pow2(n))


def _pad_queries(arr: np.ndarray, axis0_to: int, fill=0.0) -> np.ndarray:
    n = arr.shape[0]
    if n == axis0_to:
        return arr
    pad_shape = (axis0_to - n,) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, dtype=arr.dtype)])


class CellTree2d:
    """Spatial index over the faces of a 2D unstructured grid."""

    #: pairs per device kernel launch (bounds memory and launch time).
    CHUNK = 1 << 19

    def __init__(
        self,
        vertices: np.ndarray,
        faces: np.ndarray,
        fill_value: int = -1,
        leaf_size: int = 8,
    ):
        vertices = np.asarray(vertices, dtype=np.float64)
        faces = np.asarray(faces)
        if fill_value != -1:
            faces = np.where(faces == fill_value, -1, faces)
        self.vertices = vertices
        self.faces = faces
        self.n_face = len(faces)
        # Index build touches ONLY bounding boxes; the padded polygon
        # vertex buffer (needed for exact point/clip tests) is computed
        # lazily on first query — at 10M faces it is ~256 MB of writes
        # that have no place in the build phase.
        self.bb_coords = face_bounding_boxes(
            faces, vertices[:, 0], vertices[:, 1]
        )
        self.grid_hash = GridHash(self.bb_coords)
        self._poly_xy_cache = None
        self._poly_xy_dev = None

    @property
    def _poly_xy_host(self):
        if self._poly_xy_cache is None:
            self._poly_xy_cache = pad_polygons(
                self.faces, self.vertices[:, 0], self.vertices[:, 1]
            )
        return self._poly_xy_cache

    @property
    def _poly_xy(self):
        if self._poly_xy_dev is None:
            self._poly_xy_dev = jnp.asarray(self._poly_xy_host)
        return self._poly_xy_dev

    # -- infrastructure -----------------------------------------------------
    @property
    def bb_distances(self) -> np.ndarray:
        """dx, dy, diagonal of every primitive bounding box."""
        dx = self.bb_coords[:, 2] - self.bb_coords[:, 0]
        dy = self.bb_coords[:, 3] - self.bb_coords[:, 1]
        return np.column_stack([dx, dy, np.hypot(dx, dy)])

    @property
    def bounds(self):
        gh = self.grid_hash
        return (
            gh.xmin,
            gh.ymin,
            gh.xmin + gh.nx * gh.dx,
            gh.ymin + gh.ny * gh.dy,
        )

    @property
    def _diag2(self) -> np.ndarray:
        """Cached squared bbox diagonal per primitive (avoids rebuilding
        the full bb_distances column stack — 3x 80 MB at 10M faces — on
        every intersect_faces call)."""
        cached = getattr(self, "_diag2_cache", None)
        if cached is None:
            dx = self.bb_coords[:, 2] - self.bb_coords[:, 0]
            dy = self.bb_coords[:, 3] - self.bb_coords[:, 1]
            cached = self._diag2_cache = dx * dx + dy * dy
        return cached

    @property
    def _max_diag(self) -> float:
        if getattr(self, "_max_diag_cache", None) is None:
            self._max_diag_cache = float(np.sqrt(np.nanmax(self._diag2)))
        return self._max_diag_cache

    def default_tolerance(self) -> float:
        return self._max_diag * 1e-12

    def default_area_tolerance(self) -> float:
        """Threshold separating real overlap slivers from the FP noise
        of boundary-grazing polygon pairs (~1e-15 at unit scale)."""
        return self._max_diag ** 2 * 1e-12

    def _pair_area_tolerance(
        self, query_boxes: np.ndarray, query_index: np.ndarray,
        tree_index: np.ndarray,
    ) -> np.ndarray:
        """Per-pair sliver threshold: scales with the SMALLER of the two
        polygons' bbox diagonals, so genuine overlaps of small faces are
        not discarded on meshes that also contain very large faces."""
        qdx = query_boxes[:, 2] - query_boxes[:, 0]
        qdy = query_boxes[:, 3] - query_boxes[:, 1]
        q_diag2 = qdx * qdx + qdy * qdy
        return (
            np.minimum(q_diag2[query_index], self._diag2[tree_index]) * 1e-12
        )

    def _tol(self, tolerance: Optional[float]) -> float:
        return self.default_tolerance() if tolerance is None else float(tolerance)

    # -- point location -------------------------------------------------------
    def _point_candidates(self, points: np.ndarray, tol: float):
        return self.grid_hash.query_points(points, tol)

    def locate_points(
        self, points: np.ndarray, tolerance: Optional[float] = None
    ) -> np.ndarray:
        """Index of the face containing each point (-1 if none)."""
        points = np.atleast_2d(np.asarray(points, dtype=np.float64))
        n = len(points)
        tol = self._tol(tolerance)
        # Fused native path: candidate scan + exact test in one
        # cell-sorted pass (no pair materialization).
        from xugrid_tpu.utils.native import locate_points_hash_native

        fused = locate_points_hash_native(
            points, tol, self.grid_hash, self._poly_xy_host
        )
        if fused is not None:
            return fused.astype(np.int32)
        pair_q, pair_p = self._point_candidates(points, tol)
        out = np.full(n, -1, dtype=np.int32)
        if len(pair_q) == 0:
            return out
        with timed("celltree.exact_point_in_face"):
            inside = self._points_in_faces(points[pair_q], pair_p, tol)
        hit_q = pair_q[inside]
        hit_p = pair_p[inside]
        # First (lowest-index) containing face per point, matching the
        # deterministic tie-break of a tree traversal.
        big = np.iinfo(np.int32).max
        best = np.full(n, big, dtype=np.int64)
        np.minimum.at(best, hit_q, hit_p)
        found = best != big
        out[found] = best[found]
        return out

    def _points_in_faces(self, pts: np.ndarray, prims: np.ndarray, tol: float):
        """Pairwise exact point-in-polygon over candidate pairs.

        Prefers the native host kernel (same f64 formulas as the device
        kernel): interactive query batches would otherwise pay a device
        call per chunk launch."""
        from xugrid_tpu.utils.native import points_in_polygons_native

        native = points_in_polygons_native(pts, prims, self._poly_xy_host, tol)
        if native is not None:
            return native
        n = len(pts)
        inside = np.empty(n, dtype=bool)
        for start in range(0, n, self.CHUNK):
            stop = min(start + self.CHUNK, n)
            n_chunk = stop - start
            n_pad = _batch_size(n_chunk)
            p = _pad_queries(pts[start:stop], n_pad, fill=np.nan)
            f = _pad_queries(prims[start:stop].astype(np.int32), n_pad, fill=-1)
            res = q.points_in_polygons_kernel(
                jnp.asarray(p), jnp.asarray(f), self._poly_xy, tol
            )
            inside[start:stop] = np.asarray(res)[:n_chunk]
        return inside

    # -- segment intersection ---------------------------------------------------
    def intersect_edges(self, edges: np.ndarray):
        """
        Intersect line segments with the grid faces.

        Returns (edge_index, face_index, intersections (n, 2, 2)): the
        sub-segment of each query edge clipped by each face.
        """
        edges = np.asarray(edges, dtype=np.float64)
        boxes = np.concatenate([edges.min(axis=1), edges.max(axis=1)], axis=1)
        edge_index, face_index = self.grid_hash.query_boxes(boxes)
        if len(edge_index) == 0:
            return (
                edge_index,
                face_index,
                np.empty((0, 2, 2), dtype=np.float64),
            )
        n = len(edge_index)
        from xugrid_tpu.utils.native import clip_segments_by_faces_native

        native = clip_segments_by_faces_native(
            edges[edge_index, 0],
            edges[edge_index, 1],
            face_index,
            self._poly_xy_host,
        )
        if native is not None:
            valid, t0, t1 = native
            return self._intersect_edges_finish(
                edges, edge_index, face_index, valid, t0, t1
            )
        valid = np.empty(n, dtype=bool)
        t0 = np.empty(n, dtype=np.float64)
        t1 = np.empty(n, dtype=np.float64)
        for start in range(0, n, self.CHUNK):
            stop = min(start + self.CHUNK, n)
            n_chunk = stop - start
            n_pad = _batch_size(n_chunk)
            p0 = _pad_queries(edges[edge_index[start:stop], 0], n_pad)
            p1 = _pad_queries(edges[edge_index[start:stop], 1], n_pad)
            cands = _pad_queries(
                face_index[start:stop].astype(np.int32)[:, None], n_pad, fill=-1
            )
            v_c, t0_c, t1_c = q.clip_segments_by_faces_kernel(
                jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(cands), self._poly_xy
            )
            valid[start:stop] = np.asarray(v_c)[:n_chunk, 0]
            t0[start:stop] = np.asarray(t0_c)[:n_chunk, 0]
            t1[start:stop] = np.asarray(t1_c)[:n_chunk, 0]
        return self._intersect_edges_finish(
            edges, edge_index, face_index, valid, t0, t1
        )

    @staticmethod
    def _intersect_edges_finish(edges, edge_index, face_index, valid, t0, t1):
        keep = valid
        edge_index = edge_index[keep]
        face_index = face_index[keep]
        a = edges[edge_index, 0]
        d = edges[edge_index, 1] - a
        start_xy = a + t0[keep][:, None] * d
        end_xy = a + t1[keep][:, None] * d
        intersections = np.stack([start_xy, end_xy], axis=1)
        return edge_index, face_index, intersections

    # -- polygon overlap ---------------------------------------------------------
    def intersect_faces(
        self, vertices: np.ndarray, faces: np.ndarray, fill_value: int = -1
    ):
        """
        Area-of-overlap join between query polygons and tree faces.

        Returns (query_face_index, tree_face_index, area).
        """
        vertices = np.asarray(vertices, dtype=np.float64)
        faces = np.asarray(faces)
        if fill_value != -1:
            faces = np.where(faces == fill_value, -1, faces)
        boxes = face_bounding_boxes(faces, vertices[:, 0], vertices[:, 1])
        query_index, tree_index = self.grid_hash.query_boxes(boxes)
        if len(query_index) == 0:
            return query_index, tree_index, np.empty(0, dtype=np.float64)
        query_xy_host = pad_polygons(faces, vertices[:, 0], vertices[:, 1])
        n = len(query_index)

        # Setup-time weight builds prefer the native host clip: the
        # chunked device path costs a device call per chunk, which
        # dominates at the 1M-face scale (SURVEY.md §7: C++ where
        # host-side preprocessing demands it).
        from xugrid_tpu.utils.native import (
            polygon_clip_areas_conn_native,
            polygon_clip_areas_native,
        )

        with timed("celltree.exact_overlap_areas"):
            # Gather tree polygons from connectivity directly: avoids
            # materializing the padded tree vertex buffer (~640 MB of
            # page-faulting writes at 10M faces).
            native = polygon_clip_areas_conn_native(
                query_index, tree_index, query_xy_host,
                self.faces, self.vertices[:, 0], self.vertices[:, 1],
            )
            if native is None:
                native = polygon_clip_areas_native(
                    query_index, tree_index, query_xy_host,
                    self._poly_xy_host,
                )
        if native is not None:
            keep = native > self._pair_area_tolerance(
                boxes, query_index, tree_index
            )
            return query_index[keep], tree_index[keep], native[keep]

        query_xy = jnp.asarray(query_xy_host)
        areas = np.empty(n, dtype=np.float64)
        with timed("celltree.exact_overlap_areas"):
            for start in range(0, n, self.CHUNK):
                stop = min(start + self.CHUNK, n)
                n_chunk = stop - start
                n_pad = _batch_size(n_chunk)
                qi = _pad_queries(
                    query_index[start:stop].astype(np.int32), n_pad, fill=-1
                )
                ti = _pad_queries(
                    tree_index[start:stop].astype(np.int32), n_pad, fill=-1
                )
                areas[start:stop] = np.asarray(
                    q.polygon_overlap_areas_kernel(
                        jnp.asarray(qi), jnp.asarray(ti), query_xy, self._poly_xy
                    )
                )[:n_chunk]
        keep = areas > self._pair_area_tolerance(
            boxes, query_index, tree_index
        )
        return query_index[keep], tree_index[keep], areas[keep]

    def locate_faces(self, vertices, faces, fill_value: int = -1):
        """(query polygon, tree face) pairs with positive overlap."""
        qi, ti, _ = self.intersect_faces(vertices, faces, fill_value)
        return qi, ti

    # -- barycentric ----------------------------------------------------------------
    def compute_barycentric_weights(
        self, points: np.ndarray, tolerance: Optional[float] = None
    ):
        """
        Locate points and compute generalized barycentric (mean value)
        weights for the vertices of the containing face.

        Returns (face_index (n,), weights (n, n_max_node)).
        """
        points = np.atleast_2d(np.asarray(points, dtype=np.float64))
        face_index = self.locate_points(points, tolerance)
        n = len(points)
        tol = self._tol(tolerance)

        from xugrid_tpu.utils.native import mean_value_weights_native

        native = mean_value_weights_native(
            points, face_index.astype(np.int64), self._poly_xy_host, tol
        )
        if native is not None:
            return face_index, native

        n_max = self._poly_xy.shape[1]
        weights = np.zeros((n, n_max), dtype=np.float64)
        for start in range(0, n, self.CHUNK):
            stop = min(start + self.CHUNK, n)
            n_chunk = stop - start
            n_pad = _batch_size(n_chunk)
            pts = _pad_queries(points[start:stop], n_pad, fill=0.0)
            fi = _pad_queries(
                face_index[start:stop].astype(np.int32), n_pad, fill=-1
            )
            w = q.barycentric_weights_kernel(
                jnp.asarray(pts), jnp.asarray(fi), self._poly_xy, tol
            )
            weights[start:stop] = np.asarray(w)[:n_chunk]
        return face_index, weights


class EdgeCellTree2d:
    """Spatial index over the edges of a 1D network."""

    CHUNK = CellTree2d.CHUNK

    def __init__(
        self,
        vertices: np.ndarray,
        edge_node_connectivity: np.ndarray,
        leaf_size: int = 8,
    ):
        vertices = np.asarray(vertices, dtype=np.float64)
        conn = np.asarray(edge_node_connectivity)
        self.vertices = vertices
        self.edges = conn
        self.n_edge = len(conn)
        self.bb_coords = edge_bounding_boxes(conn, vertices[:, 0], vertices[:, 1])
        self.grid_hash = GridHash(self.bb_coords)
        self._edge_xy_np = vertices[conn]

    @property
    def bb_distances(self) -> np.ndarray:
        dx = self.bb_coords[:, 2] - self.bb_coords[:, 0]
        dy = self.bb_coords[:, 3] - self.bb_coords[:, 1]
        return np.column_stack([dx, dy, np.hypot(dx, dy)])

    def default_tolerance(self) -> float:
        return float(np.nanmax(self.bb_distances[:, 2])) * 1e-12

    def _tol(self, tolerance: Optional[float]) -> float:
        return self.default_tolerance() if tolerance is None else float(tolerance)

    def locate_points(
        self, points: np.ndarray, tolerance: Optional[float] = None
    ) -> np.ndarray:
        """Index of an edge each point lies on (-1 if none)."""
        points = np.atleast_2d(np.asarray(points, dtype=np.float64))
        n = len(points)
        tol = self._tol(tolerance)
        boxes = np.column_stack([points - tol, points + tol])
        pair_q, pair_p = self.grid_hash.query_boxes(boxes)
        out = np.full(n, -1, dtype=np.int32)
        if len(pair_q) == 0:
            return out
        # Exact: distance of point to segment within tolerance (host;
        # candidate counts are tiny for point queries).
        seg = self._edge_xy_np[pair_p]
        a = seg[:, 0]
        d = seg[:, 1] - a
        len2 = np.maximum((d * d).sum(axis=1), 1e-300)
        t = np.clip(((points[pair_q] - a) * d).sum(axis=1) / len2, 0.0, 1.0)
        closest = a + t[:, None] * d
        dist2 = ((points[pair_q] - closest) ** 2).sum(axis=1)
        on = dist2 <= tol * tol
        big = np.iinfo(np.int32).max
        best = np.full(n, big, dtype=np.int64)
        np.minimum.at(best, pair_q[on], pair_p[on])
        found = best != big
        out[found] = best[found]
        return out

    def intersect_edges(self, edges: np.ndarray):
        """
        Intersect query segments with network edges.

        Returns (edge_index, tree_edge_index, intersections (n, 2)).
        """
        edges = np.asarray(edges, dtype=np.float64)
        boxes = np.concatenate([edges.min(axis=1), edges.max(axis=1)], axis=1)
        query_index, tree_index = self.grid_hash.query_boxes(boxes)
        if len(query_index) == 0:
            return query_index, tree_index, np.empty((0, 2), dtype=np.float64)
        p0 = edges[query_index, 0]
        p1 = edges[query_index, 1]
        q0 = self._edge_xy_np[tree_index, 0]
        q1 = self._edge_xy_np[tree_index, 1]
        hits, pts = _segment_intersections(p0, p1, q0, q1)
        return query_index[hits], tree_index[hits], pts[hits]


def _segment_intersections(p0, p1, q0, q1):
    """Vectorized numpy segment-segment intersection."""
    r = p1 - p0
    s = q1 - q0
    denom = r[:, 0] * s[:, 1] - r[:, 1] * s[:, 0]
    qp = q0 - p0
    t_num = qp[:, 0] * s[:, 1] - qp[:, 1] * s[:, 0]
    u_num = qp[:, 0] * r[:, 1] - qp[:, 1] * r[:, 0]
    parallel = denom == 0.0
    safe = np.where(parallel, 1.0, denom)
    t = t_num / safe
    u = u_num / safe
    hit = ~parallel & (t >= 0.0) & (t <= 1.0) & (u >= 0.0) & (u <= 1.0)

    # Collinear overlap (parallel and q0 on p's line): intersect the
    # projected parameter intervals; the q0-side entry point represents
    # the overlap (numba_celltree reports these).
    rr = np.einsum("ij,ij->i", r, r)
    safe_rr = np.where(rr == 0.0, 1.0, rr)
    s0 = np.einsum("ij,ij->i", q0 - p0, r) / safe_rr
    s1 = np.einsum("ij,ij->i", q1 - p0, r) / safe_rr
    lo = np.maximum(np.minimum(s0, s1), 0.0)
    hi = np.minimum(np.maximum(s0, s1), 1.0)
    # t_num == 0 is NOT sufficient: a degenerate tree edge (q0 == q1,
    # s == 0) zeroes t_num wherever q0 lies.  q0 is on p's line iff
    # qp x r == 0 (u_num), which also implies t_num == 0 when r ∥ s.
    collinear = parallel & (t_num == 0.0) & (u_num == 0.0) & (rr > 0.0)
    col_hit = collinear & (lo <= hi)
    t = np.where(col_hit, lo, t)
    hit = hit | col_hit
    return hit, p0 + t[:, None] * r
