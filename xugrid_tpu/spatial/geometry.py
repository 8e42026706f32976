"""
Vectorized 2D geometry primitives (JAX, jit/vmap-friendly).

All functions operate on padded fixed-shape polygon buffers: a polygon is
``(n_max, 2)`` vertex coordinates where unused trailing slots repeat the
first vertex (producing zero-length edges that every predicate ignores).

These are the exact-test building blocks under the BVH query layer —
the device counterpart of numba_celltree's numba kernels (SURVEY.md §2.9).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def pad_polygons(face_node_connectivity, node_x, node_y):
    """
    Gather per-face vertex buffers, replacing -1 fills with the first
    vertex so padding edges have zero length.

    Runs on the host (numpy): at the 1M-face scale an eager on-device
    gather costs a compile plus a device call, while the host
    fancy-index takes milliseconds; kernels transfer the padded buffer
    once on first use.

    Returns (n_face, n_max, 2) numpy float64.
    """
    import numpy as np

    from xugrid_tpu.utils.native import pad_and_bbox_native

    native = pad_and_bbox_native(face_node_connectivity, node_x, node_y)
    if native is not None:
        return native[0]
    conn = np.asarray(face_node_connectivity)
    # first VALID node per row (a malformed row may lead with fill;
    # conn[:, :1] would keep -1 and silently gather the LAST node)
    valid = conn >= 0
    rows = np.arange(len(conn))
    first = np.where(
        valid.any(axis=1), conn[rows, np.argmax(valid, axis=1)], 0
    )[:, None]
    filled = np.where(conn < 0, first, conn)
    x = np.asarray(node_x, dtype=np.float64)
    y = np.asarray(node_y, dtype=np.float64)
    out = np.empty(filled.shape + (2,), dtype=np.float64)
    out[..., 0] = x[filled]
    out[..., 1] = y[filled]
    return out


def polygon_edges(poly):
    """Consecutive vertex pairs including the closing edge.

    poly: (..., n_max, 2) -> (a, b) each (..., n_max, 2)."""
    a = poly
    b = jnp.roll(poly, -1, axis=-2)
    return a, b


def point_in_polygon(point, poly, tolerance=0.0):
    """
    Crossing-number point-in-polygon with an on-edge tolerance.

    point: (2,); poly: (n_max, 2) padded. Returns bool scalar.
    """
    a, b = polygon_edges(poly)
    ax, ay = a[:, 0], a[:, 1]
    bx, by = b[:, 0], b[:, 1]
    px, py = point[0], point[1]

    # Ray casting to +x: count crossings of edges straddling py.
    straddle = (ay > py) != (by > py)
    # Avoid division by zero on horizontal/degenerate edges.
    denom = jnp.where(by - ay == 0.0, 1.0, by - ay)
    x_at = ax + (py - ay) * (bx - ax) / denom
    crossing = straddle & (px < x_at)
    inside = (jnp.sum(crossing.astype(jnp.int32)) % 2) == 1

    if tolerance is not None:
        d2 = _point_segment_dist2(px, py, ax, ay, bx, by)
        on_edge = jnp.min(d2) <= tolerance * tolerance
        inside = inside | on_edge
    return inside


def _point_segment_dist2(px, py, ax, ay, bx, by):
    """Squared distance from point to segments (vectorized over segments)."""
    dx = bx - ax
    dy = by - ay
    len2 = dx * dx + dy * dy
    t = jnp.where(len2 == 0.0, 0.0, ((px - ax) * dx + (py - ay) * dy) / jnp.maximum(len2, 1e-300))
    t = jnp.clip(t, 0.0, 1.0)
    cx = ax + t * dx
    cy = ay + t * dy
    return (px - cx) ** 2 + (py - cy) ** 2


def point_on_segment_param(point, a, b, tolerance):
    """
    Parametric position of ``point`` along segment a->b if within
    ``tolerance`` of it; returns (on_segment: bool, t: float).
    """
    d2 = _point_segment_dist2(point[0], point[1], a[0], a[1], b[0], b[1])
    dx, dy = b[0] - a[0], b[1] - a[1]
    len2 = jnp.maximum(dx * dx + dy * dy, 1e-300)
    t = jnp.clip(((point[0] - a[0]) * dx + (point[1] - a[1]) * dy) / len2, 0.0, 1.0)
    return d2 <= tolerance * tolerance, t


def clip_segment_by_convex_polygon(p0, p1, poly):
    """
    Liang-Barsky style parametric clip of segment p0->p1 against a convex
    CCW polygon. Returns (valid, t0, t1): the segment parameter interval
    inside the polygon.
    """
    a, b = polygon_edges(poly)
    # CCW edge normals point inward: n = (-(by-ay), bx-ax)
    ex = b[:, 0] - a[:, 0]
    ey = b[:, 1] - a[:, 1]
    nx = -ey
    ny = ex
    degenerate = (ex == 0.0) & (ey == 0.0)
    dx = p1[0] - p0[0]
    dy = p1[1] - p0[1]
    denom = nx * dx + ny * dy  # >0: entering, <0: leaving
    num = nx * (a[:, 0] - p0[0]) + ny * (a[:, 1] - p0[1])
    t_edge = jnp.where(denom == 0.0, 0.0, num / jnp.where(denom == 0.0, 1.0, denom))
    # Parallel to an edge and fully outside its half-plane (the half-plane
    # condition is n·(p0 - a) >= 0, i.e. -num >= 0): no intersection.
    parallel_outside = (denom == 0.0) & (num > 0.0) & ~degenerate
    entering = denom > 0.0
    t0 = jnp.max(jnp.where(entering & ~degenerate, t_edge, 0.0))
    t1 = jnp.min(jnp.where(~entering & (denom != 0.0) & ~degenerate, t_edge, 1.0))
    t0 = jnp.maximum(t0, 0.0)
    t1 = jnp.minimum(t1, 1.0)
    valid = (t0 < t1) & ~jnp.any(parallel_outside)
    return valid, t0, t1


def segment_segment_intersection(p0, p1, q0, q1):
    """
    Intersection of segments p and q. Returns (intersects, point(2,)).
    Collinear overlaps report the q0-side entry point.
    """
    r = p1 - p0
    s = q1 - q0
    denom = r[0] * s[1] - r[1] * s[0]
    qp = q0 - p0
    t_num = qp[0] * s[1] - qp[1] * s[0]
    u_num = qp[0] * r[1] - qp[1] * r[0]
    parallel = denom == 0.0
    safe = jnp.where(parallel, 1.0, denom)
    t = t_num / safe
    u = u_num / safe
    hit = ~parallel & (t >= 0.0) & (t <= 1.0) & (u >= 0.0) & (u <= 1.0)
    point = p0 + t * r

    # Collinear overlap: parallel AND q0 on p's line. Project q onto p
    # and intersect the parameter intervals; report the entry point.
    rr = r[0] * r[0] + r[1] * r[1]
    safe_rr = jnp.where(rr == 0.0, 1.0, rr)
    s0 = ((q0[0] - p0[0]) * r[0] + (q0[1] - p0[1]) * r[1]) / safe_rr
    s1 = ((q1[0] - p0[0]) * r[0] + (q1[1] - p0[1]) * r[1]) / safe_rr
    lo = jnp.maximum(jnp.minimum(s0, s1), 0.0)
    hi = jnp.minimum(jnp.maximum(s0, s1), 1.0)
    collinear = parallel & (t_num == 0.0) & (rr > 0.0)
    col_hit = collinear & (lo <= hi)
    hit = hit | col_hit
    point = jnp.where(col_hit, p0 + lo * r, point)
    return hit, jnp.where(hit, point, jnp.nan)


def polygon_area(poly):
    """Shoelace area of padded polygon(s): (..., n_max, 2) -> (...)."""
    a, b = polygon_edges(poly)
    cross = a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]
    return 0.5 * jnp.abs(jnp.sum(cross, axis=-1))


def clip_polygons_area(subject, clip, n_out: int | None = None):
    """
    Area of intersection of ``subject`` with convex CCW polygon ``clip``
    via Sutherland-Hodgman clipping with fixed-size buffers.

    subject: (m, 2) padded (first-vertex padding).
    clip: (k, 2) padded convex CCW.
    Returns a scalar area.
    """
    m = subject.shape[-2]
    k = clip.shape[-2]
    if n_out is None:
        n_out = m + k + 1

    # Current polygon buffer + count.
    buf = jnp.zeros((n_out, 2), dtype=subject.dtype)
    # Deduplicate padding: compute true vertex count of subject
    first = subject[0]
    is_pad = jnp.concatenate(
        [
            jnp.zeros((1,), bool),
            jnp.all(subject[1:] == first, axis=-1),
        ]
    )
    # Padding is a suffix; count = first True index (or m).
    n_subj = jnp.where(jnp.any(is_pad), jnp.argmax(is_pad), m)
    n_subj = jnp.maximum(n_subj, 1)
    buf = buf.at[:m].set(subject)

    ca, cb = polygon_edges(clip)

    def clip_one_edge(i, state):
        buf, count = state
        a = ca[i]
        b = cb[i]
        ex, ey = b[0] - a[0], b[1] - a[1]
        degenerate = (ex == 0.0) & (ey == 0.0)

        def do_clip(args):
            buf, count = args
            # signed distance to the (inward-normal) half plane
            sd = -ey * (buf[:, 0] - a[0]) + ex * (buf[:, 1] - a[1])
            idx = jnp.arange(n_out)
            valid = idx < count
            inside = (sd >= 0.0) & valid
            nxt = jnp.where(idx + 1 < count, idx + 1, 0)
            sd_next = sd[nxt]
            inside_next = (sd_next >= 0.0)
            p = buf
            q = buf[nxt]
            denom = sd - sd_next
            t = jnp.where(denom == 0.0, 0.0, sd / jnp.where(denom == 0.0, 1.0, denom))
            inter = p + t[:, None] * (q - p)

            # Each edge (p->q) emits up to 2 vertices:
            #   inside  & inside_next  -> p
            #   inside  & ~inside_next -> p, inter
            #   ~inside & inside_next  -> inter
            emit_p = inside
            emit_i = valid & (inside != inside_next)
            n_emit = emit_p.astype(jnp.int32) + emit_i.astype(jnp.int32)
            offsets = jnp.cumsum(n_emit) - n_emit
            new_count = jnp.sum(n_emit)

            # Non-emitting rows scatter into the dump slot n_out-1; real
            # vertex positions never reach it (count <= n_out - 1), so it
            # is zeroed afterwards.
            new_buf = jnp.zeros_like(buf)
            pos_p = jnp.where(emit_p, offsets, n_out - 1)
            new_buf = new_buf.at[pos_p].set(p)
            pos_i = jnp.where(emit_i, offsets + emit_p.astype(jnp.int32), n_out - 1)
            new_buf = new_buf.at[pos_i].set(jnp.where(emit_i[:, None], inter, 0.0))
            new_buf = new_buf.at[n_out - 1].set(jnp.zeros(2, dtype=buf.dtype))
            return new_buf, new_count

        return jax.lax.cond(
            degenerate, lambda args: args, do_clip, (buf, count)
        )

    buf, count = jax.lax.fori_loop(0, k, clip_one_edge, (buf, n_subj))

    # Shoelace over the first `count` vertices.
    idx = jnp.arange(n_out)
    valid = idx < count
    nxt = jnp.where(idx + 1 < count, idx + 1, 0)
    a_ = buf
    b_ = buf[nxt]
    cross = a_[:, 0] * b_[:, 1] - a_[:, 1] * b_[:, 0]
    area = 0.5 * jnp.abs(jnp.sum(jnp.where(valid, cross, 0.0)))
    return jnp.where(count >= 3, area, 0.0)


def convex_overlap_area(subject, clip):
    """
    Area of intersection of two convex padded polygons — scatter-free.

    The intersection of convex polygons is convex; its vertices are
    exactly (a) subject vertices inside clip, (b) clip vertices inside
    subject, (c) edge-edge intersection points.  We gather all m+k+m*k
    candidates with validity flags, angle-sort them around the valid
    centroid, and run a masked shoelace (invalid points sort to the end
    and are replaced by the first vertex, contributing zero area).

    Unlike Sutherland-Hodgman this needs no scatters or sequential
    vertex-list building — every step is a dense vectorized op.  Same
    convexity assumption as the
    reference's clipping (numba_celltree).
    """
    m = subject.shape[-2]
    k = clip.shape[-2]

    sa, sb = polygon_edges(subject)
    ca, cb = polygon_edges(clip)

    # (a) subject vertices inside clip, (b) clip vertices inside subject.
    sub_in = jax.vmap(lambda p: point_in_polygon(p, clip, 0.0))(subject)
    clip_in = jax.vmap(lambda p: point_in_polygon(p, subject, 0.0))(clip)

    # (c) pairwise edge intersections (m*k,).
    def seg_pair(i, j):
        return segment_segment_intersection(sa[i], sb[i], ca[j], cb[j])

    ii = jnp.repeat(jnp.arange(m), k)
    jj = jnp.tile(jnp.arange(k), m)
    hit, pts = jax.vmap(seg_pair)(ii, jj)
    # Degenerate (padding) edges never intersect anything meaningful:
    s_degen = jnp.all(sa == sb, axis=-1)
    c_degen = jnp.all(ca == cb, axis=-1)
    hit = hit & ~s_degen[ii] & ~c_degen[jj]

    candidates = jnp.concatenate([subject, clip, pts], axis=0)
    valid = jnp.concatenate([sub_in, clip_in, hit], axis=0)
    candidates = jnp.where(valid[:, None], candidates, 0.0)

    n_valid = jnp.sum(valid)
    center = jnp.sum(candidates, axis=0) / jnp.maximum(n_valid, 1)
    angle = jnp.where(
        valid,
        jnp.arctan2(candidates[:, 1] - center[1], candidates[:, 0] - center[0]),
        jnp.inf,
    )
    order = jnp.argsort(angle)
    pts_sorted = candidates[order]
    valid_sorted = valid[order]
    # Invalid entries (angle=inf) are a suffix: replace by the first
    # vertex so they form zero-area duplicates.
    pts_final = jnp.where(valid_sorted[:, None], pts_sorted, pts_sorted[0])

    a = pts_final
    b = jnp.roll(pts_final, -1, axis=0)
    cross = a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]
    area = 0.5 * jnp.abs(jnp.sum(cross))
    return jnp.where(n_valid >= 3, area, 0.0)


def mean_value_weights(point, poly, tolerance):
    """
    Mean value coordinates of ``point`` w.r.t. padded polygon ``poly``.

    Linear-precision generalized barycentric coordinates for arbitrary
    simple polygons (reduces to barycentric interpolation behavior for
    triangles).  Padding vertices receive zero weight. Points within
    ``tolerance`` of a vertex snap to that vertex.
    """
    m = poly.shape[0]
    first = poly[0]
    is_pad = jnp.concatenate(
        [jnp.zeros((1,), bool), jnp.all(poly[1:] == first, axis=-1)]
    )
    n_vert = jnp.maximum(jnp.where(jnp.any(is_pad), jnp.argmax(is_pad), m), 3)
    idx = jnp.arange(m)
    valid = idx < n_vert

    d = poly - point[None, :]
    r = jnp.sqrt(jnp.sum(d * d, axis=-1))

    nxt = jnp.where(idx + 1 < n_vert, idx + 1, 0)
    d_next = d[nxt]
    r_next = r[nxt]
    cross = d[:, 0] * d_next[:, 1] - d[:, 1] * d_next[:, 0]
    dot = jnp.sum(d * d_next, axis=-1)
    # tan(alpha_i / 2) = (r_i * r_{i+1} - dot) / cross
    denom = jnp.where(cross == 0.0, 1.0, cross)
    tan_half = jnp.where(cross == 0.0, 0.0, (r * r_next - dot) / denom)

    prev = jnp.where(idx == 0, n_vert - 1, idx - 1)
    safe_r = jnp.where(r == 0.0, 1.0, r)
    w = jnp.where(valid, (tan_half[prev] + tan_half) / safe_r, 0.0)

    # Point ON an edge: alpha -> pi there (tan(alpha/2) -> inf), where
    # the mean-value limit is plain linear interpolation between the two
    # edge endpoints — forcing tan to 0 instead silently spreads weight
    # over all vertices.
    on_edge = valid & (jnp.abs(cross) <= 1e-12 * r * r_next) & (dot < 0.0)
    any_edge = jnp.any(on_edge)
    i_edge = jnp.argmax(on_edge)
    r_sum = r[i_edge] + r_next[i_edge]
    r_sum = jnp.where(r_sum == 0.0, 1.0, r_sum)
    w_edge = (
        jnp.zeros(m, w.dtype)
        .at[i_edge].add(r_next[i_edge] / r_sum)
        .at[nxt[i_edge]].add(r[i_edge] / r_sum)
    )
    w = jnp.where(any_edge, w_edge, w)

    # Vertex snap: exact hit on a vertex (takes precedence over edge).
    on_vertex = valid & (r <= tolerance)
    any_vertex = jnp.any(on_vertex)
    w = jnp.where(any_vertex, on_vertex.astype(w.dtype), w)

    total = jnp.sum(w)
    w = w / jnp.where(total == 0.0, 1.0, total)
    return w
