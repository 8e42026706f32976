"""
Multi-device execution: mesh sharding of UGRID face data.

This is the framework's "distributed communication backend" (SURVEY.md
§2.10, §5): where the reference merges MPI-partitioned files offline,
here the face dimension itself is sharded across a
``jax.sharding.Mesh`` and operations run SPMD under ``shard_map``:

* faces are ordered along the Hilbert curve (the same ordering the
  partitioner uses) so each device holds a spatially compact block;
* regrid apply shards target rows per device and all-gathers the source
  values between devices;
* stencil/smoothing ops exchange halo values with ``ppermute``
  neighbor passes instead of re-gathering everything.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
import warnings as _warnings

with _warnings.catch_warnings():
    # jax.experimental.shard_map is deprecated in favor of jax.shard_map,
    # but the new entry point changed the check_rep kwarg; use the stable
    # experimental path while both exist.
    _warnings.simplefilter("ignore", DeprecationWarning)
    from jax.experimental.shard_map import shard_map

from xugrid_tpu.core.sparse import PaddedCSR
from xugrid_tpu.regrid import reduce as reductions
from xugrid_tpu.ugrid.partitioning import hilbert_distance


def partition_order(coordinates: np.ndarray) -> np.ndarray:
    """Hilbert-curve ordering of entities: contiguous slices are compact
    spatial blocks, the layout used to shard the face dimension."""
    return np.argsort(hilbert_distance(np.asarray(coordinates)), kind="stable")


def hilbert_layout(
    source_centroids: np.ndarray,
    target_centroids: np.ndarray,
    target_index: np.ndarray,
    source_index: np.ndarray,
    weights: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, PaddedCSR]:
    """
    Hilbert-order both sides of a weight matrix and build the sharded
    PaddedCSR layout in one pass.

    Returns ``(sorder, torder, padded)`` where contiguous row blocks of
    ``padded`` are spatially compact (device shards exchange only a
    perimeter halo) and ``padded.indices`` are positions in the
    reordered source field ``field[sorder]``.

    The fused native kernel exploits that overlap builders emit
    triplets grouped by target: per-target entry ranges come from one
    sequential counting pass, and padded rows are written directly in
    Hilbert order — no 18M-element stable sort, remap gather, or
    ragged->padded scatter (a ~38 s -> ~7 s cut at the 10M-face
    north-star config on the 1-vCPU bench host).
    """
    from xugrid_tpu.utils.native import padded_layout_native

    sorder = partition_order(source_centroids)
    torder = partition_order(target_centroids)
    sremap = np.empty(len(sorder), np.int64)
    sremap[sorder] = np.arange(len(sorder))
    n = len(torder)
    m = len(sorder)
    native = padded_layout_native(
        target_index, source_index, weights, torder, sremap, n
    )
    if native is not None:
        indices, w32 = native
        padded = PaddedCSR(indices, w32, n, m, indices.shape[1])
        return sorder, torder, padded
    from xugrid_tpu.core.sparse import MatrixCSR

    tremap = np.empty(n, np.int64)
    tremap[torder] = np.arange(n)
    csr = MatrixCSR.from_triplet(
        tremap[target_index], sremap[source_index], weights, n=n, m=m
    )
    return sorder, torder, PaddedCSR.from_csr(csr, dtype=np.float32)


def _pad_to_multiple(array: np.ndarray, multiple: int, fill) -> np.ndarray:
    n = array.shape[0]
    n_pad = (-n) % multiple
    if n_pad == 0:
        return array
    pad_shape = (n_pad,) + array.shape[1:]
    return np.concatenate([array, np.full(pad_shape, fill, array.dtype)])


class ShardedRegrid:
    """
    A regrid-apply plan sharded over a device mesh.

    Target rows (the PaddedCSR windows) are split across devices along
    the mesh axis; the source field is sharded too.  Two collective
    strategies:

    * ``"halo"``: a :class:`NeighborExchangePlan` moves only the
      deduplicated remote source rows each device's windows reference —
      ONE ``all_to_all``, O(perimeter) bytes when source and
      target orderings are spatially aligned (Hilbert / raster order).
    * ``"allgather"``: gather the full source field — O(m) bytes, the
      right call when remote references are dense.

    ``"auto"`` (default) builds the exchange plan and picks halo when
    its payload is smaller than a full gather.
    """

    def __init__(
        self,
        mesh: Mesh,
        weights: PaddedCSR,
        reduction: Callable = reductions.mean,
        axis: str | None = None,
        method: str = "auto",
    ):
        if method not in ("auto", "halo", "allgather"):
            raise ValueError(
                f"method must be 'auto', 'halo' or 'allgather', got {method}"
            )
        self.mesh = mesh
        self.axis = axis or mesh.axis_names[0]
        self.reduction = reduction
        # Shard count along the NAMED axis (a multi-axis mesh shards
        # P(axis) arrays over that axis only, not every device).
        n_devices = mesh.shape[self.axis]

        indices = _pad_to_multiple(weights.indices, n_devices, -1)
        values = _pad_to_multiple(weights.weights, n_devices, 0.0)
        m_pad = (-weights.m) % n_devices
        self.n_target = weights.n
        self.m_source = weights.m
        self.m_padded = weights.m + m_pad

        row_sharding = NamedSharding(mesh, P(self.axis, None))
        src_sharding = NamedSharding(mesh, P(self.axis))
        self.weights = jax.device_put(values, row_sharding)
        self.src_sharding = src_sharding
        self.out_sharding = NamedSharding(mesh, P(self.axis))

        reduction_fn = self.reduction
        axis_name = self.axis

        self.plan: NeighborExchangePlan | None = None
        if method in ("auto", "halo"):
            plan = NeighborExchangePlan(
                self.mesh, indices, axis=self.axis, source_size=self.m_padded
            )
            # Halo pays D*R rows sent + D*R received per device; the
            # gather pays ~m_padded received.  Pick halo when strictly
            # cheaper (or when forced).
            if method == "halo" or 2 * n_devices * plan.R < self.m_padded:
                self.plan = plan
        self.method = "halo" if self.plan is not None else "allgather"
        #: exchange payload per f32 apply (informational, for scale checks).
        self.exchanged_bytes = (
            self.plan.exchanged_bytes_f32
            if self.plan is not None
            else self.m_padded * 4
        )

        if self.plan is not None:
            plan = self.plan
            self.indices = plan.lookup  # remapped into [local | recv]

            @partial(
                shard_map,
                mesh=mesh,
                in_specs=(
                    P(axis_name),
                    P(axis_name, None),
                    P(axis_name, None),
                    P(axis_name, None),
                ),
                out_specs=P(axis_name),
                check_rep=False,
            )
            def _apply(source_local, send_local, lookup_local, w_local):
                values = plan.gather_neighbors(
                    source_local, send_local, lookup_local
                )
                return reduction_fn(values, w_local)

            apply_jit = jax.jit(_apply)
            self._apply = lambda src, w: apply_jit(
                src, plan.send_slots, plan.lookup, w
            )
        else:
            self.indices = jax.device_put(indices, row_sharding)

            @partial(
                shard_map,
                mesh=mesh,
                in_specs=(P(axis_name), P(axis_name, None), P(axis_name, None)),
                out_specs=P(axis_name),
                check_rep=False,
            )
            def _apply(source_local, idx_local, w_local):
                # One collective: gather the full source.
                source_full = jax.lax.all_gather(
                    source_local, axis_name, tiled=True
                )
                pad = idx_local < 0
                values = source_full[jnp.maximum(idx_local, 0)]
                values = jnp.where(pad, jnp.nan, values)
                return reduction_fn(values, w_local)

            apply_jit = jax.jit(_apply)
            self._apply = lambda src, w: apply_jit(src, self.indices, w)

    @classmethod
    def from_regridder(
        cls,
        mesh: Mesh,
        regridder,
        reduction: Callable | None = None,
        axis: str | None = None,
        method: str = "auto",
    ) -> "ShardedRegrid":
        """
        Shard a built regridder's weights over a device mesh.

        ``regridder`` is any BaseRegridder with computed weights (e.g.
        OverlapRegridder); its reduction is reused unless overridden.
        Apply with source fields in the SOURCE GRID's face order —
        spatially sort both grids (e.g. ``partition_order``) before
        building the regridder for an O(perimeter) halo exchange.
        """
        padded = regridder._padded_weights
        if reduction is None:
            reduction = getattr(regridder, "_reduction", reductions.mean)
        return cls(mesh, padded, reduction=reduction, axis=axis, method=method)

    def put_source(self, source: np.ndarray) -> jax.Array:
        """Shard a source field (length m) across the mesh."""
        padded = _pad_to_multiple(
            np.asarray(source, dtype=self.weights.dtype),
            self.mesh.shape[self.axis],
            np.nan,
        )
        return jax.device_put(padded, self.src_sharding)

    def __call__(self, source) -> jax.Array:
        """Apply the sharded regrid; returns the sharded target field."""
        if isinstance(source, np.ndarray):
            source = self.put_source(source)
        return self._apply(source, self.weights)

    def gather(self, out: jax.Array) -> np.ndarray:
        """Bring a sharded target field back to the host, unpadded."""
        return np.asarray(out)[: self.n_target]


def halo_exchange(mesh: Mesh, axis: str, local: jax.Array, halo: int):
    """
    Ring halo exchange inside a shard_map region: returns the local
    block extended with ``halo`` rows from both neighbors (ppermute).
    For use inside shard_map-decorated functions.
    """
    if halo <= 0:
        return local
    if halo > local.shape[0]:
        raise ValueError(
            f"halo ({halo}) exceeds the local block ({local.shape[0]})"
        )
    axis_size = jax.lax.axis_size(axis)
    left_edge = local[:halo]
    right_edge = local[-halo:]
    perm_fwd = [(i, (i + 1) % axis_size) for i in range(axis_size)]
    perm_bwd = [(i, (i - 1) % axis_size) for i in range(axis_size)]
    from_left = jax.lax.ppermute(right_edge, axis, perm_fwd)
    from_right = jax.lax.ppermute(left_edge, axis, perm_bwd)
    return jnp.concatenate([from_left, local, from_right], axis=0)


class NeighborExchangePlan:
    """
    Precomputed distributed neighbor-gather plan (the scalable halo
    machinery).

    The indexed (source) dimension is block-sharded over the mesh axis,
    and so are the requesting rows; the two may have different lengths
    (``source_size``), e.g. regrid target windows indexing a source
    field.  At setup, every remote reference is resolved to (owner
    device, local slot) and deduplicated into fixed-size per-device-pair
    send lists — all with vectorized sort/group-by, no Python loops over
    references.  At run time ONE ``all_to_all`` moves exactly the
    referenced rows — no full-field all-gather.  With
    Hilbert-ordered faces (``partition_order``) the remote fraction is
    the block perimeter, so the exchanged volume is O(sqrt(block)) per
    device.

    Reference counterpart: none — the reference merges MPI-partitioned
    files offline (SURVEY.md §2.10); this is the on-device equivalent of
    its partition boundary exchange.
    """

    def __init__(
        self,
        mesh: Mesh,
        neighbor_indices: np.ndarray,
        axis=None,
        source_size: int | None = None,
    ):
        self.mesh = mesh
        self.axis = axis or mesh.axis_names[0]
        n_devices = mesh.shape[self.axis]
        idx = np.asarray(neighbor_indices, dtype=np.int64)
        n = idx.shape[0]
        n_req_block = -(-n // n_devices)
        idx = _pad_to_multiple(idx, n_devices, -1)
        if len(idx) < n_req_block * n_devices:
            idx = np.concatenate(
                [
                    idx,
                    np.full(
                        (n_req_block * n_devices - len(idx),) + idx.shape[1:],
                        -1,
                        idx.dtype,
                    ),
                ]
            )
        m = n if source_size is None else int(source_size)
        block = -(-m // n_devices)  # source rows per device

        valid = idx >= 0
        owner = np.where(valid, idx // block, -1)
        slot = np.where(valid, idx % block, 0)
        row_device = np.repeat(np.arange(n_devices), n_req_block)[:, None]
        is_remote = valid & (owner != row_device)

        # Vectorized dedup of remote (owner, requester, slot) triples:
        # one sorted-unique pass; triples of the same (owner, requester)
        # land contiguously, so the in-group position is a running
        # offset from the group start.
        ro = owner[is_remote]
        rs = slot[is_remote]
        rr = np.broadcast_to(row_device, owner.shape)[is_remote]
        key = (ro * n_devices + rr) * block + rs
        uniq, inverse = np.unique(key, return_inverse=True)
        u_slot = uniq % block
        u_group = uniq // block  # owner * n_devices + requester
        group_start = np.flatnonzero(
            np.diff(u_group, prepend=np.int64(-1)) != 0
        )
        # position within (owner, requester) group, for every unique row
        starts_per_uniq = np.repeat(
            group_start, np.diff(np.append(group_start, len(uniq)))
        )
        u_pos = np.arange(len(uniq)) - starts_per_uniq
        group_sizes = np.bincount(
            u_group.astype(np.int64), minlength=n_devices * n_devices
        ) if len(uniq) else np.zeros(n_devices * n_devices, np.int64)
        R = max(int(group_sizes.max()) if len(uniq) else 0, 1)

        # send_slots[o, r, :]: local slots device o sends to requester r.
        send_slots = np.zeros((n_devices * n_devices, R), dtype=np.int32)
        send_slots[u_group, u_pos] = u_slot
        # Combined lookup: index into concat([local (block), recv (D*R)]).
        # recv layout after all_to_all(split=0, concat=0): recv[o * R + p]
        # holds owner o's p-th requested row.
        lookup = np.full(idx.shape, -1, dtype=np.int32)
        local_mask = valid & ~is_remote
        lookup[local_mask] = slot[local_mask]
        u_owner = u_group // n_devices
        lookup[is_remote] = (block + u_owner * R + u_pos)[inverse]

        self.n = n
        self.m = m
        self.block = block
        self.req_block = n_req_block
        self.R = R
        self.n_remote = int(is_remote.sum())
        self.n_unique_remote = int(len(uniq))
        #: bytes moved between devices per exchange of a (n,) f32 field
        #: (all_to_all payload, send+recv counted once).
        self.exchanged_bytes_f32 = n_devices * n_devices * R * 4
        row_sharding = NamedSharding(mesh, P(self.axis, None))
        self.lookup = jax.device_put(lookup, row_sharding)
        # (D, D, R) sharded on the owner axis -> each device holds its
        # (D, R) send table.
        self.send_slots = jax.device_put(
            send_slots, NamedSharding(mesh, P(self.axis, None))
        )

    def gather_neighbors(self, v_local, send_slots_local, lookup_local):
        """Inside shard_map: (req_block, k) neighbor values (NaN for -1).

        ``v_local`` is the local *source* shard (block,)."""
        axis = self.axis
        send_buf = v_local[send_slots_local.reshape(-1)].reshape(
            send_slots_local.shape
        )  # (D, R)
        recv = jax.lax.all_to_all(
            send_buf, axis, split_axis=0, concat_axis=0, tiled=False
        )  # (D, R): row o = rows this device requested from owner o
        extended = jnp.concatenate([v_local, recv.reshape(-1)])
        pad = lookup_local < 0
        vals = extended[jnp.maximum(lookup_local, 0)]
        return jnp.where(pad, jnp.nan, vals)


def sharded_laplace_smooth(
    mesh: Mesh,
    neighbor_indices: np.ndarray,
    values: np.ndarray,
    n_steps: int = 1,
    axis: Optional[str] = None,
    method: str = "halo",
):
    """
    Jacobi smoothing over face adjacency, SPMD over the mesh.

    neighbor_indices: (n_face, k) global face indices (-1 padded).

    method="halo" (default) exchanges only the referenced boundary rows
    per step via a precomputed NeighborExchangePlan (one ``all_to_all``);
    method="allgather" gathers the full field — simpler, and
    the right call when remote references are dense.
    """
    axis = axis or mesh.axis_names[0]
    n_devices = mesh.shape[axis]
    n = len(values)
    vals = _pad_to_multiple(np.asarray(values, dtype=np.float64), n_devices, np.nan)
    vec_sharding = NamedSharding(mesh, P(axis))
    vals_d = jax.device_put(vals, vec_sharding)

    if method == "halo":
        plan = NeighborExchangePlan(mesh, neighbor_indices, axis=axis)

        @partial(
            shard_map,
            mesh=mesh,
            in_specs=(P(axis), P(axis, None), P(axis, None)),
            out_specs=P(axis),
            check_rep=False,
        )
        def step(v_local, send_local, lookup_local):
            neigh = plan.gather_neighbors(v_local, send_local, lookup_local)
            neigh_mean = jnp.nanmean(
                jnp.concatenate([neigh, v_local[:, None]], axis=1), axis=1
            )
            return 0.5 * v_local + 0.5 * neigh_mean

        fn = jax.jit(step)
        out = vals_d
        for _ in range(n_steps):
            out = fn(out, plan.send_slots, plan.lookup)
        return np.asarray(out)[:n]

    if method != "allgather":
        raise ValueError(f"method must be 'halo' or 'allgather', got {method}")

    idx = _pad_to_multiple(neighbor_indices.astype(np.int32), n_devices, -1)
    row_sharding = NamedSharding(mesh, P(axis, None))
    idx_d = jax.device_put(idx, row_sharding)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis, None)),
        out_specs=P(axis),
        check_rep=False,
    )
    def step(v_local, idx_local):
        v_full = jax.lax.all_gather(v_local, axis, tiled=True)
        pad = idx_local < 0
        neigh = jnp.where(pad, jnp.nan, v_full[jnp.maximum(idx_local, 0)])
        neigh_mean = jnp.nanmean(
            jnp.concatenate([neigh, v_local[:, None]], axis=1), axis=1
        )
        return 0.5 * v_local + 0.5 * neigh_mean

    fn = jax.jit(step)
    out = vals_d
    for _ in range(n_steps):
        out = fn(out, idx_d)
    return np.asarray(out)[:n]


def sharded_cg_solve(
    mesh: Mesh,
    indices: np.ndarray,
    weights: np.ndarray,
    diag: np.ndarray,
    b: np.ndarray,
    x0: Optional[np.ndarray] = None,
    rtol: float = 0.0,
    atol: float = 1e-6,
    maxiter: int = 500,
    axis: Optional[str] = None,
):
    """
    Distributed Jacobi-preconditioned CG over the mesh.

    The system is windowed: row i is ``diag[i] * x[i] +
    sum_j weights[i, j] * x[indices[i, j]]`` (``indices`` global,
    -1-padded).  Rows, diagonal, and right-hand side are block-sharded
    on ``axis``; each matvec moves only the referenced boundary rows
    via the NeighborExchangePlan's single ``all_to_all`` (O(perimeter)
    with Hilbert-ordered rows), and the CG dot products ride ``psum``.
    The whole iteration runs device-side in one jitted while_loop.

    Returns (solution (n,), iterations).  Reference counterpart: the
    serial scipy ILU0-CG in xugrid/ugrid/interpolate.py:308-317 —
    single-process there, SPMD here.
    """
    axis = axis or mesh.axis_names[0]
    n_devices = mesh.shape[axis]
    n = len(b)
    idxp = _pad_to_multiple(np.asarray(indices, np.int64), n_devices, -1)
    wp = _pad_to_multiple(
        np.asarray(weights, np.float64), n_devices, 0.0
    )
    diagp = _pad_to_multiple(np.asarray(diag, np.float64), n_devices, 1.0)
    bp = _pad_to_multiple(np.asarray(b, np.float64), n_devices, 0.0)
    x0p = (
        np.zeros_like(bp)
        if x0 is None
        else _pad_to_multiple(np.asarray(x0, np.float64), n_devices, 0.0)
    )
    plan = NeighborExchangePlan(mesh, idxp, axis=axis)

    vec = NamedSharding(mesh, P(axis))
    row = NamedSharding(mesh, P(axis, None))
    b_d = jax.device_put(bp, vec)
    x0_d = jax.device_put(x0p, vec)
    diag_d = jax.device_put(diagp, vec)
    w_d = jax.device_put(wp, row)
    tol = max(float(atol), float(rtol) * float(np.linalg.norm(bp)))

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis, None),
                  P(axis, None), P(axis, None)),
        out_specs=(P(axis), P()),
        check_rep=False,
    )
    def solve(b_l, x_l, diag_l, w_l, send_l, lookup_l):
        def matvec(v_l):
            neigh = plan.gather_neighbors(v_l, send_l, lookup_l)
            neigh = jnp.where(jnp.isnan(neigh), 0.0, neigh)
            return diag_l * v_l + jnp.sum(w_l * neigh, axis=1)

        def pdot(u_l, v_l):
            # HIGHEST: an f32 dot may otherwise run in TF32 on the GPU.
            local = jnp.vdot(u_l, v_l, precision=jax.lax.Precision.HIGHEST)
            return jax.lax.psum(local, axis)

        minv = jnp.where(diag_l != 0.0, 1.0 / diag_l, 1.0)
        r = b_l - matvec(x_l)
        z = minv * r
        p = z
        rz = pdot(r, z)

        def cond(state):
            x, r, z, p, rz, k = state
            return (jnp.sqrt(pdot(r, r)) > tol) & (k < maxiter)

        def body(state):
            x, r, z, p, rz, k = state
            Ap = matvec(p)
            pAp = pdot(p, Ap)
            alpha = jnp.where(
                pAp != 0.0, rz / jnp.where(pAp == 0.0, 1.0, pAp), 0.0
            )
            x = x + alpha * p
            r = r - alpha * Ap
            z = minv * r
            rz_new = pdot(r, z)
            beta = jnp.where(
                rz != 0.0, rz_new / jnp.where(rz == 0.0, 1.0, rz), 0.0
            )
            return x, r, z, p * beta + z, rz_new, k + 1

        x, _, _, _, _, k = jax.lax.while_loop(
            cond, body, (x_l, r, z, p, rz, jnp.int32(0))
        )
        return x, k[None]

    x, k = jax.jit(solve)(
        b_d, x0_d, diag_d, w_d, plan.send_slots, plan.lookup
    )
    return np.asarray(x)[:n], int(np.asarray(k)[0])
