"""
Interpolation of missing values on UGRID topologies.

* ``interpolate_na_helper``: broadcast a 1D fill function over extra
  (time/layer) dimensions.
* ``laplace_interpolate``: solve Laplace's equation over the unknown
  entities with known values as Dirichlet boundaries.

The iterative path is a **jit-compiled preconditioned conjugate
gradient** over a static-shape COO matvec (segment-sum).  The reference
uses a sequential numba ILU0 factorization
(xugrid/ugrid/interpolate.py:30-204) — triangular solves are inherently
serial and map poorly onto a vector machine.  Here the preconditioner
is a fixed-degree **Chebyshev polynomial of the Jacobi-scaled
operator**: a handful of extra matvecs per iteration (fully parallel,
runs at HBM bandwidth) in exchange for a several-fold drop in PCG
iterations, the classic ILU substitute on vector hardware.  Unknown and
nonzero counts are padded to power-of-two buckets so repeated solves
reuse compiles; multiple right-hand sides (extra dims) are batched via
vmap.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import os

import numpy as np
import scipy.sparse
from scipy.sparse.linalg import spsolve

from xugrid_tpu import xdata
from xugrid_tpu.constants import FloatArray


def _dot(a, b):
    """Inner product at full float32 precision (an f32 dot may otherwise
    run in TF32 on the GPU)."""
    import jax
    import jax.numpy as jnp

    return jnp.vdot(a, b, precision=jax.lax.Precision.HIGHEST)


def _make_chebyshev_precond(matvec, minv, lmax, degree):
    """Shared Chebyshev approximation of (D^-1 A)^-1 on [lmax/30, lmax]
    applied to D^-1 r: a fixed SPD linear operator (valid for PCG),
    built from matvecs only.  degree <= 1 degrades to plain Jacobi."""
    if degree <= 1:
        def precond(r):
            return minv * r

        return precond

    lo = lmax / 30.0
    theta = (lmax + lo) / 2.0
    delta = (lmax - lo) / 2.0
    sigma = theta / delta

    def precond(r):
        rd = minv * r
        d = rd / theta
        z = d
        rho_prev = 1.0 / sigma
        for _ in range(degree - 1):
            rho = 1.0 / (2.0 * sigma - rho_prev)
            resid = rd - minv * matvec(z)
            d = rho * rho_prev * d + (2.0 * rho / delta) * resid
            z = z + d
            rho_prev = rho
        return z

    return precond


def _make_pcg_coo():
    """COO segment-sum PCG, vmapped over right-hand sides."""
    import jax
    import jax.numpy as jnp

    @partial(jax.jit, static_argnames=("maxiter", "degree"))
    def solve(rows, cols, vals, diag, b, x0, rtol, atol, lmax, maxiter, degree):
        n = b.shape[-1]

        def matvec(x):
            return jax.ops.segment_sum(vals * x[cols], rows, num_segments=n)

        minv = jnp.where(diag != 0.0, 1.0 / diag, 1.0)
        precond = _make_chebyshev_precond(matvec, minv, lmax, degree)

        def one(b1, x1):
            r = b1 - matvec(x1)
            z = precond(r)
            p = z
            rz = _dot(r, z)
            bnorm = jnp.linalg.norm(b1)
            tol = jnp.maximum(atol, rtol * bnorm)

            def cond(state):
                x, r, z, p, rz, k = state
                return (jnp.linalg.norm(r) > tol) & (k < maxiter)

            def body(state):
                x, r, z, p, rz, k = state
                Ap = matvec(p)
                alpha = rz / _dot(p, Ap)
                x = x + alpha * p
                r = r - alpha * Ap
                z = precond(r)
                rz_new = _dot(r, z)
                beta = rz_new / rz
                p = z + beta * p
                return x, r, z, p, rz_new, k + 1

            x, r, _, _, _, k = jax.lax.while_loop(
                cond, body, (x1, r, z, p, rz, jnp.int32(0))
            )
            return x, k

        if b.ndim == 1:
            return one(b, x0)
        return jax.vmap(one)(b, x0)

    return solve


def _make_pcg_dia():
    """Stencil (DIA-format) PCG: when the unknown-unknown graph lives
    on a small set of constant index offsets (meshes derived from
    structured grids — the common hydrological case), the SpMV is a sum
    of shifted elementwise streams, no gather at all:

        (A x)[r] = diag[r]·x[r] + Σ_k dia[k, r]·x[r + off_k]

    Each term is a static slice of a padded 1-D iterate — elementwise
    streams with no gather.  Replaces the reference's scipy/numba
    spsolve+CG path (xugrid/ugrid/interpolate.py:308-317).  The system stays FULL-SIZE (no compaction to the
    unknown set, which would smear the diagonals): known nodes carry
    identity rows, A = P(D-W)P + (I-P) stays symmetric positive
    definite, and known entries are exact from the initial guess."""
    import jax
    import jax.numpy as jnp

    @partial(
        jax.jit, static_argnames=("offsets", "m_pad", "maxiter", "degree")
    )
    def solve(dia, diag, b, x0, bnorm, rtol, atol, lmax, offsets, m_pad,
              maxiter, degree):
        n = b.shape[-1]

        def matvec(x):  # (n,) -> (n,)
            xp = jnp.pad(x, (m_pad, m_pad))
            out = diag * x
            for k, d in enumerate(offsets):
                shifted = jax.lax.slice(xp, (m_pad + d,), (m_pad + d + n,))
                out = out + dia[k] * shifted
            return out

        minv = jnp.where(diag != 0.0, 1.0 / diag, 1.0)
        precond = _make_chebyshev_precond(matvec, minv, lmax, degree)

        def one(b1, x1, bn):
            r = b1 - matvec(x1)
            z = precond(r)
            p = z
            rz = _dot(r, z)
            # bn is the UNKNOWN-row norm of b, computed on host: the
            # full-size b carries every known value on identity rows,
            # whose norm would loosen rtol by the known/unknown ratio
            # (identity rows hold zero residual throughout, so the
            # residual norm below already measures only the unknowns).
            tol = jnp.maximum(atol, rtol * bn)

            def cond(state):
                x, r, z, p, rz, k = state
                return (jnp.linalg.norm(r) > tol) & (k < maxiter)

            def body(state):
                x, r, z, p, rz, k = state
                Ap = matvec(p)
                pAp = _dot(p, Ap)
                alpha = jnp.where(
                    pAp != 0.0, rz / jnp.where(pAp == 0.0, 1.0, pAp), 0.0
                )
                x = x + alpha * p
                r = r - alpha * Ap
                z = precond(r)
                rz_new = _dot(r, z)
                beta = jnp.where(
                    rz != 0.0, rz_new / jnp.where(rz == 0.0, 1.0, rz), 0.0
                )
                p = z + beta * p
                return x, r, z, p, rz_new, k + 1

            x, r, _, _, _, k = jax.lax.while_loop(
                cond, body, (x1, r, z, p, rz, jnp.int32(0))
            )
            return x, k

        if b.ndim == 1:
            return one(b, x0, bnorm)
        return jax.vmap(one)(b, x0, bnorm)

    return solve


#: max distinct unknown-unknown index offsets for the DIA solver.
_DIA_MAX_K = 64

#: cached DIA assemblies keyed by (W bytes, solve_mask, notnull, dtype)
#: content hash — interpolate_na solves the same Laplacian for every
#: time slice, and at 1M nodes the host-side COO fold + diagonal fills
#: + the ~30 MB device transfer cost more than the fused solve itself.
_DIA_ASSEMBLY: dict = {}


def _rcm_banded_perm(W, solve_mask):
    """Reverse-Cuthill-McKee permutation of the full node graph when it
    bands the unknown-unknown offsets into the DIA budget, else None.
    The offset census runs on the raw COO through the inverse
    permutation — no permuted matrix is materialized for the (common)
    reject case."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    try:
        perm = np.asarray(
            reverse_cuthill_mckee(W.tocsr(), symmetric_mode=False),
            dtype=np.int64,
        )
    except Exception:  # pragma: no cover - csgraph edge failures
        return None
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    coo = W.tocoo()
    d = inv[coo.col] - inv[coo.row]
    uu = solve_mask[coo.row] & solve_mask[coo.col] & (d != 0)
    n_off = len(np.unique(d[uu]))
    if n_off == 0 or n_off > _DIA_MAX_K:
        return None
    return perm


def _dia_assemble(W, solve_mask, notnull, dt):
    """Matrix-dependent part of the DIA solve (cacheable across
    right-hand sides): banded layout, Gershgorin bound, and the
    device-resident dia/diag arrays.  Returns None when the
    unknown-unknown graph is not banded."""
    import jax.numpy as jnp

    n = W.shape[0]
    coo = W.tocoo()
    # User-built CSR may carry duplicate entries (scipy never
    # canonicalizes); the `dia[kslot, r] = -v` assembly below OVERWRITES
    # rather than accumulates, so fold duplicates first (the COO/direct
    # paths accumulate naturally).
    coo.sum_duplicates()
    r, c, v = coo.row, coo.col, coo.data
    d = c.astype(np.int64) - r.astype(np.int64)
    uu = solve_mask[r] & solve_mask[c] & (d != 0)
    offsets = np.unique(d[uu])
    if len(offsets) == 0 or len(offsets) > _DIA_MAX_K:
        return None

    n_pad = _next_pow2(n)
    # Full diagonal: row sums over ALL neighbors for unknowns (the
    # Laplacian D), identity elsewhere; self-loops fold in (D - W).
    diag_full = np.ones(n_pad, dt)
    rowsum = np.asarray(W.sum(axis=1)).ravel()
    unk = np.flatnonzero(solve_mask)
    diag_full[unk] = rowsum[unk]
    sl = (d == 0) & solve_mask[r]
    if sl.any():
        np.subtract.at(diag_full, r[sl], v[sl].astype(dt))
    dia = np.zeros((len(offsets), n_pad), dt)
    kslot = np.searchsorted(offsets, d[uu])
    dia[kslot, r[uu]] = -v[uu]

    # Gershgorin bound on the Jacobi-scaled spectrum (unknown rows).
    offabs = np.zeros(n_pad)
    np.add.at(offabs, r[uu], np.abs(v[uu]))
    safe = np.where(diag_full != 0.0, diag_full, 1.0)
    lmax = float(np.max(1.0 + offabs / np.abs(safe), initial=1.0))

    # RHS ingredients: known-neighbor entries of the unknown rows.
    ukn = solve_mask[r] & notnull[c]
    return {
        "offsets": tuple(int(o) for o in offsets),
        "m_pad": int(np.abs(offsets).max()),
        "n_pad": n_pad,
        "unk": unk,
        "lmax": lmax,
        "dia_dev": jnp.asarray(dia),
        "diag_dev": jnp.asarray(diag_full),
        "r_ukn": r[ukn],
        "c_ukn": c[ukn],
        "v_ukn": v[ukn],
    }


def _try_dia_solve(
    W, solve_mask, notnull, matrix2d, rtol, atol, maxiter, degree
):
    """Attempt the DIA stencil solve on the full-size system; returns
    (solutions (E, n_unknown), iters) or None when the graph is not
    banded (more than _DIA_MAX_K distinct unknown-unknown offsets)."""
    mode = os.environ.get("XUGRID_TPU_CG_DIA", "auto")
    if mode == "0":
        return None
    import hashlib

    import jax

    n = W.shape[0]
    # Assemble in the dtype the device will compute in: with x64 off
    # (the default) f64 staging would double every host fill and
    # host-to-device copy only for jax to downcast on arrival.
    dt = np.float64 if jax.config.read("jax_enable_x64") else np.float32
    Wc = W.tocsr()
    h = hashlib.blake2b(digest_size=16)
    for part in (Wc.indptr, Wc.indices, Wc.data, solve_mask, notnull):
        h.update(np.ascontiguousarray(part).tobytes())
    key = (Wc.shape, h.hexdigest(), dt)
    asm = _DIA_ASSEMBLY.get(key, "miss")
    if asm == "miss":
        asm = _dia_assemble(Wc, solve_mask, notnull, dt)
        if asm is None and mode != "norcm":
            # Not banded as given: an RCM relabeling bands narrow /
            # quasi-1D unstructured graphs into the DIA budget (wide 2D
            # meshes reject cheaply inside the census and ride the
            # gather SpMV instead).
            perm = _rcm_banded_perm(Wc, solve_mask)
            if perm is not None:
                Wp = Wc[perm, :][:, perm].tocsr()
                asm = _dia_assemble(
                    Wp, solve_mask[perm], notnull[perm], dt
                )
                if asm is not None:
                    asm["perm"] = perm
        if len(_DIA_ASSEMBLY) > 4:
            _DIA_ASSEMBLY.clear()
        _DIA_ASSEMBLY[key] = asm
    if asm is None:
        return None
    perm = asm.get("perm")
    if perm is not None:
        matrix2d = matrix2d[:, perm]
        solve_mask = solve_mask[perm]
        notnull = notnull[perm]
    offsets = np.asarray(asm["offsets"], np.int64)
    n_pad = asm["n_pad"]
    unk = asm["unk"]
    lmax = asm["lmax"]
    r_ukn, c_ukn, v_ukn = asm["r_ukn"], asm["c_ukn"], asm["v_ukn"]
    E = matrix2d.shape[0]
    b = np.zeros((E, n_pad), dt)
    x0 = np.zeros((E, n_pad), dt)
    means = np.nanmean(matrix2d, axis=1)
    for k in range(E):
        bk = np.zeros(n)
        np.add.at(bk, r_ukn, v_ukn * matrix2d[k, c_ukn])
        bk[notnull] = matrix2d[k, notnull]
        b[k, :n] = bk
        # Unknowns start at the known mean; identity rows (known and
        # kept-NaN nodes) start exactly at their RHS -> zero residual.
        x0[k, :n] = np.where(solve_mask, means[k], bk)

    global _PCG_DIA
    if _PCG_DIA is None:
        _PCG_DIA = _make_pcg_dia()
    import jax.numpy as jnp

    squeeze = E == 1
    bj = jnp.asarray(b[0] if squeeze else b)
    x0j = jnp.asarray(x0[0] if squeeze else x0)
    # rtol reference norm over the UNKNOWN rows only (the compacted
    # system's b), matching the COO path: the full-size b
    # carries every known value and would loosen the criterion by the
    # known/unknown ratio.
    bnorm = np.linalg.norm(b[:, unk], axis=1).astype(dt)
    bnj = jnp.asarray(bnorm[0] if squeeze else bnorm)
    x, k = _PCG_DIA(
        asm["dia_dev"], asm["diag_dev"], bj, x0j, bnj,
        float(rtol), float(atol), float(lmax),
        offsets=asm["offsets"], m_pad=asm["m_pad"],
        maxiter=int(maxiter), degree=int(degree),
    )
    x = np.atleast_2d(np.asarray(x))
    sols = x[:, unk]
    if perm is not None:
        # unk indexes the RCM-relabeled system; the caller assigns to
        # the ORIGINAL unknown ids in ascending order.
        sols = sols[:, np.argsort(perm[unk])]
    return sols, np.atleast_1d(np.asarray(k))


_PCG_COO = None
_PCG_DIA = None
#: laplace_interpolate's system-extraction/RCM cache (content-keyed).
_LAPLACE_PREP: dict = {}

#: diagnostics of the most recent iterative solve:
#: {"iterations": int, "n_unknown": int, "degree": int}
last_solve_info: dict = {}


def _next_pow2(n: int) -> int:
    return 1 << max(int(np.ceil(np.log2(max(n, 1)))), 0)


def cg_solve(
    rows, cols, vals, diag, b, x0, rtol, atol, maxiter, degree: int = 4
):
    """
    Chebyshev-Jacobi preconditioned CG over a COO system.

    The device matvec is a COO segment-sum; right-hand sides are
    batched with vmap.  Unknown and nonzero counts pad to power-of-two
    buckets for compile reuse.

    Returns (solutions, iterations): iterations is the PCG iteration
    count until every right-hand side converged.

    Layout contract: ``rows/cols/vals`` must be ordered
    ``[off-diagonal entries..., diagonal entries]`` with exactly the n
    diagonal entries (rows[i] == cols[i] == i) at the tail — the
    Gershgorin bound for the Chebyshev interval depends on it, and an
    underestimated spectrum makes the preconditioner indefinite.
    """
    global _PCG_COO

    n = b.shape[-1]
    nnz = len(vals)
    n_pad = _next_pow2(n)

    if not (
        len(rows) >= n
        and np.array_equal(rows[-n:], np.arange(n))
        and np.array_equal(cols[-n:], np.arange(n))
    ):
        raise ValueError(
            "cg_solve expects [offdiag..., diag...] COO layout with the "
            "n diagonal entries at the tail (see docstring)."
        )

    # Gershgorin bound on the Jacobi-scaled spectrum: per unknown,
    # 1 + sum(|offdiag|)/diag (diag entries sit at the tail of vals).
    offdiag_abs = np.zeros(n)
    m_off = nnz - n  # vals layout: [offdiag..., diag...]
    np.add.at(offdiag_abs, rows[:m_off], np.abs(vals[:m_off]))
    safe_diag = np.where(diag != 0.0, diag, 1.0)
    lmax = float(np.max(1.0 + offdiag_abs / np.abs(safe_diag), initial=1.0))

    # COO segment-sum matvec (pad to the pow2 bucket).
    if _PCG_COO is None:
        _PCG_COO = _make_pcg_coo()
    nnz_pad = _next_pow2(nnz)
    if n_pad > n or nnz_pad > nnz:
        rows = np.concatenate(
            [rows, np.full(nnz_pad - nnz, n_pad - 1, rows.dtype)]
        )
        cols = np.concatenate(
            [cols, np.full(nnz_pad - nnz, n_pad - 1, cols.dtype)]
        )
        vals = np.concatenate([vals, np.zeros(nnz_pad - nnz)])
        diag = np.concatenate([diag, np.ones(n_pad - n)])
        pad_shape = b.shape[:-1] + (n_pad - n,)
        b = np.concatenate([b, np.zeros(pad_shape)], axis=-1)
        x0 = np.concatenate([x0, np.zeros(pad_shape)], axis=-1)
    x, k = _PCG_COO(
        rows, cols, vals, diag, b, x0,
        float(rtol), float(atol), lmax, int(maxiter), int(degree),
    )
    return np.asarray(x)[..., :n], np.asarray(k)


def laplace_interpolate(
    data: FloatArray,
    connectivity: scipy.sparse.csr_matrix,
    use_weights: bool = True,
    components_labels: Optional[np.ndarray] = None,
    direct_solve: bool = False,
    delta: float = 0.0,
    relax: float = 0.0,
    rtol: float = 0.0,
    atol: float = 1.0e-4,
    maxiter: int = 500,
    precondition_degree: int = 4,
) -> FloatArray:
    """
    Fill NaNs in ``data`` by Laplace interpolation over the adjacency
    graph ``connectivity``.

    ``data`` may be 1D (n,) or 2D (n_extra, n): extra rows sharing the
    same NaN pattern are solved as batched right-hand sides.
    ``delta``/``relax`` are accepted for reference API parity (ILU0
    tuning knobs); the Chebyshev-Jacobi PCG solver does not use them.
    ``precondition_degree`` sets the Chebyshev polynomial degree
    (1 = plain Jacobi).
    """
    if connectivity.shape[0] != connectivity.shape[1]:
        raise ValueError(
            "connectivity is not a square matrix: "
            f"{connectivity.shape[0]} x {connectivity.shape[1]}"
        )
    data = np.asarray(data, dtype=np.float64)
    squeeze = data.ndim == 1
    matrix2d = np.atleast_2d(data)
    isnull = np.isnan(matrix2d[0])
    if not isnull.any():
        return data.copy()
    notnull = ~isnull
    if not notnull.any():
        raise ValueError("All values are NA.")

    # Guard: unknowns in components without any known value stay NaN.
    keep_nan = np.zeros(len(isnull), dtype=bool)
    if components_labels is not None:
        for label in np.unique(components_labels):
            in_comp = components_labels == label
            if not (notnull & in_comp).any():
                keep_nan |= in_comp
    solve_mask = isnull & ~keep_nan
    if not solve_mask.any():
        return data.copy()

    n = connectivity.shape[0]
    unknown = np.flatnonzero(solve_mask)
    known = np.flatnonzero(notnull)
    # Build the Laplacian rows for the unknowns: L = D - W.
    W = connectivity.tocsr().astype(np.float64)
    if not use_weights:
        W = W.copy()
        W.data = np.ones_like(W.data)

    if not direct_solve:
        # Banded graphs (structured-derived meshes) take the DIA
        # stencil solver: shifted elementwise streams instead of a
        # gathered SpMV.
        dia_result = _try_dia_solve(
            W, solve_mask, notnull, matrix2d, rtol, atol, maxiter,
            precondition_degree,
        )
        if dia_result is not None:
            solutions, iters = dia_result
            last_solve_info.update(
                iterations=int(np.max(iters)),
                n_unknown=len(unknown),
                degree=precondition_degree,
                mode="dia",
            )
            out = matrix2d.copy()
            out[:, unknown] = solutions
            return out[0] if squeeze else out
    # System extraction + RCM relabeling depend only on (W, NaN
    # pattern): cache them by content hash — interpolate_na re-solves
    # the same Laplacian for every time slice, and at 1M nodes this
    # block (CSR slice, COO splits, reverse-Cuthill-McKee) costs
    # seconds per call (collisions would silently corrupt: full bytes).
    prep = None
    prep_key = None
    if not direct_solve:
        import hashlib

        h = hashlib.blake2b(digest_size=16)
        for part in (W.indptr, W.indices, W.data, solve_mask, notnull):
            h.update(np.ascontiguousarray(part).tobytes())
        prep_key = (
            W.shape, h.hexdigest(),
            os.environ.get("XUGRID_TPU_CG_RCM", "1"),
        )
        prep = _LAPLACE_PREP.get(prep_key)

    if prep is None:
        # Global index -> position in the unknown set (-1 for known).
        position = np.full(n, -1, dtype=np.int64)
        position[unknown] = np.arange(len(unknown))

        sub = W[unknown]  # (n_unknown, n)
        coo = sub.tocoo()
        is_unknown_col = solve_mask[coo.col]
        rows_uu = coo.row[is_unknown_col]
        cols_uu = position[coo.col[is_unknown_col]]
        vals_uu = -coo.data[is_unknown_col]
        diag = np.asarray(sub.sum(axis=1)).ravel()

        # Right-hand side terms: weights to known neighbors.
        is_known_col = notnull[coo.col]
        rows_uk = coo.row[is_known_col]
        cols_uk = coo.col[is_known_col]
        w_uk = coo.data[is_known_col]

        # Assemble A = diag + offdiag(uu) in COO, with the diagonal
        # entries appended so the matvec covers both.
        rows = np.concatenate([rows_uu, np.arange(len(unknown))])
        cols = np.concatenate([cols_uu, np.arange(len(unknown))])
        vals = np.concatenate([vals_uu, diag])

        # RCM-relabel large unknown systems: a banded ordering keeps
        # each matvec's gathers local in memory, which a shuffled mesh
        # numbering does not.  The permutation is a similarity
        # transform (iterations unchanged).
        nu = len(unknown)
        perm_cg = pinv = None
        if (
            not direct_solve
            and nu > 4096
            and os.environ.get("XUGRID_TPU_CG_RCM", "1") != "0"
        ):
            from scipy.sparse.csgraph import reverse_cuthill_mckee

            A_uu = scipy.sparse.coo_matrix(
                (vals_uu, (rows_uu, cols_uu)), shape=(nu, nu)
            ).tocsr()
            perm_cg = np.asarray(
                reverse_cuthill_mckee(A_uu, symmetric_mode=True),
                dtype=np.int64,
            )
            pinv = np.empty(nu, np.int64)
            pinv[perm_cg] = np.arange(nu)
            m_off = len(vals) - nu
            rows = np.concatenate([pinv[rows[:m_off]], np.arange(nu)])
            cols = np.concatenate([pinv[cols[:m_off]], np.arange(nu)])
            vals = np.concatenate([vals[:m_off], diag[perm_cg]])
            diag = diag[perm_cg]
        if prep_key is not None:
            if len(_LAPLACE_PREP) > 2:
                _LAPLACE_PREP.clear()
            _LAPLACE_PREP[prep_key] = (
                rows, cols, vals, diag, rows_uk, cols_uk, w_uk,
                perm_cg, pinv,
            )
    else:
        (rows, cols, vals, diag, rows_uk, cols_uk, w_uk,
         perm_cg, pinv) = prep

    n_extra = matrix2d.shape[0]
    b = np.zeros((n_extra, len(unknown)))
    for k in range(n_extra):
        np.add.at(b[k], rows_uk, w_uk * matrix2d[k, cols_uk])

    if direct_solve:
        A = scipy.sparse.coo_matrix(
            (vals, (rows, cols)), shape=(len(unknown), len(unknown))
        ).tocsr()
        solutions = np.stack([spsolve(A, b[k]) for k in range(n_extra)])
    else:
        x0 = np.zeros_like(b)
        # Initial guess: mean of known values per row.
        means = np.nanmean(matrix2d, axis=1)
        x0 += means[:, None]
        if perm_cg is not None:
            b = b[:, perm_cg]
            x0 = x0[:, perm_cg]
        solutions, iters = cg_solve(
            rows, cols, vals, diag, b, x0, rtol, atol, maxiter,
            degree=precondition_degree,
        )
        if perm_cg is not None:
            solutions = np.atleast_2d(solutions)[:, pinv]
        last_solve_info.update(
            iterations=int(np.max(iters)),
            n_unknown=len(unknown),
            degree=precondition_degree,
            mode="cg",
        )

    out = matrix2d.copy()
    out[:, unknown] = solutions
    return out[0] if squeeze else out


def nearest_interpolate(
    coordinates: FloatArray,
    data: FloatArray,
    max_distance: float,
) -> FloatArray:
    """Standalone nearest-fill on arbitrary coordinates."""
    from xugrid_tpu.spatial.nearest import nearest_points

    isnull = np.isnan(data)
    if isnull.all():
        raise ValueError("All values are NA.")
    if not isnull.any():
        return data.copy()
    i_source = np.flatnonzero(~isnull)
    i_target = np.flatnonzero(isnull)
    index = nearest_points(
        coordinates[i_source], coordinates[i_target], max_distance
    )
    keep = index >= 0
    out = data.copy()
    out[i_target[keep]] = data[i_source[index[keep]]]
    return out


def interpolate_na_helper(
    da: xdata.DataArray,
    ugrid_dim: str,
    func: Callable,
    kwargs: dict,
) -> xdata.DataArray:
    """
    Apply a 1D fill function along ``ugrid_dim``, broadcasting over any
    extra dimensions (reference: interpolate.py:333-351 uses
    apply_ufunc(vectorize=True)).
    """
    extra_dims = [d for d in da.dims if d != ugrid_dim]
    transposed = da.transpose(*extra_dims, ugrid_dim)
    values = np.asarray(transposed.data, dtype=np.float64)
    flat = values.reshape(-1, values.shape[-1])

    if func is laplace_interpolate and len(flat) > 1:
        # Batched solve when the NaN pattern matches across rows.
        patterns = np.isnan(flat)
        if (patterns == patterns[0]).all():
            filled = laplace_interpolate(flat, **kwargs)
        else:
            filled = np.stack([func(row, **kwargs) for row in flat])
    else:
        filled = np.stack([func(row, **kwargs) for row in flat])
    filled = filled.reshape(values.shape)

    out = xdata.DataArray(
        filled,
        dims=tuple(extra_dims) + (ugrid_dim,),
        name=da.name,
        attrs=dict(da.attrs),
    )
    out._coords.update(transposed._coords)
    return out.transpose(*da.dims)
