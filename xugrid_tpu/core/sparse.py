"""
Sparse weight-matrix containers for regridding.

``MatrixCOO``/``MatrixCSR`` are host-side NamedTuples (parity:
xugrid/core/sparse.py:22-158).  The device-side form is ``PaddedCSR``:
every target row padded to the maximum neighbor count, giving the
static-shape (n_target, w_max) gather windows that the jitted apply
kernels consume — a dense-window layout with no per-row loops, where
every reduction is a vectorized op over the trailing axis.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from xugrid_tpu.constants import FloatArray, IntArray, IntDType


class MatrixCOO(NamedTuple):
    """Sparse matrix in coordinate (triplet) form."""

    data: FloatArray
    row: IntArray
    col: IntArray
    n: int
    m: int
    nnz: int

    @staticmethod
    def from_triplet(row, col, data, n=None, m=None) -> "MatrixCOO":
        if n is None:
            n = int(row.max()) + 1
        if m is None:
            m = int(col.max()) + 1
        return MatrixCOO(
            np.asarray(data, dtype=np.float64),
            np.asarray(row, dtype=IntDType),
            np.asarray(col, dtype=IntDType),
            int(n),
            int(m),
            len(data),
        )

    def to_csr(self) -> "MatrixCSR":
        from xugrid_tpu.utils.native import csr_from_triplet_native

        native = csr_from_triplet_native(self.row, self.col, self.data, self.n)
        if native is not None:
            # Stable counting sort by row == np.argsort(kind="stable"):
            # exact parity with the fallback below, O(nnz) not O(nnz log).
            data, col, indptr = native
            return MatrixCSR(data, col, indptr, self.n, self.m, self.nnz)
        order = np.argsort(self.row, kind="stable")
        row = self.row[order]
        indptr = np.zeros(self.n + 1, dtype=IntDType)
        np.add.at(indptr, row + 1, 1)
        np.cumsum(indptr, out=indptr)
        return MatrixCSR(
            self.data[order],
            self.col[order],
            indptr,
            self.n,
            self.m,
            self.nnz,
        )


class MatrixCSR(NamedTuple):
    """Sparse matrix in compressed row form."""

    data: FloatArray
    indices: IntArray
    indptr: IntArray
    n: int
    m: int
    nnz: int

    @staticmethod
    def from_triplet(row, col, data, n=None, m=None) -> "MatrixCSR":
        return MatrixCOO.from_triplet(row, col, data, n, m).to_csr()

    def to_coo(self) -> MatrixCOO:
        n_per_row = np.diff(self.indptr)
        row = np.repeat(np.arange(self.n, dtype=IntDType), n_per_row)
        return MatrixCOO(self.data, row, self.indices, self.n, self.m, self.nnz)


def nzrange(A: MatrixCSR, row: int):
    """Non-zero range of a CSR row."""
    return A.indptr[row], A.indptr[row + 1]


def row_slice(A: MatrixCSR, row: int) -> slice:
    start, end = nzrange(A, row)
    return slice(start, end)


def columns_and_values(A: MatrixCSR, row_sl: slice):
    return A.indices[row_sl], A.data[row_sl]


class PaddedCSR(NamedTuple):
    """
    Dense-window CSR: (n, w_max) column indices (-1 padded) and weights
    (0 padded).  The device layout for regrid apply.
    """

    indices: np.ndarray  # (n, w_max) int32
    weights: np.ndarray  # (n, w_max) float
    n: int
    m: int
    w_max: int

    @staticmethod
    def from_csr(A: MatrixCSR, dtype=np.float64) -> "PaddedCSR":
        n_per_row = np.diff(A.indptr)
        w_max = max(int(n_per_row.max()) if len(n_per_row) else 0, 1)
        indices = np.full((A.n, w_max), -1, dtype=np.int32)
        weights = np.zeros((A.n, w_max), dtype=dtype)
        # ragged -> padded scatter
        cols = np.arange(w_max)[np.newaxis, :] < n_per_row[:, np.newaxis]
        indices[cols] = A.indices
        weights[cols] = A.data.astype(dtype)
        return PaddedCSR(indices, weights, A.n, A.m, w_max)

    @staticmethod
    def from_coo(A: MatrixCOO, dtype=np.float64) -> "PaddedCSR":
        return PaddedCSR.from_csr(A.to_csr(), dtype)
