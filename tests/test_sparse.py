"""
Sparse container tests: MatrixCOO/MatrixCSR triplet round-trips and the
device-side PaddedCSR dense-window layout (reference strategy:
tests/test_sparse.py).
"""

import numpy as np
import pytest

from xugrid_tpu.core import sparse


@pytest.fixture
def triplet():
    # 3x4 matrix:
    # [[0, 1, 0, 2],
    #  [0, 0, 0, 0],
    #  [3, 0, 4, 5]]
    row = np.array([0, 0, 2, 2, 2])
    col = np.array([1, 3, 0, 2, 3])
    data = np.array([1.0, 2.0, 3.0, 4.0, 5.0])
    return row, col, data


def test_matrix_coo(triplet):
    row, col, data = triplet
    A = sparse.MatrixCOO.from_triplet(row, col, data, n=3, m=4)
    assert A.n == 3
    assert A.m == 4
    assert A.nnz == 5
    np.testing.assert_array_equal(A.row, row)
    np.testing.assert_array_equal(A.col, col)
    np.testing.assert_allclose(A.data, data)

    # Shape inference from max indices.
    B = sparse.MatrixCOO.from_triplet(row, col, data)
    assert B.n == 3
    assert B.m == 4


def test_matrix_csr(triplet):
    row, col, data = triplet
    A = sparse.MatrixCSR.from_triplet(row, col, data, n=3, m=4)
    np.testing.assert_array_equal(A.indptr, [0, 2, 2, 5])
    np.testing.assert_array_equal(A.indices, col)
    np.testing.assert_allclose(A.data, data)
    # Dense equivalence via scipy.
    import scipy.sparse

    dense = scipy.sparse.csr_matrix(
        (A.data, A.indices, A.indptr), shape=(A.n, A.m)
    ).toarray()
    expected = np.zeros((3, 4))
    expected[row, col] = data
    np.testing.assert_allclose(dense, expected)


def test_coo_csr_roundtrip(triplet):
    row, col, data = triplet
    coo = sparse.MatrixCOO.from_triplet(row, col, data, n=3, m=4)
    back = coo.to_csr().to_coo()
    np.testing.assert_array_equal(back.row, row)
    np.testing.assert_array_equal(back.col, col)
    np.testing.assert_allclose(back.data, data)
    assert back.nnz == coo.nnz


def test_nzrange_row_slice_columns_and_values(triplet):
    row, col, data = triplet
    A = sparse.MatrixCSR.from_triplet(row, col, data, n=3, m=4)
    assert tuple(sparse.nzrange(A, 0)) == (0, 2)
    assert tuple(sparse.nzrange(A, 1)) == (2, 2)
    assert tuple(sparse.nzrange(A, 2)) == (2, 5)
    sl = sparse.row_slice(A, 2)
    cols, vals = sparse.columns_and_values(A, sl)
    np.testing.assert_array_equal(cols, [0, 2, 3])
    np.testing.assert_allclose(vals, [3.0, 4.0, 5.0])


def test_unsorted_rows_sorted_stably():
    # Triplets arriving row-unsorted must land in CSR row order with
    # within-row insertion order preserved (stable sort).
    row = np.array([2, 0, 2, 0])
    col = np.array([1, 3, 0, 2])
    data = np.array([10.0, 20.0, 30.0, 40.0])
    A = sparse.MatrixCSR.from_triplet(row, col, data, n=3, m=4)
    np.testing.assert_array_equal(A.indptr, [0, 2, 2, 4])
    np.testing.assert_array_equal(A.indices, [3, 2, 1, 0])
    np.testing.assert_allclose(A.data, [20.0, 40.0, 10.0, 30.0])


class TestPaddedCSR:
    def test_from_csr(self, triplet):
        row, col, data = triplet
        A = sparse.MatrixCSR.from_triplet(row, col, data, n=3, m=4)
        P = sparse.PaddedCSR.from_csr(A, dtype=np.float32)
        assert P.n == 3
        assert P.m == 4
        assert P.w_max == 3
        assert P.indices.shape == (3, 3)
        np.testing.assert_array_equal(P.indices[0], [1, 3, -1])
        np.testing.assert_array_equal(P.indices[1], [-1, -1, -1])
        np.testing.assert_array_equal(P.indices[2], [0, 2, 3])
        np.testing.assert_allclose(P.weights[0], [1.0, 2.0, 0.0])
        np.testing.assert_allclose(P.weights[1], 0.0)
        assert P.weights.dtype == np.float32

    def test_padded_matvec_matches_scipy(self):
        rng = np.random.default_rng(0)
        n, m, nnz = 50, 80, 400
        row = rng.integers(0, n, nnz)
        col = rng.integers(0, m, nnz)
        data = rng.normal(size=nnz)
        A = sparse.MatrixCSR.from_triplet(row, col, data, n=n, m=m)
        P = sparse.PaddedCSR.from_csr(A)
        x = rng.normal(size=m)
        # Padded gather matvec: -1 indices gather anything, weight 0.
        gathered = np.where(P.indices >= 0, x[P.indices], 0.0)
        out = (gathered * P.weights).sum(axis=1)
        import scipy.sparse

        W = scipy.sparse.csr_matrix(
            (A.data, A.indices, A.indptr), shape=(n, m)
        )
        np.testing.assert_allclose(out, W @ x)

    def test_empty_matrix(self):
        A = sparse.MatrixCSR.from_triplet(
            np.array([], dtype=int), np.array([], dtype=int), np.array([]),
            n=3, m=4,
        )
        P = sparse.PaddedCSR.from_csr(A)
        assert P.w_max == 1
        assert (P.indices == -1).all()
        assert (P.weights == 0.0).all()
