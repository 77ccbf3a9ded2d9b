"""Degenerate-shape edge cases across the op surface."""

import numpy as np
import pytest
import scipy.sparse as sp

from cask_tpu import spmm, spmv
from cask_tpu.formats.convert import csr_to_bsr, from_scipy, to_scipy
from cask_tpu.formats.matrix import CSR
from cask_tpu.ops.dia import dia_plan
from cask_tpu.ops.spgemm import spgemm


def _empty(m, n):
    return CSR(
        data=np.zeros(0),
        indices=np.zeros(0, np.int32),
        indptr=np.zeros(m + 1, np.int32),
        shape=(m, n),
    )


class TestEmpty:
    def test_spmv_empty(self):
        a = _empty(5, 7)
        y = np.asarray(spmv(a, np.ones(7)))
        np.testing.assert_array_equal(y, np.zeros(5))

    def test_spmm_empty(self):
        a = _empty(4, 6)
        y = np.asarray(spmm(a, np.ones((6, 3))))
        np.testing.assert_array_equal(y, np.zeros((4, 3)))

    def test_spgemm_empty(self):
        a = _empty(4, 4)
        c = spgemm(a)
        assert c.nnz == 0
        assert c.shape == (4, 4)

    def test_bsr_empty(self):
        b = csr_to_bsr(_empty(8, 8), 4)
        assert b.n_blocks == 0
        y = np.asarray(spmv(b, np.ones(8)))
        np.testing.assert_array_equal(y, np.zeros(8))

    def test_dia_empty(self):
        d = dia_plan(_empty(6, 6))
        y = np.asarray(d.spmv(np.ones(6)))
        np.testing.assert_array_equal(y, np.zeros(6))


class TestTiny:
    def test_1x1(self):
        s = sp.csr_matrix(np.array([[3.0]]))
        a = from_scipy(s)
        np.testing.assert_allclose(np.asarray(spmv(a, np.array([2.0]))), [6.0])

    def test_single_row(self):
        s = sp.csr_matrix(np.array([[1.0, 0, 2.0]]))
        a = from_scipy(s)
        y = np.asarray(spmv(a, np.array([1.0, 5.0, 10.0])))
        np.testing.assert_allclose(y, [21.0])
        yt = np.asarray(spmv(a, np.array([4.0]), transpose=True))
        np.testing.assert_allclose(yt, [4.0, 0.0, 8.0])

    def test_single_col(self):
        s = sp.csr_matrix(np.array([[1.0], [0.0], [2.0]]))
        a = from_scipy(s)
        y = np.asarray(spmv(a, np.array([3.0])))
        np.testing.assert_allclose(y, [3.0, 0.0, 6.0])


class TestRaggedShapes:
    def test_wide_matrix(self):
        rs = np.random.RandomState(0)
        s = sp.random(10, 1000, density=0.01, format="csr", random_state=rs)
        a = from_scipy(s)
        x = rs.standard_normal(1000)
        np.testing.assert_allclose(np.asarray(spmv(a, x)), s @ x, rtol=1e-12, atol=1e-12)

    def test_tall_matrix(self):
        rs = np.random.RandomState(1)
        s = sp.random(1000, 10, density=0.05, format="csr", random_state=rs)
        a = from_scipy(s)
        x = rs.standard_normal(10)
        np.testing.assert_allclose(np.asarray(spmv(a, x)), s @ x, rtol=1e-12, atol=1e-12)

    def test_bsr_blocksize_larger_than_matrix(self):
        s = sp.csr_matrix(np.eye(3))
        b = csr_to_bsr(from_scipy(s), (8, 8))
        np.testing.assert_allclose(b.todense(), np.eye(3))
        y = np.asarray(spmv(b, np.arange(3.0)))
        np.testing.assert_allclose(y, np.arange(3.0))
