"""Property tests: random patterns × formats × ops agree (SURVEY §4.4)."""

import numpy as np
import pytest

from cask_tpu import spmm, spmv
from cask_tpu.formats.convert import (
    bsr_to_csr,
    coo_to_csr,
    csr_to_bsr,
    csr_to_coo,
    to_scipy,
)
from cask_tpu.formats.generate import banded, power_law, random_uniform, stencil_2d
from cask_tpu.ops.dia import dia_plan


def _random_matrix(seed: int):
    rng = np.random.default_rng(seed)
    kind = seed % 4
    if kind == 0:
        return banded(int(rng.integers(50, 400)), int(rng.integers(1, 8)),
                      density=float(rng.uniform(0.3, 1.0)), seed=seed)
    if kind == 1:
        return stencil_2d(int(rng.integers(5, 20)), points=5 if seed % 2 else 9)
    if kind == 2:
        return power_law(int(rng.integers(100, 600)), avg_degree=int(rng.integers(2, 10)),
                         seed=seed)
    return random_uniform(int(rng.integers(40, 300)), int(rng.integers(40, 300)),
                          density=float(rng.uniform(0.005, 0.08)), seed=seed)


@pytest.mark.parametrize("seed", range(12))
def test_conversion_chain_roundtrip(seed):
    a = _random_matrix(seed)
    dense = a.todense()
    coo = csr_to_coo(a)
    np.testing.assert_allclose(coo.todense(), dense)
    back = coo_to_csr(coo)
    np.testing.assert_allclose(back.todense(), dense)
    rng = np.random.default_rng(seed)
    bs = int(rng.integers(2, 9))
    bsr = csr_to_bsr(a, bs)
    np.testing.assert_allclose(bsr.todense(), dense)
    np.testing.assert_allclose(bsr_to_csr(bsr).todense(), dense)


@pytest.mark.parametrize("seed", range(12))
def test_all_formats_spmv_agree(seed):
    a = _random_matrix(seed)
    rng = np.random.default_rng(seed + 1000)
    x = rng.standard_normal(a.shape[1])
    ref = to_scipy(a) @ x
    for mat in (a, csr_to_coo(a), csr_to_bsr(a, 4)):
        y = np.asarray(spmv(mat, x))
        np.testing.assert_allclose(y, ref, rtol=1e-11, atol=1e-11)
    if a.shape[0] == a.shape[1]:
        d = dia_plan(a)
        np.testing.assert_allclose(np.asarray(d.spmv(x)), ref, rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("seed", range(6))
def test_all_formats_spmm_agree(seed):
    a = _random_matrix(seed)
    rng = np.random.default_rng(seed + 2000)
    X = rng.standard_normal((a.shape[1], 8))
    ref = to_scipy(a) @ X
    for mat in (a, csr_to_coo(a), csr_to_bsr(a, 3)):
        Y = np.asarray(spmm(mat, X))
        np.testing.assert_allclose(Y, ref, rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("seed", range(6))
def test_transpose_consistency(seed):
    a = _random_matrix(seed)
    rng = np.random.default_rng(seed + 3000)
    x = rng.standard_normal(a.shape[0])
    ref = to_scipy(a).T @ x
    for mat in (a, csr_to_coo(a), csr_to_bsr(a, 4)):
        y = np.asarray(spmv(mat, x, transpose=True))
        np.testing.assert_allclose(y, ref, rtol=1e-11, atol=1e-11)
