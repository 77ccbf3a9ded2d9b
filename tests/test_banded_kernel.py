"""The banded SpMV kernel (Pallas, Triton route) in interpret mode, against
scipy and the XLA formulation it replaces on the GPU, plus the route
that selects it."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cask_tpu.formats.convert import csr_to_bsr, from_scipy, to_scipy
from cask_tpu.formats.generate import banded, fem_blocks, stencil_2d
from cask_tpu.ops import banded_kernel
from cask_tpu.ops.bdia import bdia_plan
from cask_tpu.utils import platform


def _asym(offs, n=700, seed=7):
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    s = sp.diags([rng.standard_normal(n - abs(o)) for o in offs], offs,
                 shape=(n, n)).tocsr()
    return from_scipy(s, format="csr")


# block-row counts span one partial program (49, 81) up to several full
# ones and a ragged last one (144, 900), at the 128-row tile
MATS = {
    "fem_dof2": (lambda: fem_blocks(9, dof=2), (2, 2)),
    "fem_dof3_ragged_tile": (lambda: fem_blocks(7, dof=3), (3, 3)),
    "fem_dof4": (lambda: fem_blocks(9, dof=4), (4, 4)),
    "fem_dof4_two_programs": (lambda: fem_blocks(12, dof=4), (4, 4)),
    "stencil_as_4x4_ragged": (lambda: stencil_2d(11), (4, 4)),
    "fem_rect_blocks_remainder": (lambda: fem_blocks(6, dof=4), (4, 2)),
    "dia_stencil_1x1": (lambda: stencil_2d(30), (1, 1)),
    "dia_banded_1x1": (lambda: banded(500, 3, seed=1), (1, 1)),
    "dia_upper_only_1x1": (lambda: _asym([1, 3, 7]), (1, 1)),
    "dia_lower_only_1x1": (lambda: _asym([-5, -2, 0]), (1, 1)),
}


def _kernel_y(p, x):
    y = banded_kernel.banded_spmv(p.vals, jnp.asarray(x), pairs=p.pairs,
                                  blocksize=p.blocksize, shape=p.shape,
                                  interpret=True)
    if p.rem_data.shape[0]:
        y = y + jax.ops.segment_sum(p.rem_data * jnp.asarray(x)[p.rem_col],
                                    p.rem_row, num_segments=p.shape[0])
    return np.asarray(y)


@pytest.mark.parametrize("name", list(MATS))
@pytest.mark.parametrize("seed", [0, 1])
def test_matches_scipy_f64(name, seed):
    gen, bs = MATS[name]
    a = gen()
    p = bdia_plan(csr_to_bsr(a, bs), bs)
    x = np.random.default_rng(seed).standard_normal(a.shape[1])
    np.testing.assert_allclose(_kernel_y(p, x), to_scipy(a) @ x,
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dof", [2, 4])
def test_f32_accumulates_f32(dof):
    a = fem_blocks(8, dof=dof, dtype=np.float32)
    p = bdia_plan(csr_to_bsr(a, (dof, dof)), (dof, dof))
    x = np.random.default_rng(1).standard_normal(a.shape[1]).astype(np.float32)
    y = _kernel_y(p, x)
    assert y.dtype == np.float32
    ref = to_scipy(a) @ x.astype(np.float64)
    assert np.linalg.norm(y - ref) / np.linalg.norm(ref) < 1e-6


def test_bf16_values_accumulate_f32():
    a = fem_blocks(6, dof=4, dtype=np.float32)
    p = bdia_plan(csr_to_bsr(a, (4, 4)), (4, 4)).astype(jnp.bfloat16)
    x = np.random.default_rng(2).standard_normal(a.shape[1]).astype(np.float32)
    y = _kernel_y(p, x)
    assert y.dtype == np.float32
    np.testing.assert_allclose(y, to_scipy(a) @ x, rtol=0.05, atol=0.1)


def test_equals_xla_formulation():
    # the kernel and the formulation it replaces agree to rounding
    a = fem_blocks(10, dof=4)
    p = bdia_plan(csr_to_bsr(a, (4, 4)), (4, 4))
    x = np.random.default_rng(3).standard_normal(a.shape[1])
    np.testing.assert_allclose(_kernel_y(p, x), np.asarray(p._xla(x)),
                               rtol=1e-13, atol=1e-13)


class TestRoute:
    def _interpreted(self, monkeypatch):
        monkeypatch.setattr(banded_kernel, "banded_spmv",
                            functools.partial(banded_kernel.banded_spmv,
                                              interpret=True))

    def test_cpu_takes_the_xla_formulation(self):
        assert not platform.kernel("bdia") and not platform.kernel("dia")
        p = bdia_plan(fem_blocks(6, dof=4), (4, 4))
        prims = str(jax.make_jaxpr(p.spmv)(jnp.ones(p.shape[1])))
        assert "pallas_call" not in prims

    def test_gpu_takes_the_kernel_for_bdia_spmv_only(self, as_gpu):
        assert platform.kernel("bdia") and not platform.kernel("dia")
        p = bdia_plan(fem_blocks(6, dof=4), (4, 4))
        assert "banded_spmv" in str(jax.make_jaxpr(p.spmv)(jnp.ones(p.shape[1])))
        X = jnp.ones((p.shape[1], 8))
        assert "pallas_call" not in str(jax.make_jaxpr(p.spmm)(X))

    @pytest.mark.parametrize("with_remainder", [False, True])
    def test_dispatch_runs_kernel_and_remainder(self, monkeypatch, with_remainder):
        monkeypatch.setitem(platform.KERNELS, platform.platform(),
                            frozenset({"bdia"}))
        self._interpreted(monkeypatch)
        a = fem_blocks(6, dof=4)
        bs = (4, 2) if with_remainder else (4, 4)
        p = bdia_plan(csr_to_bsr(a, bs), bs)
        assert bool(p.rem_data.shape[0]) == with_remainder
        x = np.random.default_rng(4).standard_normal(a.shape[1])
        assert "pallas_call" in str(jax.make_jaxpr(p.spmv)(jnp.asarray(x)))
        np.testing.assert_allclose(np.asarray(p.spmv(x)), to_scipy(a) @ x,
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_compiled_kernel_on_gpu(dtype):
    # the kernel as the card compiles it, against scipy
    from cask_tpu.formats.device_gen import fem_bdia_device
    from cask_tpu.parallel import fem_formula_bsr

    p = fem_bdia_device(64, dof=4, dtype=dtype)
    x = np.random.default_rng(5).standard_normal(p.shape[1]).astype(dtype)
    y = banded_kernel.banded_spmv(p.vals, jnp.asarray(x), pairs=p.pairs,
                                  blocksize=p.blocksize, shape=p.shape)
    ref = to_scipy(fem_formula_bsr(64, dof=4)) @ x.astype(np.float64)
    tol = 1e-12 if dtype == np.float64 else 1e-6
    assert np.linalg.norm(np.asarray(y, np.float64) - ref) / np.linalg.norm(ref) < tol
