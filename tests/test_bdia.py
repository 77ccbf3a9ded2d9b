"""BDIA (block-diagonal) SpMV/SpMM: the tuned BSR path (BASELINE config
2 / north star).  scipy is ground truth."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cask_tpu.formats.convert import csr_to_bsr, to_scipy
from cask_tpu.formats.generate import banded, fem_blocks, stencil_2d
from cask_tpu.ops.bdia import BdiaMatrix, bdia_plan, estimate_bdia_traffic


def _spmv_ref(a_csr, x):
    return to_scipy(a_csr) @ x


class TestPlan:
    @pytest.mark.parametrize("dof", [2, 4, 8])
    def test_fem_blocks_full_density(self, dof):
        a = fem_blocks(9, dof=dof)
        plan = bdia_plan(a, (dof, dof))
        # stencil connectivity: 5 block diagonals, no remainder
        assert len(plan.block_offsets) == 5
        assert plan.rem_data.shape[0] == 0
        assert plan.npairs == 5 * dof

    def test_sparse_blockdiag_spills(self):
        # one dense block diagonal + a handful of scattered blocks
        a = fem_blocks(8, dof=2)
        sp = to_scipy(a).tolil()
        sp[0, 100] = 3.0
        sp[40, 2] = -1.5
        from cask_tpu.formats.convert import from_scipy

        plan = bdia_plan(from_scipy(sp.tocsr()), (2, 2))
        assert plan.rem_data.shape[0] > 0

    def test_traffic_estimate(self):
        a = fem_blocks(12, dof=4)
        est = estimate_bdia_traffic(a, 4)
        assert est is not None
        streamed, fill = est
        assert streamed >= a.nnz
        assert 0.9 <= fill <= 1.0
        # scalar power-law graph: no block-diagonal structure
        from cask_tpu.formats.generate import power_law

        assert estimate_bdia_traffic(power_law(400, seed=3), 4) is None


class TestSpmvXla:
    @pytest.mark.parametrize("dof", [2, 4])
    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_fem_matches_scipy(self, dof, dtype):
        a = fem_blocks(7, dof=dof, dtype=dtype)
        plan = bdia_plan(a, (dof, dof))
        rng = np.random.default_rng(0)
        x = rng.standard_normal(a.shape[1]).astype(dtype)
        y = plan.spmv(x)
        rtol = 1e-12 if dtype == np.float64 else 1e-5
        np.testing.assert_allclose(np.asarray(y), _spmv_ref(a, x), rtol=rtol, atol=rtol)

    def test_remainder_path(self):
        a = fem_blocks(8, dof=2)
        sp = to_scipy(a).tolil()
        sp[0, 100] = 3.0
        sp[40, 2] = -1.5
        from cask_tpu.formats.convert import from_scipy

        a2 = from_scipy(sp.tocsr())
        plan = bdia_plan(a2, (2, 2))
        rng = np.random.default_rng(1)
        x = rng.standard_normal(a2.shape[1])
        y = plan.spmv(x)
        np.testing.assert_allclose(np.asarray(y), to_scipy(a2) @ x, rtol=1e-12)

    def test_scalar_band_as_blocks(self):
        # a plain banded matrix blocked at 4: BDIA must still be exact
        a = banded(257, 3, seed=5)
        plan = bdia_plan(a, (4, 4))
        rng = np.random.default_rng(2)
        x = rng.standard_normal(a.shape[1])
        y = plan.spmv(x)
        np.testing.assert_allclose(np.asarray(y), _spmv_ref(a, x), rtol=1e-12)

    def test_ragged_edge(self):
        # n not a multiple of the block: padding rows/cols are structural
        a = stencil_2d(11)  # 121 rows, blocked at 4 -> ragged
        plan = bdia_plan(a, (4, 4))
        rng = np.random.default_rng(3)
        x = rng.standard_normal(a.shape[1])
        y = plan.spmv(x)
        np.testing.assert_allclose(np.asarray(y), _spmv_ref(a, x), rtol=1e-12)


class TestSpmvPallas:
    """The BDIA formulation jitted with the plan as an argument."""

    @pytest.mark.parametrize("dof", [2, 4, 8])
    def test_matches_xla(self, dof):
        a = fem_blocks(7, dof=dof, dtype=np.float32)
        plan = bdia_plan(a, (dof, dof))
        rng = np.random.default_rng(0)
        x = rng.standard_normal(a.shape[1]).astype(np.float32)
        y = jax.jit(lambda p, v: p.spmv(v))(plan, x)
        np.testing.assert_allclose(
            np.asarray(y), _spmv_ref(a, x), rtol=2e-5, atol=2e-5
        )

    def test_layout_roundtrip(self):
        # natural layout: vals[r, dpos*bc + c, i] is element (r, c) of
        # the block at block row i on block offset block_offsets[dpos]
        a = fem_blocks(6, dof=4, dtype=np.float32)
        plan = bdia_plan(a, (4, 4))
        assert plan.vals.shape == (4, plan.npairs, plan.nbr)
        dense = to_scipy(a).toarray()
        vals = np.asarray(plan.vals)
        for dpos, d in enumerate(plan.block_offsets):
            for i in (0, 7, plan.nbr - 1):
                if not 0 <= i + d < plan.nbc:
                    continue
                block = dense[4 * i : 4 * i + 4, 4 * (i + d) : 4 * (i + d) + 4]
                np.testing.assert_array_equal(
                    vals[:, dpos * 4 : dpos * 4 + 4, i], block)

    def test_bf16_accumulates_f32(self):
        a = fem_blocks(6, dof=4, dtype=np.float32)
        plan = bdia_plan(a, (4, 4)).astype(np.dtype("bfloat16"))
        rng = np.random.default_rng(5)
        x = rng.standard_normal(a.shape[1]).astype(np.float32)
        y = plan.spmv(jnp.asarray(x, jnp.bfloat16))
        assert y.dtype == jnp.float32
        np.testing.assert_allclose(np.asarray(y), _spmv_ref(a, x), rtol=0.05, atol=0.1)

    def test_auto_dispatch_on_cpu_uses_xla(self):
        a = fem_blocks(5, dof=2)
        plan = bdia_plan(a, (2, 2))
        rng = np.random.default_rng(6)
        x = rng.standard_normal(a.shape[1])
        np.testing.assert_allclose(
            np.asarray(plan.spmv(x)), _spmv_ref(a, x), rtol=1e-12
        )


class TestSpmvPallasFused:
    """Natural-in/natural-out SpMV on the plan, including rectangular
    blocks, ragged edges and the COO remainder."""

    @pytest.mark.parametrize("dof", [2, 4, 8])
    @pytest.mark.parametrize("flat", [True, False])
    def test_matches_xla_f32(self, dof, flat):
        # flat: eager call; else the plan rides into jit as an argument
        a = fem_blocks(7, dof=dof, dtype=np.float32)
        plan = bdia_plan(a, (dof, dof))
        rng = np.random.default_rng(10)
        x = rng.standard_normal(a.shape[1]).astype(np.float32)
        y = plan.spmv(x) if flat else jax.jit(lambda p, v: p.spmv(v))(plan, x)
        np.testing.assert_allclose(np.asarray(y), _spmv_ref(a, x),
                                   rtol=2e-5, atol=2e-5)

    def test_f64_interpret(self):
        a = fem_blocks(6, dof=4, dtype=np.float64)
        plan = bdia_plan(a, (4, 4))
        rng = np.random.default_rng(11)
        x = rng.standard_normal(a.shape[1])
        y = plan.spmv(x)
        np.testing.assert_allclose(np.asarray(y), _spmv_ref(a, x),
                                   rtol=1e-12, atol=1e-12)

    def test_bf16_values(self):
        a = fem_blocks(6, dof=4, dtype=np.float32)
        plan = bdia_plan(a, (4, 4)).astype(np.dtype("bfloat16"))
        rng = np.random.default_rng(12)
        x = rng.standard_normal(a.shape[1]).astype(np.float32)
        y = plan.spmv(jnp.asarray(x, jnp.float32))
        assert y.dtype == jnp.float32
        np.testing.assert_allclose(np.asarray(y), _spmv_ref(a, x),
                                   rtol=0.05, atol=0.1)

    def test_rectangular_blocks(self):
        # (4, 2) blocks: ragged block diagonals spill to the remainder,
        # which the plan adds back
        a = fem_blocks(6, dof=4, dtype=np.float32)
        bsr = csr_to_bsr(a, (4, 2))
        plan = bdia_plan(bsr)
        assert plan.rem_data.shape[0] > 0
        rng = np.random.default_rng(13)
        x = rng.standard_normal(a.shape[1]).astype(np.float32)
        y = plan.spmv(x)
        np.testing.assert_allclose(np.asarray(y), to_scipy(a) @ x,
                                   rtol=2e-5, atol=2e-5)

    def test_ragged_rows_pad_path(self):
        a = fem_blocks(9, dof=3, dtype=np.float32)  # 243 rows: ragged
        plan = bdia_plan(csr_to_bsr(a, (3, 3)))
        rng = np.random.default_rng(14)
        x = rng.standard_normal(a.shape[1]).astype(np.float32)
        y = plan.spmv(x)
        np.testing.assert_allclose(np.asarray(y), to_scipy(a) @ x,
                                   rtol=2e-5, atol=2e-5)

    def test_spmv_method_fused_dispatch(self):
        from cask_tpu import spmv

        a = fem_blocks(6, dof=4, dtype=np.float32)
        plan = bdia_plan(a, (4, 4))
        rng = np.random.default_rng(15)
        x = rng.standard_normal(a.shape[1]).astype(np.float32)
        y = spmv(csr_to_bsr(a, (4, 4)), x, method="bdia")
        np.testing.assert_allclose(np.asarray(y), _spmv_ref(a, x),
                                   rtol=2e-5, atol=2e-5)
        with pytest.raises(TypeError):
            plan.spmv(x, method="fused")

    def test_fused_with_remainder(self):
        from cask_tpu.formats.convert import from_scipy

        a = fem_blocks(6, dof=4, dtype=np.float64)
        s = to_scipy(a).tolil()
        rng = np.random.default_rng(16)
        for _ in range(6):
            bi = int(rng.integers(0, 20))
            bj = int(rng.integers(0, 20))
            s[bi * 4 : bi * 4 + 4, bj * 4 : bj * 4 + 4] = rng.standard_normal((4, 4))
        bsr = csr_to_bsr(from_scipy(s.tocsr()), (4, 4))
        plan = bdia_plan(bsr)
        assert plan.rem_data.shape[0] > 0
        x = rng.standard_normal(s.shape[1])
        y = plan.spmv(x)
        np.testing.assert_allclose(np.asarray(y), s.tocsr() @ x,
                                   rtol=1e-12, atol=1e-12)


class TestResidentLayout:
    """Solver chaining: the plan's output is a valid next input."""

    @pytest.mark.parametrize("dof", [2, 4, 8])
    def test_matches_scipy(self, dof):
        a = fem_blocks(7, dof=dof, dtype=np.float32)
        plan = bdia_plan(a, (dof, dof))
        rng = np.random.default_rng(0)
        x = rng.standard_normal(a.shape[1]).astype(np.float32)
        y = plan.spmv(x)
        assert y.shape == x.shape  # chainable
        np.testing.assert_allclose(np.asarray(y), _spmv_ref(a, x),
                                   rtol=2e-5, atol=2e-5)

    def test_chained_applications(self):
        a = fem_blocks(6, dof=4, dtype=np.float32)
        plan = bdia_plan(a, (4, 4))
        rng = np.random.default_rng(1)
        x = rng.standard_normal(a.shape[1]).astype(np.float32)
        y2 = plan.spmv(plan.spmv(x))
        ref = to_scipy(a) @ (to_scipy(a) @ x)
        np.testing.assert_allclose(np.asarray(y2), ref, rtol=2e-4, atol=2e-4)

    def test_operator_xla_mode_on_cpu(self):
        from cask_tpu.ops.bdia import BdiaOperator

        a = fem_blocks(6, dof=4)
        op = BdiaOperator(a, (4, 4))
        x = np.random.default_rng(2).standard_normal(a.shape[1])
        np.testing.assert_allclose(
            np.asarray(op.from_padded(op(op.to_padded(x)))),
            _spmv_ref(a, x), rtol=1e-10)

    def test_operator_pallas_mode_forced(self):
        # the operator drives BiCGStab (the blocks are not symmetric) to
        # the scipy solution
        from cask_tpu.ops.bdia import BdiaOperator
        from cask_tpu.solvers import bicgstab

        a = fem_blocks(6, dof=4)
        op = BdiaOperator(a, (4, 4))
        b = np.random.default_rng(3).standard_normal(a.shape[1])
        res = bicgstab(op, op.to_padded(b), tol=1e-10, maxiter=500)
        x = np.asarray(op.from_padded(res.x))
        np.testing.assert_allclose(to_scipy(a) @ x, b, rtol=1e-7, atol=1e-7)


class TestBdiaSpmmRing:
    """Block SpMM on the plan: natural X/Y, exactly-nnz value stream."""

    @pytest.mark.parametrize("dof", [2, 4])
    def test_matches_scipy_k128(self, dof):
        a = fem_blocks(12, dof=dof, dtype=np.float32)
        plan = bdia_plan(a, (dof, dof))
        rng = np.random.default_rng(20)
        X = rng.standard_normal((a.shape[1], 128)).astype(np.float32)
        Y = plan.spmm(X)
        np.testing.assert_allclose(np.asarray(Y), to_scipy(a) @ X,
                                   rtol=2e-5, atol=2e-5)

    def test_ragged_k_and_rows(self):
        a = fem_blocks(11, dof=3, dtype=np.float64)  # ragged everything
        plan = bdia_plan(csr_to_bsr(a, (3, 3)))
        rng = np.random.default_rng(21)
        X = rng.standard_normal((a.shape[1], 100))
        Y = plan.spmm(X)
        np.testing.assert_allclose(np.asarray(Y), to_scipy(a) @ X,
                                   rtol=1e-12, atol=1e-12)

    def test_bf16_streams_f32_accumulate(self):
        a = fem_blocks(10, dof=4, dtype=np.float32)
        plan = bdia_plan(a, (4, 4)).astype(np.dtype("bfloat16"))
        rng = np.random.default_rng(22)
        X = rng.standard_normal((a.shape[1], 128)).astype(np.float32)
        Y = plan.spmm(jnp.asarray(X, jnp.bfloat16))
        assert Y.dtype == jnp.float32
        np.testing.assert_allclose(np.asarray(Y), to_scipy(a) @ X,
                                   rtol=0.05, atol=0.2)

    def test_spmm_dispatch_with_remainder(self):
        from cask_tpu.formats.convert import from_scipy
        from cask_tpu.ops.spmm import spmm

        a = fem_blocks(10, dof=4, dtype=np.float64)
        s = to_scipy(a).tolil()
        rng = np.random.default_rng(23)
        for _ in range(5):
            bi, bj = int(rng.integers(0, 30)), int(rng.integers(60, 99))
            s[bi * 4 : bi * 4 + 4, bj * 4 : bj * 4 + 4] = rng.standard_normal((4, 4))
        plan = bdia_plan(csr_to_bsr(from_scipy(s.tocsr()), (4, 4)))
        assert plan.rem_data.shape[0] > 0
        X = rng.standard_normal((s.shape[1], 128))
        Y = spmm(plan, X)
        np.testing.assert_allclose(np.asarray(Y), s.tocsr() @ X,
                                   rtol=1e-12, atol=1e-12)

    def test_chained_natural_layout(self):
        # block-Krylov style: Y feeds straight back as X (same layout)
        a = fem_blocks(12, dof=4, dtype=np.float64)
        plan = bdia_plan(a, (4, 4))
        rng = np.random.default_rng(24)
        X = rng.standard_normal((a.shape[1], 128))
        Y2 = plan.spmm(plan.spmm(X))
        s = to_scipy(a)
        np.testing.assert_allclose(np.asarray(Y2), s @ (s @ X),
                                   rtol=1e-12, atol=1e-11)

    def test_interleaved_slab_schedule_exact(self):
        # k=1 SpMM equals SpMV on the same plan
        a = fem_blocks(9, dof=4, dtype=np.float64)
        plan = bdia_plan(a, (4, 4))
        x = np.random.default_rng(17).standard_normal(a.shape[1])
        np.testing.assert_array_equal(np.asarray(plan.spmm(x[:, None]))[:, 0],
                                      np.asarray(plan.spmv(x)))
        np.testing.assert_allclose(np.asarray(plan.spmv(x)), _spmv_ref(a, x),
                                   rtol=1e-12, atol=1e-12)
