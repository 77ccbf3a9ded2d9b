"""Distributed BDIA: the block-diagonal path on the ring halo
(BASELINE config 5 × the "tuned BSR SpMV" north star), on 8 virtual CPU
devices.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from cask_tpu.formats.convert import from_scipy, to_scipy
from cask_tpu.formats.generate import fem_blocks
from cask_tpu.parallel import DistSpmv, partition_bdia, row_mesh


def _fem(nx, dof=4, dtype=np.float64, seed=0):
    return fem_blocks(nx, dof=dof, dtype=dtype, seed=seed, return_bsr=True)


@pytest.mark.parametrize("p", [2, 4, 8])
class TestBdiaPartition:
    def test_spmv_matches_scipy(self, p):
        a = _fem(24)  # 2304 block rows, 9216 scalar rows
        plan = partition_bdia(a, p)
        assert plan.blocksize == (4, 4)
        op = DistSpmv(plan, row_mesh(p))
        x = np.random.default_rng(0).standard_normal(a.shape[1])
        y = np.asarray(op(x))
        np.testing.assert_allclose(y, to_scipy(a) @ x, rtol=1e-12, atol=1e-12)

    def test_spmm_matches_scipy(self, p):
        a = _fem(20, seed=1)
        plan = partition_bdia(a, p)
        op = DistSpmv(plan, row_mesh(p))
        X = np.random.default_rng(1).standard_normal((a.shape[1], 8))
        Y = np.asarray(op(X))
        np.testing.assert_allclose(Y, to_scipy(a) @ X, rtol=1e-12, atol=1e-12)

    def test_dof2_blocks(self, p):
        a = _fem(20, dof=2, seed=2)
        plan = partition_bdia(a, p)
        op = DistSpmv(plan, row_mesh(p))
        x = np.random.default_rng(2).standard_normal(a.shape[1])
        np.testing.assert_allclose(np.asarray(op(x)), to_scipy(a) @ x,
                                   rtol=1e-12, atol=1e-12)


class TestBdiaRemainderAndHalo:
    def test_sparse_block_diag_spills_to_remainder(self):
        # add far off-band blocks on a diagonal too sparse to keep
        import scipy.sparse as sp

        a = _fem(16, seed=3)
        s = to_scipy(a).tolil()
        rng = np.random.default_rng(3)
        n = s.shape[0]
        for _ in range(12):
            bi = int(rng.integers(0, n // 4 - 1))
            bj = int(rng.integers(0, n // 4 - 1))
            s[bi * 4 : bi * 4 + 4, bj * 4 : bj * 4 + 4] = rng.standard_normal((4, 4))
        from cask_tpu.formats.convert import csr_to_bsr

        bsr = csr_to_bsr(from_scipy(s.tocsr()), (4, 4))
        plan = partition_bdia(bsr, 4)
        assert plan.remainder is not None
        op = DistSpmv(plan, row_mesh(4))
        x = rng.standard_normal(n)
        np.testing.assert_allclose(np.asarray(op(x)), s.tocsr() @ x,
                                   rtol=1e-12, atol=1e-12)

    def test_wide_halo_spills_to_remainder(self):
        # block offsets wider than one shard must not ride the ring
        import scipy.sparse as sp

        a = _fem(12, seed=4)  # 144 block rows; nbloc=18 at p=8
        s = to_scipy(a).tocsr()
        n = s.shape[0]
        wide = sp.diags(np.ones(n - 30 * 4), -30 * 4, shape=(n, n))  # offset -30 blocks
        from cask_tpu.formats.convert import csr_to_bsr

        bsr = csr_to_bsr(from_scipy((s + wide).tocsr()), (4, 4))
        plan = partition_bdia(bsr, 8)
        assert all(abs(d) <= plan.nbloc for d in plan.block_offsets)
        assert plan.remainder is not None
        op = DistSpmv(plan, row_mesh(8))
        x = np.random.default_rng(4).standard_normal(n)
        np.testing.assert_allclose(np.asarray(op(x)), (s + wide) @ x,
                                   rtol=1e-12, atol=1e-12)

    def test_uneven_last_shard(self):
        a = _fem(15, seed=5)  # 225 block rows, not divisible by 4
        plan = partition_bdia(a, 4)
        assert plan.nbloc * 4 > 225
        op = DistSpmv(plan, row_mesh(4))
        x = np.random.default_rng(5).standard_normal(a.shape[1])
        np.testing.assert_allclose(np.asarray(op(x)), to_scipy(a) @ x,
                                   rtol=1e-12, atol=1e-12)


class TestBdiaPallasInterior:
    """The shard interior is the BDIA formulation on zero-padded local x;
    the halo and the remainder complete it."""

    def test_pallas_interior_matches_xla(self):
        # distributed result equals the single-device plan
        from cask_tpu.ops.bdia import bdia_plan

        a = _fem(24, seed=6)
        p = 4
        plan = partition_bdia(a, p)
        x = np.random.default_rng(6).standard_normal(a.shape[1])
        y = DistSpmv(plan, row_mesh(p))(x)
        np.testing.assert_allclose(np.asarray(y),
                                   np.asarray(bdia_plan(a).spmv(x)),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(np.asarray(y), to_scipy(a) @ x,
                                   rtol=1e-10, atol=1e-10)

    def test_fused_interior_matches_xla(self):
        # natural layout: the shard view holds its block rows' planes
        from cask_tpu.parallel.dist import _bdia_shard_matrix

        a = _fem(24, seed=16)
        p = 4
        plan = partition_bdia(a, p)
        assert plan.vals.shape == (p, 4, plan.npairs, plan.nbloc)
        local = _bdia_shard_matrix(
            type(plan)(**{**plan.__dict__, "vals": plan.vals[1:2]}))
        assert local.shape == (plan.mloc, plan.mloc)
        assert local.vals.shape == (4, plan.npairs, plan.nbloc)

    def test_fused_interior_remainder_and_uneven(self):
        # spilled blocks + a last shard shorter than nbloc both ride the
        # interior unchanged (remainder is collective-side; pads are
        # structural zeros)
        from cask_tpu.formats.convert import csr_to_bsr

        a = _fem(15, seed=17)  # 225 block rows: uneven at p=4
        s = to_scipy(a).tolil()
        rng = np.random.default_rng(17)
        n = s.shape[0]
        for _ in range(8):
            bi = int(rng.integers(0, n // 4 - 1))
            bj = int(rng.integers(0, n // 4 - 1))
            s[bi * 4 : bi * 4 + 4, bj * 4 : bj * 4 + 4] = rng.standard_normal((4, 4))
        bsr = csr_to_bsr(from_scipy(s.tocsr()), (4, 4))
        plan = partition_bdia(bsr, 4)
        assert plan.remainder is not None
        op = DistSpmv(plan, row_mesh(4))
        x = rng.standard_normal(n)
        np.testing.assert_allclose(np.asarray(op(x)), s.tocsr() @ x,
                                   rtol=1e-12, atol=1e-12)

    def test_fused_interior_align_contract(self):
        # shard size is ceil(nbr / P): parity holds through the pad rows
        a = _fem(20, seed=18)  # 400 block rows
        plan = partition_bdia(a, 3)
        assert plan.nbloc == 134
        op = DistSpmv(plan, row_mesh(3))
        x = np.random.default_rng(18).standard_normal(a.shape[1])
        np.testing.assert_allclose(np.asarray(op(x)), to_scipy(a) @ x,
                                   rtol=1e-12, atol=1e-12)

    def test_no_interior_option(self):
        # no option selects an interior any more
        a = _fem(16, seed=19)
        plan = partition_bdia(a, 4)
        for kw in ({"interior": "fused"}, {"mm_interior": "slab"}):
            with pytest.raises(TypeError):
                DistSpmv(plan, row_mesh(4), **kw)

    def test_overlap_ab_matches(self):
        a = _fem(20, seed=7)
        p = 4
        plan = partition_bdia(a, p)
        x = np.random.default_rng(7).standard_normal(a.shape[1])
        y1 = DistSpmv(plan, row_mesh(p), overlap=True)(x)
        y2 = DistSpmv(plan, row_mesh(p), overlap=False)(x)
        np.testing.assert_allclose(np.asarray(y1), np.asarray(y2), rtol=1e-13)


class TestBdiaDistributedSolve:
    def test_distributed_cg_over_bdia_shards(self):
        from cask_tpu.solvers import cg

        a = _fem(24, seed=8)  # SPD-ish (diagonally dominated blocks)
        s = to_scipy(a)
        import scipy.sparse as sp

        spd = (s + s.T).tocsr()
        spd = (spd + sp.identity(spd.shape[0]) * 1.0).tocsr()
        from cask_tpu.formats.convert import csr_to_bsr

        bsr = csr_to_bsr(from_scipy(spd), (4, 4))
        p = 8
        plan = partition_bdia(bsr, p)
        op = DistSpmv(plan, row_mesh(p))
        b = np.random.default_rng(8).standard_normal(spd.shape[0])
        bp = op.padded(jnp.asarray(b))
        res = cg(op.padded_op, bp, tol=1e-10, maxiter=800)
        assert bool(res.converged)
        x = np.asarray(res.x)[: spd.shape[0]]
        np.testing.assert_allclose(spd @ x, b, rtol=1e-6, atol=1e-7)


class TestFormulaicFemPartition:
    """The no-CSR builder is bit-identical to the CSR-driven one."""

    def test_parity_with_partition_bdia_small(self):
        from cask_tpu.parallel import fem_bdia_partition, fem_formula_bsr
        from cask_tpu.parallel.partition import partition_bdia

        bsr = fem_formula_bsr(20, dof=4, dtype=np.float32)
        p1 = partition_bdia(bsr, 4)
        p2 = fem_bdia_partition(20, dof=4, nshards=4, dtype=np.float32)
        assert p1.block_offsets == p2.block_offsets
        assert (p1.nbloc, p1.mloc) == (p2.nbloc, p2.mloc)
        np.testing.assert_array_equal(np.asarray(p1.vals), np.asarray(p2.vals))
        np.testing.assert_array_equal(np.asarray(p1.head_vals),
                                      np.asarray(p2.head_vals))
        np.testing.assert_array_equal(np.asarray(p1.tail_vals),
                                      np.asarray(p2.tail_vals))
        assert p1.remainder is None or p1.remainder.int_data.size <= 1

    def test_formulaic_spmv_matches_scipy(self):
        from cask_tpu.parallel import fem_bdia_partition, fem_formula_bsr

        bsr = fem_formula_bsr(16, dof=2, dtype=np.float64)
        plan = fem_bdia_partition(16, dof=2, nshards=8, dtype=np.float64)
        op = DistSpmv(plan, row_mesh(8))
        x = np.random.default_rng(10).standard_normal(bsr.shape[1])
        np.testing.assert_allclose(np.asarray(op(x)), to_scipy(bsr) @ x,
                                   rtol=1e-12, atol=1e-12)


class TestSlim10MBdia:
    """Config-5 × north-star intersection: ≥10M-row dof-4 FEM BDIA
    distributed SpMV + CG iterations, every CI round (formulaic plan)."""

    NX = 1600  # 2.56M block rows × dof 4 = 10.24M scalar rows

    def test_10m_row_bdia_distributed_spmv(self):
        from cask_tpu.parallel import fem_bdia_partition

        plan = fem_bdia_partition(self.NX, dof=4, nshards=8)
        assert plan.shape[0] >= 10_000_000
        op = DistSpmv(plan, row_mesh(8))
        rng = np.random.default_rng(11)
        x = rng.standard_normal(plan.shape[1]).astype(np.float32)
        y = np.asarray(op(x))
        # independent spot reference: re-derive 3 shard-boundary block
        # rows from the formula (full scipy at 10M is the SLOW variant)
        from cask_tpu.parallel.partition import (_fem_formula_val,
                                                 _fem_offset_mask)

        ny, dof = self.NX, 4
        nbr = self.NX * ny
        check_rows = [0, plan.nbloc - 1, plan.nbloc, 5 * plan.nbloc + 7,
                      nbr - 1]
        offsets = plan.block_offsets
        for ib in check_rows:
            gi = np.asarray([ib], dtype=np.int64)
            for r in range(dof):
                want = 0.0
                for dpos, off in enumerate(offsets):
                    if not bool(_fem_offset_mask(gi, off, ny, nbr)[0]):
                        continue
                    for c in range(dof):
                        v = float(_fem_formula_val(gi, dpos, r, c, dof)[0])
                        if off == 0 and r == c:
                            v += 4.0 * dof
                        want += np.float32(v) * x[(ib + off) * dof + c]
                got = y[ib * dof + r]
                assert abs(got - want) / max(abs(want), 1e-3) < 1e-4, \
                    (ib, r, got, want)

    def test_10m_row_bdia_distributed_cg_iterations(self):
        from cask_tpu.parallel import fem_bdia_partition
        from cask_tpu.solvers import cg

        plan = fem_bdia_partition(self.NX, dof=4, nshards=8)
        op = DistSpmv(plan, row_mesh(8))
        rng = np.random.default_rng(12)
        b = op(jnp.asarray(rng.standard_normal(plan.shape[0]).astype(np.float32)))
        res = cg(op, b, tol=0.0, maxiter=3)
        assert int(res.iterations) == 3
        assert np.isfinite(float(res.residual_norm))


class TestBdia1MParity:
    """VERDICT r2 item 1 'Done' bar: ≥1M-row dof-4 FEM parity vs the
    single-device XLA formulation."""

    def test_1m_row_fem_dof4(self):
        from cask_tpu.ops.bdia import bdia_plan

        a = _fem(512, dtype=np.float32)  # 1.05M scalar rows
        assert a.shape[0] >= 1_000_000
        plan = partition_bdia(a, 8)
        op = DistSpmv(plan, row_mesh(8))
        x = np.random.default_rng(9).standard_normal(a.shape[1]).astype(np.float32)
        y = np.asarray(op(x))
        ref = np.asarray(bdia_plan(a).spmv(jnp.asarray(x)))
        err = np.abs(y - ref).max() / np.abs(ref).max()
        assert err < 1e-5


class TestFormulaicAlignB:
    def test_fem_partition_align_b_parity(self):
        # uneven shards (400 block rows over 3) through the formulaic
        # builder
        from cask_tpu.parallel import fem_bdia_partition, fem_formula_bsr

        bsr = fem_formula_bsr(20, dof=2, dtype=np.float64)
        plan = fem_bdia_partition(20, dof=2, nshards=3, dtype=np.float64)
        assert plan.nbloc == 134
        op = DistSpmv(plan, row_mesh(3))
        x = np.random.default_rng(21).standard_normal(bsr.shape[1])
        np.testing.assert_allclose(np.asarray(op(x)), to_scipy(bsr) @ x,
                                   rtol=1e-12, atol=1e-12)


class TestShardMetaAndAlignGuards:
    def test_shard_meta_remainder_dtypes_match_plan(self):
        # the shard view carries the same int32 index dtypes as a real
        # plan's empty remainder
        from cask_tpu.ops.bdia import bdia_plan
        from cask_tpu.parallel.dist import _bdia_shard_matrix

        a = _fem(16, seed=9)
        plan = partition_bdia(a, 4)
        local = _bdia_shard_matrix(
            type(plan)(**{**plan.__dict__, "vals": plan.vals[:1]}))
        ref = bdia_plan(_fem(8, seed=9), (4, 4))
        assert ref.rem_data.shape[0] == 0
        assert np.dtype(local.rem_row.dtype) == np.dtype(ref.rem_row.dtype) == np.int32
        assert np.dtype(local.rem_col.dtype) == np.dtype(ref.rem_col.dtype) == np.int32

    def test_align_b_empty_shard_rejected(self):
        # a halo wider than a shard is refused by the formulaic builder
        from cask_tpu.parallel import fem_bdia_partition

        with pytest.raises(ValueError, match="multi-hop"):
            fem_bdia_partition(16, dof=2, nshards=32)  # 8-block shards, ny=16
        plan = partition_bdia(_fem(16, seed=10), 4)
        assert plan.nbloc == 64


class TestSlabMmInterior:
    """Distributed wide-k SpMM through the BDIA interior: must match
    scipy and the single-device plan, remainder and uneven shards
    included."""

    @pytest.mark.parametrize("p", [2, 4])
    def test_matches_scipy_and_xla_interior(self, p):
        from cask_tpu.ops.bdia import bdia_plan

        a = _fem(24, dtype=np.float32)
        plan = partition_bdia(a, p)
        op = DistSpmv(plan, row_mesh(p))
        X = np.random.default_rng(51).standard_normal(
            (a.shape[1], 96)).astype(np.float32)
        Y = np.asarray(op(X))
        ref = to_scipy(a) @ X
        np.testing.assert_allclose(Y, ref, rtol=2e-5, atol=2e-4)
        np.testing.assert_allclose(Y, np.asarray(bdia_plan(a).spmm(X)),
                                   rtol=2e-5, atol=2e-4)

    def test_remainder_spills_still_exact(self):
        # far off-band blocks in the COO remainder ride alongside
        from cask_tpu.formats.convert import csr_to_bsr

        a = _fem(16, dtype=np.float64, seed=7)
        s = to_scipy(a).tolil()
        rng = np.random.default_rng(7)
        n = s.shape[0]
        for _ in range(8):
            bi = int(rng.integers(0, n // 4 - 1))
            bj = int(rng.integers(0, n // 4 - 1))
            s[bi * 4 : bi * 4 + 4, bj * 4 : bj * 4 + 4] = \
                rng.standard_normal((4, 4))
        b = csr_to_bsr(from_scipy(s.tocsr()), (4, 4))
        plan = partition_bdia(b, 4)
        op = DistSpmv(plan, row_mesh(4))
        X = rng.standard_normal((b.shape[1], 80))
        np.testing.assert_allclose(np.asarray(op(X)), s.tocsr() @ X,
                                   rtol=1e-10, atol=1e-10)

    def test_slab_rejected_for_dia_plan(self):
        # the DIA partition serves wide k through its own SpMM body
        from cask_tpu.formats.generate import stencil_2d
        from cask_tpu.parallel import partition_dia

        a = stencil_2d(24)
        op = DistSpmv(partition_dia(a, 4), row_mesh(4))
        X = np.random.default_rng(52).standard_normal((a.shape[1], 96))
        np.testing.assert_allclose(np.asarray(op(X)), to_scipy(a) @ X,
                                   rtol=1e-12, atol=1e-12)


class TestPaddedOpWith:
    def test_operands_as_arguments_match(self):
        # jitted loops thread op.operands through padded_op_with: same
        # results as the closure path, plan traced not constant
        import jax

        a = _fem(16, seed=21, dtype=np.float32)
        plan = partition_bdia(a, 4)
        op = DistSpmv(plan, row_mesh(4))
        assert len(op.operands) == 1
        X = np.random.default_rng(21).standard_normal(
            (a.shape[1], 96)).astype(np.float32)
        Xp = op.padded(X)

        @jax.jit
        def f(ops, xp):
            return op.padded_op_with(ops, xp)

        y1 = np.asarray(f(op.operands, Xp))
        y2 = np.asarray(op.padded_op(Xp))
        np.testing.assert_array_equal(y1, y2)
        x = np.random.default_rng(22).standard_normal(
            a.shape[1]).astype(np.float32)
        xp = op.padded(x)
        np.testing.assert_array_equal(
            np.asarray(f(op.operands, xp)), np.asarray(op.padded_op(xp)))
