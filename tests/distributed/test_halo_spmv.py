"""Distributed SpMV/SpMM on 8 virtual CPU devices (SURVEY.md §4.3).

This is the multi-device "simulation mode": the same shard_map/ppermute
program that runs across the cards of one GPU host."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cask_tpu.formats.convert import to_scipy
from cask_tpu.formats.generate import banded, power_law, stencil_2d
from cask_tpu.parallel import DistSpmv, partition_coo, partition_dia, row_mesh


def _mesh(p):
    return row_mesh(p)


MATS = {
    "banded": lambda: banded(1000, 4, seed=1),
    "stencil": lambda: stencil_2d(33),  # 1089 rows, offsets ±33
    "powerlaw": lambda: power_law(800, avg_degree=5, seed=2),
}


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("name", list(MATS))
class TestCooPartition:
    def test_spmv(self, p, name):
        a = MATS[name]()
        plan = partition_coo(a, p)
        op = DistSpmv(plan, _mesh(p))
        rng = np.random.default_rng(0)
        x = rng.standard_normal(a.shape[1])
        y = op(x)
        np.testing.assert_allclose(np.asarray(y), to_scipy(a) @ x, rtol=1e-12, atol=1e-12)

    def test_spmm(self, p, name):
        a = MATS[name]()
        plan = partition_coo(a, p)
        op = DistSpmv(plan, _mesh(p))
        rng = np.random.default_rng(1)
        x = rng.standard_normal((a.shape[1], 16))
        y = op(x)
        np.testing.assert_allclose(np.asarray(y), to_scipy(a) @ x, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("p", [2, 4, 8])
class TestDiaPartition:
    @pytest.mark.parametrize("name", ["banded", "stencil"])
    def test_spmv_banded(self, p, name):
        a = MATS[name]()
        plan = partition_dia(a, p)
        assert plan.remainder is None or plan.remainder.ext_data.shape[1] >= 1
        op = DistSpmv(plan, _mesh(p))
        rng = np.random.default_rng(2)
        x = rng.standard_normal(a.shape[1])
        y = op(x)
        np.testing.assert_allclose(np.asarray(y), to_scipy(a) @ x, rtol=1e-12, atol=1e-12)

    def test_spmv_with_remainder(self, p):
        a = power_law(600, avg_degree=5, seed=3)
        plan = partition_dia(a, p, min_density=0.4)
        assert plan.remainder is not None
        op = DistSpmv(plan, _mesh(p))
        rng = np.random.default_rng(3)
        x = rng.standard_normal(a.shape[1])
        y = op(x)
        np.testing.assert_allclose(np.asarray(y), to_scipy(a) @ x, rtol=1e-12, atol=1e-12)

    def test_spmm(self, p):
        a = banded(1000, 4, seed=4)
        plan = partition_dia(a, p)
        op = DistSpmv(plan, _mesh(p))
        rng = np.random.default_rng(4)
        x = rng.standard_normal((a.shape[1], 8))
        y = op(x)
        np.testing.assert_allclose(np.asarray(y), to_scipy(a) @ x, rtol=1e-12, atol=1e-12)

    def test_wide_halo_spills_to_remainder(self, p):
        # offsets wider than a shard must not use the single-hop ring
        a = banded(256, 2, seed=5)
        import scipy.sparse as sp

        s = to_scipy(a) + sp.diags(np.ones(256 - 200), -200, shape=(256, 256))
        from cask_tpu.formats.convert import from_scipy

        plan = partition_dia(from_scipy(s.tocsr()), p)
        assert all(abs(o) <= plan.mloc for o in plan.offsets)
        op = DistSpmv(plan, _mesh(p))
        x = np.random.default_rng(5).standard_normal(256)
        np.testing.assert_allclose(np.asarray(op(x)), s @ x, rtol=1e-12, atol=1e-12)


class TestDeviceResidentSolve:
    def test_distributed_cg(self):
        """CG iterating on sharded vectors with the halo-exchange SpMV."""
        from cask_tpu.solvers import cg

        a = stencil_2d(32)  # SPD, 1024 rows
        p = 8
        plan = partition_dia(a, p)
        op = DistSpmv(plan, _mesh(p))
        rng = np.random.default_rng(6)
        b = rng.standard_normal(a.shape[0])
        bp = op.padded(b)
        res = cg(op.padded_op, bp, tol=1e-10, maxiter=600)
        x = np.asarray(res.x)[: a.shape[0]]
        np.testing.assert_allclose(to_scipy(a) @ x, b, rtol=1e-6, atol=1e-7)


class TestPallasInterior:
    """The DIA interior at a size with many rows per shard."""

    def test_pallas_interior_matches_xla(self):
        a = stencil_2d(100)  # 10000 rows
        p = 2
        plan = partition_dia(a, p)
        assert plan.mloc == 5000
        rng = np.random.default_rng(9)
        x = rng.standard_normal(a.shape[1])
        y = DistSpmv(plan, _mesh(p))(x)
        np.testing.assert_allclose(np.asarray(y), to_scipy(a) @ x, rtol=1e-10, atol=1e-10)

    def test_pallas_interior_requires_alignment(self):
        # the interior is one formulation: no option selects another
        a = stencil_2d(40)
        plan = partition_dia(a, 2)
        assert plan.mloc == 800
        with pytest.raises(TypeError):
            DistSpmv(plan, _mesh(2), interior="pallas")


class TestOverlapAB:
    def test_serialized_variant_correct(self):
        a = stencil_2d(40)
        p = 4
        plan = partition_dia(a, p)
        rng = np.random.default_rng(20)
        x = rng.standard_normal(a.shape[1])
        y1 = DistSpmv(plan, _mesh(p), overlap=True)(x)
        y2 = DistSpmv(plan, _mesh(p), overlap=False)(x)
        np.testing.assert_allclose(np.asarray(y1), np.asarray(y2), rtol=1e-13)

    def test_bench_overlap_runs(self):
        import io

        from cask_tpu.bench.harness import bench_overlap

        buf = io.StringIO()
        recs = bench_overlap(side=32, nshards=4, out=buf)
        assert len(recs) >= 2


class TestShardIlu:
    """Additive-Schwarz per-shard ILU(0) on the fake 8-device mesh."""

    def test_reduces_cg_iterations(self):
        import jax.numpy as jnp

        from cask_tpu.formats.generate import stencil_2d
        from cask_tpu.parallel.dist import DistSpmv
        from cask_tpu.parallel.partition import partition_dia
        from cask_tpu.solvers import cg
        from cask_tpu.solvers.precond import shard_ilu0

        a = stencil_2d(48)
        op = DistSpmv(partition_dia(a, 8))
        b = np.random.default_rng(0).standard_normal(a.shape[0])
        bp = op.padded(jnp.asarray(b))
        M = shard_ilu0(a, op)
        plain = cg(op.padded_op, bp, tol=1e-9, maxiter=800)
        pre = cg(op.padded_op, bp, tol=1e-9, maxiter=800, M=M)
        assert bool(pre.converged)
        assert int(pre.iterations) < int(plain.iterations)
        from cask_tpu.formats.convert import to_scipy

        x = np.asarray(pre.x)[: a.shape[0]]
        assert np.linalg.norm(to_scipy(a) @ x - b) < 1e-6

    def test_apply_matches_blockwise_host_ilu(self):
        import jax.numpy as jnp

        from cask_tpu.formats.convert import from_scipy
        from cask_tpu.formats.generate import banded
        from cask_tpu.ops.ilu import ilu0
        from cask_tpu.parallel.dist import DistSpmv
        from cask_tpu.parallel.partition import partition_coo
        from cask_tpu.solvers.precond import shard_ilu0

        a = banded(512, 3, seed=3, spd=True)
        op = DistSpmv(partition_coo(a, 4))
        mloc = op.plan.mloc
        M = shard_ilu0(a, op)
        r = np.random.default_rng(1).standard_normal(op.padded_n)
        got = np.asarray(M(op.padded(jnp.asarray(r[: a.shape[0]]))))
        # reference: factor each diagonal block on the host independently
        import scipy.sparse as sp

        from cask_tpu.formats.convert import to_scipy

        spa = to_scipy(a).tocsr()
        for s in range(op.plan.nshards):
            r0, r1 = s * mloc, min((s + 1) * mloc, a.shape[0])
            if r0 >= r1:
                continue
            blk = spa[r0:r1, r0:r1].tocsr()
            blk.sort_indices()
            f = ilu0(from_scipy(blk, format="csr"))
            want = np.asarray(f.apply(jnp.asarray(r[r0:r1])))
            np.testing.assert_allclose(got[r0:r1], want, rtol=1e-10, atol=1e-10)

    def test_matrix_rhs(self):
        import jax.numpy as jnp

        from cask_tpu.formats.generate import stencil_2d
        from cask_tpu.parallel.dist import DistSpmv
        from cask_tpu.parallel.partition import partition_dia
        from cask_tpu.solvers.precond import shard_ilu0

        a = stencil_2d(32)
        op = DistSpmv(partition_dia(a, 8))
        M = shard_ilu0(a, op)
        R = np.random.default_rng(2).standard_normal((a.shape[0], 4))
        out = np.asarray(M(op.padded(jnp.asarray(R))))
        one = np.asarray(M(op.padded(jnp.asarray(R[:, 0]))))
        np.testing.assert_allclose(out[: len(one), 0], one, rtol=1e-12, atol=1e-12)


class TestPohPartition:
    """Distributed unstructured SpMV/SpMM: the COO interior/exterior
    partition with its all_gather."""

    def _setup(self, nshards=8):
        a = power_law(4000, avg_degree=10, seed=1)
        op = DistSpmv(partition_coo(a, nshards))
        return a, op, to_scipy(a)

    def test_spmv_matches_scipy(self):
        a, op, s = self._setup()
        x = np.random.default_rng(0).standard_normal(a.shape[1])
        y = np.asarray(op(jnp.asarray(x)))
        np.testing.assert_allclose(y, s @ x, rtol=1e-12, atol=1e-12)

    def test_spmm_matches_scipy(self):
        a, op, s = self._setup()
        X = np.random.default_rng(1).standard_normal((a.shape[1], 8))
        Y = np.asarray(op(jnp.asarray(X)))
        np.testing.assert_allclose(Y, s @ X, rtol=1e-12, atol=1e-12)

    def test_uneven_shards(self):
        from cask_tpu.formats.generate import random_uniform

        a = random_uniform(3001, 3001, density=0.003, seed=2)  # ragged mloc
        op = DistSpmv(partition_coo(a, 4))
        x = np.random.default_rng(3).standard_normal(a.shape[1])
        y = np.asarray(op(jnp.asarray(x)))
        np.testing.assert_allclose(y, to_scipy(a) @ x, rtol=1e-12, atol=1e-12)

    def test_distributed_cg_on_poh(self):
        # SPD unstructured: A = B^T B + shift (pattern stays unstructured)
        import scipy.sparse as sp

        from cask_tpu.formats.convert import from_scipy
        from cask_tpu.formats.generate import random_uniform
        from cask_tpu.solvers import cg

        s = to_scipy(random_uniform(1200, 1200, density=0.004, seed=4))
        spd = (s.T @ s + 2.0 * sp.identity(1200)).tocsr()
        a = from_scipy(spd, format="csr")
        op = DistSpmv(partition_coo(a, 8))
        b = np.random.default_rng(5).standard_normal(a.shape[0])
        bp = op.padded(jnp.asarray(b))
        res = cg(op.padded_op, bp, tol=1e-9, maxiter=500)
        assert bool(res.converged)
        x = np.asarray(res.x)[: a.shape[0]]
        assert np.linalg.norm(spd @ x - b) < 1e-6


class TestPartition2D:
    """SUMMA-style 2-D block partition: x sharded over cols, psum over
    the cols axis, y sharded over rows."""

    @pytest.mark.parametrize("grid", [(2, 4), (4, 2), (8, 1), (1, 8)])
    def test_spmv(self, grid):
        from cask_tpu.parallel import Dist2DSpmv, mesh_2d, partition_2d

        pr, pc = grid
        a = power_law(3000, avg_degree=8, seed=1)
        op = Dist2DSpmv(partition_2d(a, pr, pc), mesh_2d(pr, pc))
        x = np.random.default_rng(0).standard_normal(a.shape[1])
        y = np.asarray(op(jnp.asarray(x)))
        np.testing.assert_allclose(y, to_scipy(a) @ x, rtol=1e-12, atol=1e-12)

    def test_rectangular_spmm(self):
        from cask_tpu.formats.generate import random_uniform
        from cask_tpu.parallel import Dist2DSpmv, partition_2d

        a = random_uniform(2000, 3100, density=0.004, seed=2)
        op = Dist2DSpmv(partition_2d(a, 2, 4))
        X = np.random.default_rng(1).standard_normal((a.shape[1], 8))
        Y = np.asarray(op(jnp.asarray(X)))
        np.testing.assert_allclose(Y, to_scipy(a) @ X, rtol=1e-12, atol=1e-12)

    def test_banded(self):
        from cask_tpu.parallel import Dist2DSpmv, partition_2d

        a = banded(1500, 5, seed=3)
        op = Dist2DSpmv(partition_2d(a, 4, 2))
        x = np.random.default_rng(2).standard_normal(a.shape[1])
        y = np.asarray(op(jnp.asarray(x)))
        np.testing.assert_allclose(y, to_scipy(a) @ x, rtol=1e-12, atol=1e-12)
