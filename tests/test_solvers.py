"""Krylov solvers (cask analog: R7 CG solver demo), device-resident loops."""

import jax
import numpy as np
import pytest

from cask_tpu.formats.convert import to_scipy
from cask_tpu.formats.generate import banded, stencil_2d
from cask_tpu.ops.ilu import ilu0
from cask_tpu.solvers import bicgstab, cg, gmres


def _spd():
    return stencil_2d(12)  # 144×144 SPD


class TestCG:
    def test_converges_on_spd(self):
        a = _spd()
        rng = np.random.default_rng(0)
        b = rng.standard_normal(a.shape[0])
        res = cg(a, b, tol=1e-10, maxiter=500)
        assert bool(res.converged)
        x_ref = np.linalg.solve(to_scipy(a).toarray(), b)
        np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=1e-6, atol=1e-8)

    def test_jittable_end_to_end(self):
        a = _spd().device_put()
        rng = np.random.default_rng(1)
        b = rng.standard_normal(a.shape[0])

        @jax.jit
        def solve(mat, rhs):
            return cg(mat, rhs, tol=1e-8, maxiter=300).x

        x = solve(a, b)
        np.testing.assert_allclose(
            to_scipy(a) @ np.asarray(x), b, rtol=1e-6, atol=1e-7
        )

    def test_ilu_preconditioning_reduces_iterations(self):
        a = _spd()
        rng = np.random.default_rng(2)
        b = rng.standard_normal(a.shape[0])
        plain = cg(a, b, tol=1e-8, maxiter=500)
        f = ilu0(a, use_native=False)
        pre = cg(a, b, tol=1e-8, maxiter=500, M=f.apply)
        assert bool(pre.converged)
        assert int(pre.iterations) < int(plain.iterations)

    def test_operator_callable(self):
        a = _spd()
        rng = np.random.default_rng(3)
        b = rng.standard_normal(a.shape[0])
        from cask_tpu import spmv

        dev = a.device_put()
        res = cg(lambda v: spmv(dev, v), b, tol=1e-9, maxiter=500)
        assert bool(res.converged)


class TestBiCGStab:
    def test_nonsymmetric(self):
        a = banded(150, 3, seed=4, spd=True)  # diagonally dominant, nonsym
        rng = np.random.default_rng(5)
        b = rng.standard_normal(150)
        res = bicgstab(a, b, tol=1e-9, maxiter=400)
        assert bool(res.converged)
        np.testing.assert_allclose(
            to_scipy(a) @ np.asarray(res.x), b, rtol=1e-6, atol=1e-7
        )


class TestGMRES:
    def test_nonsymmetric(self):
        a = banded(120, 2, seed=6, spd=True)
        rng = np.random.default_rng(7)
        b = rng.standard_normal(120)
        res = gmres(a, b, tol=1e-8, restart=40, maxiter=20)
        assert bool(res.converged)
        np.testing.assert_allclose(
            to_scipy(a) @ np.asarray(res.x), b, rtol=1e-5, atol=1e-6
        )

    def test_with_ilu(self):
        a = _spd()
        rng = np.random.default_rng(8)
        b = rng.standard_normal(a.shape[0])
        f = ilu0(a, use_native=False)
        res = gmres(a, b, tol=1e-8, restart=20, maxiter=30, M=f.apply)
        assert bool(res.converged)
        np.testing.assert_allclose(
            to_scipy(a) @ np.asarray(res.x), b, rtol=1e-5, atol=1e-6
        )


class TestPreconditioners:
    def test_jacobi(self):
        from cask_tpu.solvers import jacobi

        a = _spd()
        rng = np.random.default_rng(10)
        b = rng.standard_normal(a.shape[0])
        plain = cg(a, b, tol=1e-8, maxiter=500)
        pre = cg(a, b, tol=1e-8, maxiter=500, M=jacobi(a))
        assert bool(pre.converged)
        # Jacobi on a constant-diagonal stencil is a scaling — same path,
        # so just require convergence parity
        assert int(pre.iterations) <= int(plain.iterations) + 2

    def test_block_jacobi_beats_jacobi(self):
        # needs a genuinely SPD matrix (CG+preconditioner requirement):
        # banded(spd=True) is only diagonally dominant, not symmetric
        from cask_tpu.solvers import block_jacobi, jacobi

        a = _spd()
        rng = np.random.default_rng(11)
        b = rng.standard_normal(a.shape[0])
        jj = cg(a, b, tol=1e-8, maxiter=2000, M=jacobi(a))
        bj = cg(a, b, tol=1e-8, maxiter=2000, M=block_jacobi(a, block=12))
        assert bool(bj.converged)
        assert int(bj.iterations) <= int(jj.iterations)

    def test_block_jacobi_exact_block_inverse(self):
        from cask_tpu.solvers import block_jacobi

        a = _spd()
        n = a.shape[0]
        M = block_jacobi(a, block=16)
        dense = to_scipy(a).toarray()
        bd = np.zeros_like(dense)
        for b0 in range(0, n, 16):
            b1 = min(b0 + 16, n)
            bd[b0:b1, b0:b1] = dense[b0:b1, b0:b1]
        r = np.random.default_rng(14).standard_normal(n)
        np.testing.assert_allclose(np.asarray(M(r)), np.linalg.solve(bd, r), rtol=1e-10)

    def test_bicgstab_block_jacobi_nonsymmetric(self):
        from cask_tpu.solvers import block_jacobi

        a = banded(400, 6, seed=20, spd=True)  # dominant, nonsymmetric
        rng = np.random.default_rng(15)
        b = rng.standard_normal(400)
        res = bicgstab(a, b, tol=1e-8, maxiter=1000, M=block_jacobi(a, block=32))
        assert bool(res.converged)

    def test_block_jacobi_matrix_rhs(self):
        from cask_tpu.solvers import block_jacobi

        a = _spd()
        M = block_jacobi(a, block=16)
        rng = np.random.default_rng(12)
        R = rng.standard_normal((a.shape[0], 4))
        Z = np.asarray(M(R))
        z0 = np.asarray(M(R[:, 0]))
        np.testing.assert_allclose(Z[:, 0], z0, rtol=1e-12)


class TestChebyshev:
    def test_converges_with_bounds(self):
        from cask_tpu.solvers import chebyshev, jacobi
        from cask_tpu.formats.convert import to_scipy as _ts

        a = _spd()
        dense = _ts(a).toarray()
        w = np.linalg.eigvalsh(dense)
        rng = np.random.default_rng(13)
        b = rng.standard_normal(a.shape[0])
        res = chebyshev(a, b, lmin=float(w[0]), lmax=float(w[-1]),
                        tol=1e-8, maxiter=2000)
        assert bool(res.converged)
        np.testing.assert_allclose(dense @ np.asarray(res.x), b, rtol=1e-5, atol=1e-6)


class TestChebyshevPrecond:
    def test_reduces_cg_iterations(self):
        import jax.numpy as jnp

        from cask_tpu.formats.generate import stencil_2d
        from cask_tpu.solvers.krylov import cg
        from cask_tpu.solvers.precond import (chebyshev_precond,
                                              estimate_lmax, jacobi)

        a = stencil_2d(40)
        lmax = estimate_lmax(a.device_put(), a.shape[0], iters=30)
        M = chebyshev_precond(a.device_put(), lmin=lmax / 100, lmax=lmax,
                              degree=8, M=jacobi(a))
        b = jnp.asarray(np.random.default_rng(0).standard_normal(a.shape[0]))
        plain = cg(a.device_put(), b, tol=1e-8, maxiter=800)
        pre = cg(a.device_put(), b, tol=1e-8, maxiter=800, M=M)
        assert bool(pre.converged)
        assert int(pre.iterations) < int(plain.iterations) // 2

    def test_linear_operator(self):
        # fixed-degree Chebyshev is linear: M(a r1 + r2) == a M(r1) + M(r2)
        import jax.numpy as jnp

        from cask_tpu.formats.generate import banded
        from cask_tpu.solvers.precond import chebyshev_precond

        a = banded(300, 3, seed=1, spd=True)
        M = chebyshev_precond(a.device_put(), lmin=0.1, lmax=4.0, degree=5)
        rng = np.random.default_rng(2)
        r1 = jnp.asarray(rng.standard_normal(300))
        r2 = jnp.asarray(rng.standard_normal(300))
        lhs = np.asarray(M(2.5 * r1 + r2))
        rhs = 2.5 * np.asarray(M(r1)) + np.asarray(M(r2))
        np.testing.assert_allclose(lhs, rhs, rtol=1e-10, atol=1e-10)

    def test_distributed(self):
        import jax.numpy as jnp

        from cask_tpu.formats.generate import stencil_2d
        from cask_tpu.parallel import DistSpmv, partition_dia
        from cask_tpu.solvers.krylov import cg
        from cask_tpu.solvers.precond import chebyshev_precond

        a = stencil_2d(32)
        op = DistSpmv(partition_dia(a, 8))
        M = chebyshev_precond(op.padded_op, lmin=0.1, lmax=8.0, degree=6)
        b = np.random.default_rng(3).standard_normal(a.shape[0])
        bp = op.padded(jnp.asarray(b))
        plain = cg(op.padded_op, bp, tol=1e-8, maxiter=800)
        pre = cg(op.padded_op, bp, tol=1e-8, maxiter=800, M=M)
        assert bool(pre.converged)
        assert int(pre.iterations) < int(plain.iterations)


class TestLanczosExtremal:
    def test_bounds_spd_spectrum(self):
        from cask_tpu.solvers import lanczos_extremal

        a = stencil_2d(16)  # 256×256 SPD, spectrum known via dense eigh
        ev = np.linalg.eigvalsh(to_scipy(a).toarray())
        lmin, lmax = lanczos_extremal(a.device_put(), a.shape[0], iters=40)
        # estimates bracket the true spectrum (after the outward nudge)
        assert lmax >= ev[-1] * 0.999
        assert lmax <= ev[-1] * 1.15
        assert 0 < lmin <= ev[0] * 1.3

    def test_feeds_chebyshev_precond(self):
        import jax.numpy as jnp

        from cask_tpu.solvers import chebyshev_precond, lanczos_extremal

        a = stencil_2d(20)
        dev = a.device_put()
        lmin, lmax = lanczos_extremal(dev, a.shape[0], iters=30)
        M = chebyshev_precond(dev, lmin=lmin, lmax=lmax, degree=6)
        b = jnp.asarray(np.random.default_rng(7).standard_normal(a.shape[0]))
        plain = cg(dev, b, tol=1e-8, maxiter=800)
        pre = cg(dev, b, tol=1e-8, maxiter=800, M=M)
        assert bool(pre.converged)
        assert int(pre.iterations) < int(plain.iterations)

    def test_callable_operator(self):
        from cask_tpu import spmv
        from cask_tpu.solvers import lanczos_extremal

        a = stencil_2d(14)  # symmetric (Lanczos requirement)
        dev = a.device_put()
        lmin, lmax = lanczos_extremal(lambda v: spmv(dev, v), a.shape[0])
        ev = np.linalg.eigvalsh(to_scipy(a).toarray())
        assert lmax >= ev[-1] * 0.99


class TestMinres:
    def test_symmetric_indefinite(self):
        from cask_tpu.ops.add import shift_identity
        from cask_tpu.solvers import minres

        a = shift_identity(_spd(), -2.5)  # spectrum straddles 0
        ev = np.linalg.eigvalsh(to_scipy(a).toarray())
        assert ev[0] < 0 < ev[-1]  # genuinely indefinite
        b = np.random.default_rng(0).standard_normal(a.shape[0])
        res = minres(a.device_put(), b, tol=1e-10, maxiter=2000)
        assert bool(res.converged)
        x_ref = np.linalg.solve(to_scipy(a).toarray(), b)
        np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=1e-5, atol=1e-6)

    def test_spd_matches_cg(self):
        from cask_tpu.solvers import minres

        a = _spd()
        b = np.random.default_rng(1).standard_normal(a.shape[0])
        mres = minres(a.device_put(), b, tol=1e-10, maxiter=1000)
        cres = cg(a.device_put(), b, tol=1e-10, maxiter=1000)
        assert bool(mres.converged)
        np.testing.assert_allclose(np.asarray(mres.x), np.asarray(cres.x),
                                   rtol=1e-6, atol=1e-8)

    def test_jacobi_preconditioned(self):
        from cask_tpu.solvers import minres
        from cask_tpu.solvers.precond import jacobi

        a = stencil_2d(20)  # symmetric (MINRES requirement)
        b = np.random.default_rng(2).standard_normal(a.shape[0])
        plain = minres(a.device_put(), b, tol=1e-9, maxiter=2000)
        pre = minres(a.device_put(), b, tol=1e-9, maxiter=2000, M=jacobi(a))
        assert bool(pre.converged)
        assert int(pre.iterations) <= int(plain.iterations)
        resid = to_scipy(a) @ np.asarray(pre.x) - b
        assert np.linalg.norm(resid) / np.linalg.norm(b) < 1e-8


class TestCgls:
    def test_overdetermined_least_squares(self):
        from cask_tpu.formats.generate import random_uniform
        from cask_tpu.solvers import cgls

        a = random_uniform(300, 120, density=0.1, seed=3)
        b = np.random.default_rng(4).standard_normal(300)
        res = cgls(a.device_put(), b, tol=1e-12, maxiter=2000)
        assert bool(res.converged)
        x_ref = np.linalg.lstsq(to_scipy(a).toarray(), b, rcond=None)[0]
        np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=1e-6, atol=1e-8)

    def test_callable_requires_at(self):
        import pytest

        from cask_tpu.solvers import cgls

        with pytest.raises(ValueError):
            cgls(lambda v: v, np.ones(4))

    def test_callable_operator_pair(self):
        from cask_tpu import spmv
        from cask_tpu.formats.generate import random_uniform
        from cask_tpu.solvers import cgls

        a = random_uniform(200, 80, density=0.12, seed=6)
        dev = a.device_put()
        b = np.random.default_rng(5).standard_normal(200)
        res = cgls(lambda v: spmv(dev, v), b,
                   at=lambda v: spmv(dev, v, transpose=True),
                   tol=1e-12, maxiter=2000)
        x_ref = np.linalg.lstsq(to_scipy(a).toarray(), b, rcond=None)[0]
        np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=1e-6, atol=1e-8)


class TestIterativeRefinement:
    def test_f64_accuracy_from_f32_inner(self):
        import jax.numpy as jnp

        from cask_tpu.solvers import ir_solve

        a = stencil_2d(16)  # f64
        b = np.random.default_rng(7).standard_normal(a.shape[0])
        res = ir_solve(a.device_put(), b, work_dtype=jnp.float32,
                       tol=1e-12, maxiter=20, inner_tol=1e-5, inner_maxiter=400)
        assert bool(res.converged)
        assert np.asarray(res.x).dtype == np.float64
        relres = np.linalg.norm(to_scipy(a) @ np.asarray(res.x) - b) / np.linalg.norm(b)
        assert relres < 1e-12
        # converges in a handful of outer refinements, not maxiter
        assert int(res.iterations) <= 6

    def test_dia_plan_input(self):
        # the performance path: DiaMatrix carries .astype so ir_solve can
        # build its f32 working copy of the streaming-kernel plan
        import jax.numpy as jnp

        from cask_tpu.ops.dia import dia_plan
        from cask_tpu.solvers import ir_solve

        a = stencil_2d(16)
        d = dia_plan(a)
        assert d.astype(jnp.float32).vals.dtype == jnp.float32
        b = np.random.default_rng(8).standard_normal(a.shape[0])
        res = ir_solve(d, b, work_dtype=jnp.float32, tol=1e-12)
        relres = np.linalg.norm(to_scipy(a) @ np.asarray(res.x) - b) / np.linalg.norm(b)
        assert relres < 1e-12

    def test_preconditioned_inner(self):
        import jax.numpy as jnp

        from cask_tpu.solvers import ir_solve
        from cask_tpu.solvers.precond import jacobi

        a = stencil_2d(14)  # symmetric SPD (inner CG requirement)
        b = np.random.default_rng(9).standard_normal(a.shape[0])
        res = ir_solve(a.device_put(), b, work_dtype=jnp.float32, tol=1e-12,
                       M=jacobi(a.astype(np.float32)))
        assert bool(res.converged)
        relres = np.linalg.norm(to_scipy(a) @ np.asarray(res.x) - b) / np.linalg.norm(b)
        assert relres < 1e-12

    def test_rejects_callable(self):
        import pytest

        from cask_tpu.solvers import ir_solve

        with pytest.raises(ValueError):
            ir_solve(lambda v: v, np.ones(4))


class TestAmg:
    def test_iteration_count_scales_flat(self):
        from cask_tpu.solvers import cg, smoothed_aggregation_amg

        iters = {}
        for side in (24, 48):
            a = stencil_2d(side)
            M = smoothed_aggregation_amg(a)
            b = np.random.default_rng(0).standard_normal(a.shape[0])
            res = cg(a.device_put(), b, tol=1e-10, maxiter=2000, M=M)
            assert bool(res.converged)
            relres = np.linalg.norm(
                to_scipy(a) @ np.asarray(res.x) - b) / np.linalg.norm(b)
            assert relres < 1e-9
            iters[side] = int(res.iterations)
        # 4x unknowns: AMG iterations grow by at most a few (plain CG ~doubles)
        assert iters[48] <= iters[24] + 8
        assert iters[48] < 40

    def test_hierarchy_coarsens(self):
        from cask_tpu.solvers import smoothed_aggregation_amg

        a = stencil_2d(40)
        M = smoothed_aggregation_amg(a, coarse_size=100)
        sizes = M.level_sizes
        assert sizes[0] == a.shape[0]
        assert all(s2 < s1 for s1, s2 in zip(sizes, sizes[1:]))
        assert sizes[-1] <= 100

    def test_symmetric_operator(self):
        # V-cycle with nu_pre == nu_post is symmetric: r1'M(r2) == r2'M(r1)
        from cask_tpu.solvers import smoothed_aggregation_amg

        a = stencil_2d(16)
        M = smoothed_aggregation_amg(a)
        rng = np.random.default_rng(1)
        r1 = rng.standard_normal(a.shape[0])
        r2 = rng.standard_normal(a.shape[0])
        lhs = float(np.dot(r1, np.asarray(M(r2))))
        rhs = float(np.dot(r2, np.asarray(M(r1))))
        np.testing.assert_allclose(lhs, rhs, rtol=1e-10)

    def test_unsmoothed_aggregation_still_works(self):
        from cask_tpu.solvers import cg, smoothed_aggregation_amg

        a = stencil_2d(24)
        M = smoothed_aggregation_amg(a, smooth=False)
        b = np.random.default_rng(2).standard_normal(a.shape[0])
        res = cg(a.device_put(), b, tol=1e-9, maxiter=2000, M=M)
        assert bool(res.converged)

    def test_jittable_inside_solver(self):
        import jax
        import jax.numpy as jnp

        from cask_tpu.solvers import cg, smoothed_aggregation_amg

        a = stencil_2d(20)
        M = smoothed_aggregation_amg(a)
        b = np.random.default_rng(3).standard_normal(a.shape[0])

        @jax.jit
        def solve(rhs):
            return cg(a.device_put(), rhs, tol=1e-9, maxiter=500, M=M).x

        x = solve(jnp.asarray(b))
        np.testing.assert_allclose(to_scipy(a) @ np.asarray(x), b,
                                   rtol=1e-6, atol=1e-7)

    def test_f32_vcycle_in_f64_ir(self):
        import jax.numpy as jnp

        from cask_tpu.solvers import ir_solve, smoothed_aggregation_amg

        a = stencil_2d(24)
        M = smoothed_aggregation_amg(a, dtype=jnp.float32)
        b = np.random.default_rng(4).standard_normal(a.shape[0])
        res = ir_solve(a.device_put(), b, work_dtype=jnp.float32,
                       tol=1e-12, M=M, inner_maxiter=200)
        assert bool(res.converged)
        relres = np.linalg.norm(
            to_scipy(a) @ np.asarray(res.x) - b) / np.linalg.norm(b)
        assert relres < 1e-12


class TestBlockCG:
    def test_multi_rhs_matches_dense_solve(self):
        from cask_tpu.solvers import block_cg

        a = _spd()
        rng = np.random.default_rng(10)
        B = rng.standard_normal((a.shape[0], 4))
        res = block_cg(a, B, tol=1e-10, maxiter=500)
        assert bool(res.converged)
        x_ref = np.linalg.solve(to_scipy(a).toarray(), B)
        np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=1e-6, atol=1e-7)

    def test_fewer_iterations_than_single_cg(self):
        # shared block Krylov space: s coupled RHS converge in fewer
        # iterations than the worst single solve
        from cask_tpu.solvers import block_cg, cg

        a = _spd()
        rng = np.random.default_rng(11)
        B = rng.standard_normal((a.shape[0], 6))
        blk = block_cg(a, B, tol=1e-8, maxiter=500)
        single = cg(a, B[:, 0], tol=1e-8, maxiter=500)
        assert bool(blk.converged)
        assert int(blk.iterations) <= int(single.iterations)

    def test_preconditioned_block(self):
        from cask_tpu.solvers import block_cg, jacobi

        a = stencil_2d(18)  # SPD (banded(spd=True) is only diagonally dominant)
        rng = np.random.default_rng(12)
        B = rng.standard_normal((a.shape[0], 3))
        res = block_cg(a, B, tol=1e-9, maxiter=800, M=jacobi(a))
        assert bool(res.converged)
        np.testing.assert_allclose(
            to_scipy(a) @ np.asarray(res.x), B, rtol=1e-5, atol=1e-6)

    def test_rejects_vector_rhs(self):
        from cask_tpu.solvers import block_cg

        a = _spd()
        with pytest.raises(ValueError):
            block_cg(a, np.ones(a.shape[0]))


class TestPipelinedCG:
    def test_matches_cg_solution(self):
        from cask_tpu.solvers import cg, pipelined_cg

        a = _spd()
        rng = np.random.default_rng(20)
        b = rng.standard_normal(a.shape[0])
        pipe = pipelined_cg(a, b, tol=1e-10, maxiter=500)
        ref = cg(a, b, tol=1e-10, maxiter=500)
        assert bool(pipe.converged)
        # same Krylov space in exact arithmetic: iteration counts agree
        # to within a couple of steps of drift
        assert abs(int(pipe.iterations) - int(ref.iterations)) <= 5
        x_ref = np.linalg.solve(to_scipy(a).toarray(), b)
        np.testing.assert_allclose(np.asarray(pipe.x), x_ref, rtol=1e-6, atol=1e-8)

    def test_preconditioned(self):
        from cask_tpu.ops.ilu import ilu0
        from cask_tpu.solvers import cg, pipelined_cg

        a = _spd()
        rng = np.random.default_rng(21)
        b = rng.standard_normal(a.shape[0])
        f = ilu0(a, use_native=False)
        pre = pipelined_cg(a, b, tol=1e-9, maxiter=500, M=f.apply)
        plain = pipelined_cg(a, b, tol=1e-9, maxiter=500)
        assert bool(pre.converged)
        assert int(pre.iterations) < int(plain.iterations)

    def test_jittable(self):
        import jax.numpy as jnp

        from cask_tpu.solvers import pipelined_cg

        a = _spd().device_put()
        b = np.random.default_rng(22).standard_normal(a.shape[0])

        @jax.jit
        def solve(rhs):
            return pipelined_cg(a, rhs, tol=1e-8, maxiter=400).x

        x = solve(jnp.asarray(b))
        np.testing.assert_allclose(to_scipy(a) @ np.asarray(x), b,
                                   rtol=1e-6, atol=1e-7)


class TestIC0:
    def test_apply_equals_ilu0_apply(self):
        # symmetric pattern + SPD ⇒ LU = L·(D Lᵀ) = L_c L_cᵀ: same M
        from cask_tpu.ops.ilu import ilu0
        from cask_tpu.solvers import ic0

        a = _spd()
        rng = np.random.default_rng(30)
        r = rng.standard_normal(a.shape[0])
        f_ic = ic0(a)
        f_lu = ilu0(a, use_native=False)
        np.testing.assert_allclose(np.asarray(f_ic.apply(r)),
                                   np.asarray(f_lu.apply(r)),
                                   rtol=1e-10, atol=1e-12)

    def test_apply_is_symmetric(self):
        from cask_tpu.solvers import ic0

        a = _spd()
        f = ic0(a)
        rng = np.random.default_rng(31)
        u = rng.standard_normal(a.shape[0])
        v = rng.standard_normal(a.shape[0])
        lhs = float(np.dot(u, np.asarray(f.apply(v))))
        rhs = float(np.dot(np.asarray(f.apply(u)), v))
        np.testing.assert_allclose(lhs, rhs, rtol=1e-10)

    def test_cg_preconditioning_reduces_iterations(self):
        from cask_tpu.solvers import cg, ic0

        a = stencil_2d(16)
        rng = np.random.default_rng(32)
        b = rng.standard_normal(a.shape[0])
        plain = cg(a, b, tol=1e-8, maxiter=500)
        pre = cg(a, b, tol=1e-8, maxiter=500, M=ic0(a).apply)
        assert bool(pre.converged)
        assert int(pre.iterations) < int(plain.iterations)

    def test_rejects_indefinite(self):
        from cask_tpu.formats.convert import from_scipy
        from cask_tpu.solvers import ic0
        import scipy.sparse as sp

        a = from_scipy(sp.csr_matrix(np.diag([1.0, -2.0, 3.0])))
        with pytest.raises(ValueError):
            ic0(a)

    def test_multi_rhs_apply(self):
        from cask_tpu.solvers import ic0

        a = _spd()
        f = ic0(a)
        R = np.random.default_rng(33).standard_normal((a.shape[0], 3))
        out = np.asarray(f.apply(R))
        for j in range(3):
            np.testing.assert_allclose(out[:, j], np.asarray(f.apply(R[:, j])),
                                       rtol=1e-12)


class TestSSOR:
    def test_cg_preconditioning_reduces_iterations(self):
        from cask_tpu.solvers import cg, ssor

        a = stencil_2d(16)
        rng = np.random.default_rng(40)
        b = rng.standard_normal(a.shape[0])
        plain = cg(a, b, tol=1e-8, maxiter=800)
        pre = cg(a, b, tol=1e-8, maxiter=800, M=ssor(a))
        assert bool(pre.converged)
        assert int(pre.iterations) < int(plain.iterations)

    def test_apply_is_symmetric_for_symmetric_a(self):
        from cask_tpu.solvers import ssor

        a = _spd()
        M = ssor(a, omega=1.3)
        rng = np.random.default_rng(41)
        u = rng.standard_normal(a.shape[0])
        v = rng.standard_normal(a.shape[0])
        lhs = float(np.dot(u, np.asarray(M(v))))
        rhs = float(np.dot(np.asarray(M(u)), v))
        np.testing.assert_allclose(lhs, rhs, rtol=1e-10)

    def test_apply_matches_dense_formula(self):
        from cask_tpu.solvers import ssor

        a = _spd()
        omega = 1.2
        ad = to_scipy(a).toarray()
        D = np.diag(np.diag(ad))
        L = np.tril(ad, -1)
        U = np.triu(ad, 1)
        m = (D + omega * L) @ np.linalg.inv(D) @ (D + omega * U) / (omega * (2 - omega))
        rng = np.random.default_rng(42)
        r = rng.standard_normal(a.shape[0])
        np.testing.assert_allclose(np.asarray(ssor(a, omega=omega)(r)),
                                   np.linalg.solve(m, r), rtol=1e-9, atol=1e-11)

    def test_omega_validation(self):
        from cask_tpu.solvers import ssor

        with pytest.raises(ValueError):
            ssor(_spd(), omega=2.0)


class TestAmgRouting:
    """Level-operator routing: route='auto' sends banded levels through
    DIA plans where the platform enables them, unstructured levels
    through device CSR, small levels dense."""

    def test_routed_matches_csr_on_banded(self, auto_plans):
        from cask_tpu.ops.dia import DiaMatrix
        from cask_tpu.solvers import smoothed_aggregation_amg

        a = stencil_2d(56)  # 3136 rows: fine level above the dense cutoff
        M1 = smoothed_aggregation_amg(a)
        M2 = smoothed_aggregation_amg(a, route="csr")
        assert isinstance(M1.levels[0].a, DiaMatrix)  # banded fine level
        r = np.random.default_rng(0).standard_normal(a.shape[0])
        np.testing.assert_allclose(np.asarray(M1(r)), np.asarray(M2(r)),
                                   rtol=1e-9, atol=1e-9)

    def test_small_levels_go_dense(self):
        import jax

        from cask_tpu.solvers import smoothed_aggregation_amg

        a = stencil_2d(40)  # 1600 rows <= dense_cutoff
        M = smoothed_aggregation_amg(a)
        assert isinstance(M.levels[0].a, jax.Array)
        r = np.random.default_rng(1).standard_normal(a.shape[0])
        ref = np.asarray(smoothed_aggregation_amg(a, route="csr")(r))
        np.testing.assert_allclose(np.asarray(M(r)), ref, rtol=1e-9, atol=1e-9)

    def test_unstructured_levels_ride_poh_and_pcg_converges(self, auto_plans):
        import scipy.sparse as sp

        from cask_tpu.formats.convert import from_scipy
        from cask_tpu.formats.generate import random_uniform
        from cask_tpu.formats.matrix import CSR
        from cask_tpu.solvers import cg, smoothed_aggregation_amg

        s = to_scipy(random_uniform(3000, 3000, density=0.003, seed=4))
        spd = (s @ s.T + 4.0 * sp.identity(3000)).tocsr()
        a = from_scipy(spd, format="csr")
        M = smoothed_aggregation_amg(a, theta=0.02)
        kinds = [type(lv.a) for lv in M.levels]
        assert any(k is CSR for k in kinds)  # unstructured: no DIA plan
        b = np.random.default_rng(5).standard_normal(3000)
        res = cg(a.device_put(), b, tol=1e-8, maxiter=800, M=M)
        assert bool(res.converged)
        x = np.asarray(res.x)
        assert np.linalg.norm(spd @ x - b) / np.linalg.norm(b) < 1e-6


class TestAmgFactoredPR:
    """Large levels apply P = (I - w D^-1 A) T in factored form: the
    aggregate map (a gather and a segment_sum) + the routed level op."""

    def test_factored_objects_and_parity(self):
        from cask_tpu.solvers import smoothed_aggregation_amg
        from cask_tpu.solvers.amg import _FactoredApply

        a = stencil_2d(56)  # 3136 rows > dense_cutoff
        M = smoothed_aggregation_amg(a)
        assert isinstance(M.levels[0].p, _FactoredApply)
        assert isinstance(M.levels[0].r, _FactoredApply)
        assert M.levels[0].p.shape == (3136, M.level_sizes[1])
        assert M.levels[0].r.shape == (M.level_sizes[1], 3136)
        ref = smoothed_aggregation_amg(a, route="csr")
        r = np.random.default_rng(7).standard_normal(a.shape[0])
        np.testing.assert_allclose(np.asarray(M(r)), np.asarray(ref(r)),
                                   rtol=1e-9, atol=1e-9)

    def test_factored_pcg_converges(self):
        from cask_tpu.solvers import cg, smoothed_aggregation_amg

        a = stencil_2d(60)  # 3600 rows
        M = smoothed_aggregation_amg(a)
        b = np.random.default_rng(8).standard_normal(a.shape[0])
        res = cg(a.device_put(), b, tol=1e-8, maxiter=200, M=M)
        assert bool(res.converged)
        x = np.asarray(res.x)
        s = to_scipy(a)
        assert np.linalg.norm(s @ x - b) / np.linalg.norm(b) < 1e-6


class TestAmgAggregates:
    """The tentative prolongator as its aggregate map equals the one-hot
    matrix it stands for."""

    @pytest.mark.parametrize("n,nc", [(10, 3), (257, 40)])
    def test_prolong_restrict_match_dense(self, n, nc):
        import jax.numpy as jnp

        from cask_tpu.solvers.amg import Aggregates

        rng = np.random.default_rng(n)
        agg = np.concatenate([np.arange(nc), rng.integers(0, nc, n - nc)])
        T = np.zeros((n, nc))
        T[np.arange(n), agg] = 1.0
        A = Aggregates(agg=jnp.asarray(agg.astype(np.int32)), n_coarse=nc)
        xc = rng.standard_normal(nc)
        r = rng.standard_normal(n)
        np.testing.assert_allclose(np.asarray(A.prolong(jnp.asarray(xc))), T @ xc)
        np.testing.assert_allclose(np.asarray(A.restrict(jnp.asarray(r))), T.T @ r,
                                   rtol=1e-13)


class TestAmgPytree:
    """The hierarchy is a registered pytree: it rides into jitted solves
    as an ARGUMENT (closure-constant programs compile slower and
    re-trace per call)."""

    def test_jitted_solve_with_hierarchy_argument(self):
        import jax
        import jax.numpy as jnp

        from cask_tpu.formats.convert import to_scipy
        from cask_tpu.formats.generate import stencil_2d
        from cask_tpu.solvers import cg, smoothed_aggregation_amg

        a = stencil_2d(24)
        M = smoothed_aggregation_amg(a)
        dev = a.device_put()
        b = np.random.default_rng(5).standard_normal(a.shape[0])

        @jax.jit
        def solve(bb, Mp):
            r = cg(dev, bb, tol=1e-10, maxiter=2000, M=Mp)
            return r.x, r.iterations, r.converged

        x, its, conv = solve(jnp.asarray(b), M)
        assert bool(conv)
        relres = np.linalg.norm(to_scipy(a) @ np.asarray(x) - b) \
            / np.linalg.norm(b)
        assert relres < 1e-9
        # unjitted reference: same iteration count, same answer class
        r0 = cg(dev, b, tol=1e-10, maxiter=2000, M=M)
        assert int(its) == int(r0.iterations)

    def test_flatten_round_trip(self):
        import jax

        from cask_tpu.formats.generate import stencil_2d
        from cask_tpu.solvers import smoothed_aggregation_amg

        M = smoothed_aggregation_amg(stencil_2d(20))
        leaves, treedef = jax.tree_util.tree_flatten(M)
        M2 = jax.tree_util.tree_unflatten(treedef, leaves)
        assert (M2.omega, M2.nu_pre, M2.nu_post) == (M.omega, M.nu_pre, M.nu_post)
        assert len(M2.levels) == len(M.levels)
        b = np.random.default_rng(6).standard_normal(M.levels[0].a.shape[0])
        np.testing.assert_allclose(np.asarray(M2(b)), np.asarray(M(b)),
                                   rtol=1e-12, atol=1e-12)
