"""Sparse triangular solve + ILU(0) (BASELINE T5)."""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from cask_tpu.formats.convert import from_scipy, to_scipy
from cask_tpu.formats.generate import banded, stencil_2d
from cask_tpu.ops.ilu import ilu0
from cask_tpu.ops.trisolve import compute_levels, trisolve, trisolve_plan


def _tri_scipy(n, density, lower=True, seed=0, unit=False):
    rs = np.random.RandomState(seed)
    s = sp.random(n, n, density=density, format="csr", random_state=rs)
    s = sp.tril(s, k=-1) if lower else sp.triu(s, k=1)
    diag = np.ones(n) if unit else (rs.rand(n) + 1.0)
    s = (s + sp.diags(diag)).tocsr()
    s.sum_duplicates()
    return s


class TestTrisolve:
    @pytest.mark.parametrize("lower", [True, False])
    def test_random_triangle(self, lower):
        s = _tri_scipy(150, 0.05, lower=lower, seed=1)
        a = from_scipy(s)
        rng = np.random.default_rng(2)
        b = rng.standard_normal(150)
        x = trisolve(a, b, lower=lower)
        ref = spla.spsolve_triangular(s.tocsr(), b, lower=lower)
        np.testing.assert_allclose(np.asarray(x), ref, rtol=1e-10)

    def test_unit_diag(self):
        s = _tri_scipy(100, 0.05, lower=True, seed=3, unit=True)
        a = from_scipy(s)
        b = np.random.default_rng(4).standard_normal(100)
        x = trisolve(a, b, lower=True, unit_diag=True)
        ref = spla.spsolve_triangular(s.tocsr(), b, lower=True)
        np.testing.assert_allclose(np.asarray(x), ref, rtol=1e-10)

    def test_banded_many_levels(self):
        s = _tri_scipy(300, 0.0, lower=True, seed=5)
        # add the first subdiagonal → a chain: worst-case level count
        s = (s + sp.diags(np.ones(299), -1)).tocsr()
        a = from_scipy(s)
        b = np.random.default_rng(6).standard_normal(300)
        plan = trisolve_plan(a, lower=True)
        assert plan.nlevels == 300
        x = plan.solve(np.asarray(a.data), b)
        ref = spla.spsolve_triangular(s, b, lower=True)
        np.testing.assert_allclose(np.asarray(x), ref, rtol=1e-9)

    def test_diagonal_only_one_level(self):
        s = sp.diags(np.arange(1.0, 51.0)).tocsr()
        a = from_scipy(s)
        plan = trisolve_plan(a, lower=True)
        assert plan.nlevels == 1
        b = np.ones(50)
        x = plan.solve(np.asarray(a.data), b)
        np.testing.assert_allclose(np.asarray(x), 1.0 / np.arange(1.0, 51.0))

    def test_wrong_side_raises(self):
        s = _tri_scipy(20, 0.1, lower=True, seed=7)
        a = from_scipy(s)
        with pytest.raises(ValueError):
            trisolve_plan(a, lower=False)

    def test_levels_parallelism(self):
        # stencil lower triangle: levels ≈ anti-diagonals, each level wide
        a = from_scipy(sp.tril(to_scipy(stencil_2d(12))).tocsr())
        plan = trisolve_plan(a, lower=True)
        assert plan.nlevels < a.shape[0] / 2
        assert plan.max_rows > 1


class TestILU0:
    def _pattern_residual(self, a_csr, lu_csr):
        """‖(L·U − A)‖ restricted to A's pattern — the ILU(0) invariant."""
        s = to_scipy(a_csr)
        low, up = lu_csr.split()
        prod = (to_scipy(low) @ to_scipy(up)).tocsr()
        mask = s.copy()
        mask.data = np.ones_like(mask.data)
        diff = (prod.multiply(mask) - s)
        return 0.0 if diff.nnz == 0 else abs(diff).max()

    def test_spd_stencil(self):
        a = stencil_2d(10)
        f = ilu0(a, use_native=False)
        assert self._pattern_residual(a, f) < 1e-10

    def test_banded(self):
        a = banded(200, 4, seed=8, spd=True)
        f = ilu0(a, use_native=False)
        assert self._pattern_residual(a, f) < 1e-10

    def test_apply_is_good_preconditioner(self):
        a = stencil_2d(10)
        f = ilu0(a, use_native=False)
        rng = np.random.default_rng(9)
        b = rng.standard_normal(a.shape[0])
        z = np.asarray(f.apply(b))
        # M⁻¹ A should be much better conditioned than A
        dense = to_scipy(a).toarray()
        err = np.linalg.norm(dense @ z - b) / np.linalg.norm(b)
        assert err < 0.6  # ILU(0) of a stencil is a strong preconditioner

    def test_exact_for_no_fill_pattern(self):
        # tridiagonal: ILU(0) == exact LU (no fill-in exists)
        a = banded(100, 1, seed=10, spd=True)
        f = ilu0(a, use_native=False)
        rng = np.random.default_rng(11)
        b = rng.standard_normal(100)
        x = np.asarray(f.apply(b))
        ref = np.linalg.solve(to_scipy(a).toarray(), b)
        np.testing.assert_allclose(x, ref, rtol=1e-8)


class TestMultiRHS:
    def test_matrix_rhs(self):
        s = _tri_scipy(120, 0.05, lower=True, seed=20)
        a = from_scipy(s)
        rng = np.random.default_rng(21)
        B = rng.standard_normal((120, 8))
        X = trisolve(a, B, lower=True)
        for j in range(8):
            ref = spla.spsolve_triangular(s.tocsr(), B[:, j], lower=True)
            np.testing.assert_allclose(np.asarray(X)[:, j], ref, rtol=1e-10)

    def test_ilu_apply_matrix(self):
        a = stencil_2d(8)
        from cask_tpu.ops.ilu import ilu0

        f = ilu0(a, use_native=False)
        rng = np.random.default_rng(22)
        B = rng.standard_normal((64, 4))
        Z = np.asarray(f.apply(B))
        z0 = np.asarray(f.apply(B[:, 0]))
        np.testing.assert_allclose(Z[:, 0], z0, rtol=1e-12)


class TestIlu0Device:
    """Chow–Patel fine-grained parallel ILU(0) (device path)."""

    def test_converges_to_host_factorization(self):
        from cask_tpu.ops.ilu import ilu0, ilu0_device_plan

        a = stencil_2d(16)
        host = ilu0(a, use_native=False)
        plan = ilu0_device_plan(a)
        v = plan.factorize(sweeps=25)
        np.testing.assert_allclose(np.asarray(v), np.asarray(host.lu.data),
                                   rtol=1e-9, atol=1e-9)
        assert float(plan.residual(v)) < 1e-9

    def test_apply_matches_host(self):
        import jax.numpy as jnp

        from cask_tpu.ops.ilu import ilu0, ilu0_device

        a = banded(250, 3, seed=5, spd=True)
        host = ilu0(a, use_native=False)
        dev = ilu0_device(a, sweeps=25)
        b = np.random.default_rng(1).standard_normal(a.shape[0])
        np.testing.assert_allclose(np.asarray(dev.apply(jnp.asarray(b))),
                                   np.asarray(host.apply(jnp.asarray(b))),
                                   rtol=1e-8, atol=1e-8)

    def test_values_rebind_without_replanning(self):
        from cask_tpu.ops.ilu import ilu0, ilu0_device_plan
        from cask_tpu.formats.matrix import CSR

        a = stencil_2d(12)
        plan = ilu0_device_plan(a)
        a2 = CSR(data=np.asarray(a.data) * 2.0, indices=a.indices,
                 indptr=a.indptr, shape=a.shape)
        host2 = ilu0(a2, use_native=False)
        v2 = plan.factorize(np.asarray(a2.data), sweeps=25)
        np.testing.assert_allclose(np.asarray(v2), np.asarray(host2.lu.data),
                                   rtol=1e-9, atol=1e-9)

    def test_jittable_factorize(self):
        import jax

        from cask_tpu.ops.ilu import ilu0_device_plan

        a = stencil_2d(10)
        plan = ilu0_device_plan(a)
        v = jax.jit(lambda p: p.factorize(sweeps=15))(plan)
        assert float(plan.residual(v)) < 1e-6

    def test_preconditions_cg(self):
        import jax.numpy as jnp

        from cask_tpu.ops.ilu import ilu0_device
        from cask_tpu.solvers.krylov import cg

        a = stencil_2d(20)
        b = jnp.asarray(np.random.default_rng(3).standard_normal(a.shape[0]))
        dev = ilu0_device(a, sweeps=8)
        plain = cg(a.device_put(), b, tol=1e-8, maxiter=800)
        pre = cg(a.device_put(), b, tol=1e-8, maxiter=800, M=dev.apply)
        assert bool(pre.converged)
        assert int(pre.iterations) < int(plain.iterations)

    def test_residual_flags_divergence(self):
        from cask_tpu.ops.ilu import ilu0_device_plan

        # random non-dominant values: fixed point diverges -> residual large
        a = banded(200, 4, seed=7, spd=False)
        plan = ilu0_device_plan(a)
        v = plan.factorize(sweeps=15)
        res = float(plan.residual(v))
        assert not np.isfinite(res) or res > 1e-2

    def test_missing_diagonal_raises(self):
        from cask_tpu.formats.convert import coo_from_arrays, coo_to_csr
        from cask_tpu.ops.ilu import ilu0_device_plan

        a = coo_to_csr(coo_from_arrays(np.ones(2), np.array([0, 1]),
                                       np.array([1, 0]), (2, 2)))
        with pytest.raises(ValueError):
            ilu0_device_plan(a)


class TestJacobiTrisolve:
    """Iterative (Jacobi–Richardson) sweep solve — the parallel
    approximate trisolve."""

    @pytest.mark.parametrize("lower", [True, False])
    def test_exact_after_n_sweeps(self, lower):
        # the iteration matrix is strictly triangular (nilpotent):
        # n sweeps reproduce the exact solve on ANY triangle
        s = _tri_scipy(60, 0.08, lower=lower, seed=5)
        a = from_scipy(s)
        b = np.random.default_rng(6).standard_normal(60)
        x = trisolve(a, b, lower=lower, method="jacobi", sweeps=60)
        ref = spla.spsolve_triangular(s.tocsr(), b, lower=lower)
        np.testing.assert_allclose(np.asarray(x), ref, rtol=1e-9, atol=1e-9)

    def test_error_decays_with_sweeps(self):
        # diagonally dominant triangle: each sweep contracts the error
        s = _tri_scipy(200, 0.03, lower=True, seed=7)
        s = (s + 5.0 * sp.eye(200)).tocsr()
        a = from_scipy(s)
        b = np.random.default_rng(8).standard_normal(200)
        ref = spla.spsolve_triangular(s, b, lower=True)
        errs = []
        for sweeps in (1, 3, 6):
            x = np.asarray(trisolve(a, b, lower=True, method="jacobi",
                                    sweeps=sweeps))
            errs.append(np.linalg.norm(x - ref) / np.linalg.norm(ref))
        assert errs[1] < errs[0] * 0.3
        assert errs[2] < errs[1] * 0.3

    def test_unit_diag_and_batch(self):
        s = _tri_scipy(80, 0.05, lower=True, seed=9, unit=True)
        a = from_scipy(s)
        B = np.random.default_rng(10).standard_normal((80, 3))
        X = trisolve(a, B, lower=True, unit_diag=True, method="jacobi",
                     sweeps=80)
        for j in range(3):
            ref = spla.spsolve_triangular(s.tocsr(), B[:, j], lower=True)
            np.testing.assert_allclose(np.asarray(X)[:, j], ref,
                                       rtol=1e-9, atol=1e-9)

    def test_banded_routes_through_dia(self):
        from cask_tpu.ops.dia import DiaMatrix
        from cask_tpu.ops.trisolve import jacobi_trisolve_plan

        s = to_scipy(stencil_2d(12))
        low = from_scipy(sp.tril(s, k=0).tocsr())
        plan = jacobi_trisolve_plan(low, lower=True)
        assert isinstance(plan.strict, DiaMatrix)  # banded strict part
        b = np.random.default_rng(11).standard_normal(144)
        x = np.asarray(plan.solve(b, sweeps=144))
        ref = spla.spsolve_triangular(sp.tril(s, k=0).tocsr(), b, lower=True)
        np.testing.assert_allclose(x, ref, rtol=1e-8, atol=1e-9)

    def test_ilu_jacobi_apply_matches_exact_apply(self):
        a = stencil_2d(14)
        f = ilu0(a)
        b = np.random.default_rng(12).standard_normal(a.shape[0])
        exact = np.asarray(f.apply(b))
        approx = np.asarray(f.apply(b, method="jacobi", sweeps=a.shape[0]))
        np.testing.assert_allclose(approx, exact, rtol=1e-8, atol=1e-9)
        # few sweeps: preconditioner-quality agreement on this
        # diagonally dominant factor pair
        rough = np.asarray(f.apply(b, method="jacobi", sweeps=8))
        assert np.linalg.norm(rough - exact) / np.linalg.norm(exact) < 0.05

    def test_ilu_jacobi_pcg_converges_and_cuts_iterations(self):
        import jax.numpy as jnp

        from cask_tpu.solvers import cg

        a = stencil_2d(24)
        f = ilu0(a)
        dev = a.device_put()
        b = np.random.default_rng(13).standard_normal(a.shape[0])
        plain = cg(dev, jnp.asarray(b), tol=1e-8, maxiter=2000)
        pre = cg(dev, jnp.asarray(b), tol=1e-8, maxiter=2000,
                 M=f.jacobi_applier(sweeps=4))
        assert bool(pre.converged)
        assert int(pre.iterations) < int(plain.iterations) * 0.55
        x = np.asarray(pre.x)
        np.testing.assert_allclose(to_scipy(a) @ x, b, rtol=1e-5, atol=1e-6)

    def test_ic0_jacobi_apply(self):
        from cask_tpu.solvers.precond import ic0

        a = stencil_2d(12)
        f = ic0(a)
        b = np.random.default_rng(14).standard_normal(a.shape[0])
        exact = np.asarray(f.apply(b))
        approx = np.asarray(f.apply(b, method="jacobi", sweeps=a.shape[0]))
        np.testing.assert_allclose(approx, exact, rtol=1e-8, atol=1e-9)
