"""SpMM (sparse × dense tall-skinny) vs scipy (BASELINE config 3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cask_tpu import spmm
from cask_tpu.formats.convert import csr_to_bsr, csr_to_coo, to_scipy
from cask_tpu.formats.generate import banded, fem_blocks, power_law, stencil_2d
from cask_tpu.ops.dia import dia_plan

MATS = {
    "banded": lambda: banded(301, 5, seed=1),
    "stencil": lambda: stencil_2d(18),
    "fem": lambda: fem_blocks(8, dof=4),
    "powerlaw": lambda: power_law(400, avg_degree=6, seed=2),
}


def _X(a, k, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((a.shape[1], k))


@pytest.mark.parametrize("name", list(MATS))
@pytest.mark.parametrize("k", [32, 128])
class TestSpmm:
    def test_csr(self, name, k):
        a = MATS[name]()
        x = _X(a, k)
        y = spmm(a, x, method="xla")
        np.testing.assert_allclose(np.asarray(y), to_scipy(a) @ x, rtol=1e-12, atol=1e-10)

    def test_coo(self, name, k):
        a = MATS[name]()
        x = _X(a, k)
        y = spmm(csr_to_coo(a), x)
        np.testing.assert_allclose(np.asarray(y), to_scipy(a) @ x, rtol=1e-12, atol=1e-10)

    def test_bsr(self, name, k):
        a = MATS[name]()
        x = _X(a, k)
        y = spmm(csr_to_bsr(a, 4), x)
        np.testing.assert_allclose(np.asarray(y), to_scipy(a) @ x, rtol=1e-12, atol=1e-10)

    def test_csr_transpose(self, name, k):
        a = MATS[name]()
        rng = np.random.default_rng(3)
        x = rng.standard_normal((a.shape[0], k))
        y = spmm(a, x, transpose=True)
        np.testing.assert_allclose(np.asarray(y), to_scipy(a).T @ x, rtol=1e-12, atol=1e-10)

    def test_bsr_transpose(self, name, k):
        a = MATS[name]()
        rng = np.random.default_rng(4)
        x = rng.standard_normal((a.shape[0], k))
        y = spmm(csr_to_bsr(a, 4), x, transpose=True)
        np.testing.assert_allclose(np.asarray(y), to_scipy(a).T @ x, rtol=1e-12, atol=1e-10)


class TestSpmmDia:
    @pytest.mark.parametrize("k", [32, 128])
    def test_dia_xla(self, k):
        a = stencil_2d(18)
        x = _X(a, k)
        d = dia_plan(a)
        y = d.spmm(jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(y), to_scipy(a) @ x, rtol=1e-12, atol=1e-10)

    @pytest.mark.parametrize("k", [32, 128])
    def test_dia_pallas_interpret(self, k):
        # the DIA formulation at a size with many row blocks, jitted
        a = banded(9000, 2, seed=5)
        x = _X(a, k)
        d = dia_plan(a)
        y = jax.jit(lambda m, v: m.spmm(v))(d, jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(y), to_scipy(a) @ x, rtol=1e-12, atol=1e-10)


class TestSpmmDiaKt:
    """Narrow k (k ≤ 64) through the DIA formulation."""

    @pytest.mark.parametrize("k", [8, 20, 32, 64])
    def test_vs_scipy(self, k):
        a = banded(9000, 2, seed=5)
        x = _X(a, k)
        d = dia_plan(a)
        y = spmm(d, jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(y), to_scipy(a) @ x, rtol=1e-12, atol=1e-10)

    def test_dispatch_uses_kt_for_narrow_k(self):
        a = stencil_2d(25)
        x = _X(a, 16)
        y = spmm(a, jnp.asarray(x), method="dia")
        np.testing.assert_allclose(np.asarray(y), to_scipy(a) @ x, rtol=1e-12, atol=1e-10)

    def test_padded_layout_roundtrip(self):
        # the plan is natural-order in and out: an SpMM output chains as
        # the next input with no relayout
        a = banded(3000, 4, seed=6)
        d = dia_plan(a)
        x = _X(a, 32)
        y2 = d.spmm(d.spmm(jnp.asarray(x)))
        s = to_scipy(a)
        np.testing.assert_allclose(np.asarray(y2), s @ (s @ x), rtol=1e-12, atol=1e-9)

    def test_asymmetric_offsets(self):
        # strictly upper-shifted band (lo=0) and lower-shifted band (hi=0)
        import scipy.sparse as sp

        from cask_tpu.formats.convert import from_scipy

        n = 2000
        rng = np.random.default_rng(7)
        for offs in ([1, 3, 7], [-5, -2, 0]):
            s = sp.diags([rng.standard_normal(n - abs(o)) for o in offs],
                         offs, shape=(n, n)).tocsr()
            a = from_scipy(s, format="csr")
            d = dia_plan(a)
            x = rng.standard_normal((n, 24))
            y = d.spmm(jnp.asarray(x))
            np.testing.assert_allclose(np.asarray(y), s @ x, rtol=1e-12, atol=1e-10)


class TestSpmmBdiaDispatch:
    def test_bdia_matrix_spmm_and_transpose(self):
        from cask_tpu import bdia_plan

        a = fem_blocks(6, dof=2)
        plan = bdia_plan(a, (2, 2))
        k = 8
        x = np.random.default_rng(11).standard_normal((a.shape[1], k))
        y = spmm(plan, jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(y), to_scipy(a) @ x, rtol=1e-11)
        xt = np.random.default_rng(12).standard_normal((a.shape[0], k))
        yt = spmm(plan, jnp.asarray(xt), transpose=True)
        np.testing.assert_allclose(np.asarray(yt), to_scipy(a).T @ xt, rtol=1e-11)

    def test_ring_vals_pack_no_tracer_leak(self):
        """First call under jit, second call in a fresh jit with the plan
        as a traced argument: nothing host-side is memoized from a trace."""
        from cask_tpu.ops.bdia import bdia_plan

        a = fem_blocks(16, dof=4, dtype=np.float32)
        plan = bdia_plan(a, (4, 4))
        k = 128
        x = np.random.default_rng(5).standard_normal(
            (a.shape[1], k)).astype(np.float32)

        y1 = jax.jit(lambda v: spmm(plan, v))(jnp.asarray(x))
        y2 = jax.jit(lambda p, v: 2.0 * spmm(p, v))(plan, jnp.asarray(x))
        ref = to_scipy(a) @ x
        np.testing.assert_allclose(np.asarray(y1), ref, rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(np.asarray(y2), 2 * ref, rtol=2e-4, atol=1e-5)


class TestRingMxuHybrid:
    """f32 stencil SpMM at k=128 through the DIA plan: exact f32 class."""

    def test_matches_ring_within_bf16(self):
        a = stencil_2d(64, dtype=np.float32)
        plan = dia_plan(a)
        X = np.random.default_rng(0).standard_normal(
            (a.shape[1], 128)).astype(np.float32)
        Y = np.asarray(plan.spmm(jnp.asarray(X)))
        ref = to_scipy(a) @ X
        assert np.abs(Y - ref).max() / np.abs(ref).max() < 1e-6


class TestBdiaRingGeometry:
    @pytest.mark.parametrize("nx", [256, 64])
    def test_prefers_grid_aligned_tm(self, nx):
        # the device-built FEM plan: natural (br, npairs, nbr) layout,
        # pairs in (offset, component) order, exact at k=4 vs the host
        # reference matrix
        from cask_tpu.formats.device_gen import fem_bdia_device
        from cask_tpu.parallel import fem_formula_bsr

        plan = fem_bdia_device(nx, dof=4, dtype=jnp.float64)
        assert plan.vals.shape == (4, 20, nx * nx)
        assert plan.pairs[:4] == ((0, -nx), (1, -nx), (2, -nx), (3, -nx))
        X = np.random.default_rng(nx).standard_normal((plan.shape[1], 4))
        ref = to_scipy(fem_formula_bsr(nx, dof=4)) @ X
        np.testing.assert_allclose(np.asarray(plan.spmm(jnp.asarray(X))), ref,
                                   rtol=1e-12, atol=1e-12)

    def test_largest_tm_on_ties(self):
        # f32 device plan against its own f64 twin
        from cask_tpu.formats.device_gen import fem_bdia_device

        p32 = fem_bdia_device(64, dof=4, dtype=jnp.float32)
        p64 = fem_bdia_device(64, dof=4, dtype=jnp.float64)
        np.testing.assert_array_equal(np.asarray(p32.vals, np.float64),
                                      np.asarray(p64.vals))


class TestBsrSpmmAutoPlanRoute:
    """spmm(bsr, X) shares spmv's cached BDIA plan."""

    def test_auto_route_and_shared_cache(self, auto_plans):
        a = fem_blocks(10, dof=4)
        b = csr_to_bsr(a, (4, 4))
        X = jnp.asarray(np.random.default_rng(20).standard_normal(
            (a.shape[1], 8)))
        Y = np.asarray(spmm(b, X))
        plan = getattr(b, "_bdia_auto_plan")
        assert plan is not None
        np.testing.assert_array_equal(Y, np.asarray(spmm(plan, X)))
        np.testing.assert_allclose(Y, to_scipy(a) @ np.asarray(X),
                                   rtol=1e-10, atol=1e-10)
        # spmv and spmm share the one memoized plan
        from cask_tpu.ops.spmv import spmv as _spmv

        _spmv(b, X[:, 0])
        assert b._bdia_auto_plan is plan


class TestCsrSpmmAutoRoute:
    """spmm(csr, X) rides the same cached DIA plan as spmv(csr, x)."""

    def test_banded_csr_routes_through_plan(self, auto_plans):
        a = banded(500, 4, seed=31)
        X = np.random.default_rng(31).standard_normal((a.shape[1], 8))
        Y = np.asarray(spmm(a, jnp.asarray(X)))
        plan = getattr(a, "_dia_auto_plan", None)
        assert plan is not None, "banded CSR spmm must take the plan route"
        np.testing.assert_allclose(Y, to_scipy(a) @ X, rtol=1e-10, atol=1e-10)
        # same instance-memoized plan serves spmv too
        from cask_tpu import spmv

        y = np.asarray(spmv(a, jnp.asarray(X[:, 0])))
        assert a._dia_auto_plan is plan
        np.testing.assert_allclose(y, to_scipy(a) @ X[:, 0],
                                   rtol=1e-10, atol=1e-10)

    def test_unstructured_declines(self, auto_plans):
        a = power_law(400, avg_degree=5, seed=32)
        X = np.random.default_rng(32).standard_normal((a.shape[1], 4))
        Y = np.asarray(spmm(a, jnp.asarray(X)))
        assert getattr(a, "_dia_auto_plan", "missing") is None
        np.testing.assert_allclose(Y, to_scipy(a) @ X, rtol=1e-10, atol=1e-10)


class TestBdiaSlabSpmmRoute:
    """Wide-k BDIA SpMM through the BDIA formulation: exact, jittable
    with the plan as an argument, and memoizing nothing under a trace."""

    def _plan(self, nx=16, dof=4):
        from cask_tpu.ops.bdia import bdia_plan

        a = fem_blocks(nx, dof=dof, return_bsr=True)
        return bdia_plan(a, (dof, dof)), a

    def test_slab_route_matches_scipy(self):
        p, a = self._plan()
        X = np.random.default_rng(41).standard_normal((p.shape[1], 128))
        Y = np.asarray(spmm(p, jnp.asarray(X)))
        np.testing.assert_allclose(Y, to_scipy(a) @ X, rtol=1e-10, atol=1e-9)

    def test_ring_still_forced_by_pallas_bdia(self):
        # the removed kernel methods are refused, not silently rerouted
        p, a = self._plan(12)
        X = np.random.default_rng(42).standard_normal((p.shape[1], 96))
        for method in ("pallas_bdia", "slab", "pallas_bsr"):
            with pytest.raises(ValueError, match="unknown spmm method"):
                spmm(p, jnp.asarray(X), method=method)
        Y = np.asarray(spmm(p, jnp.asarray(X), method="xla"))
        np.testing.assert_allclose(Y, to_scipy(a) @ X, rtol=1e-10, atol=1e-9)

    def test_no_slab_build_under_trace(self, auto_plans):
        p, a = self._plan(12)
        X = np.random.default_rng(43).standard_normal((p.shape[1], 96))

        @jax.jit
        def f(bb, XX):
            return spmm(bb, XX)

        Y = np.asarray(f(a, jnp.asarray(X)))
        np.testing.assert_allclose(Y, to_scipy(a) @ X, rtol=1e-10, atol=1e-9)
        # tracer leaves must not be memoized as a plan
        assert getattr(a, "_bdia_auto_plan", None) is None


class TestSpmmSlabPlanArgument:
    """A held BdiaMatrix IS an spmm operator: jitted solver loops pass it
    as a pytree argument."""

    def test_slab_plan_as_traced_operand(self):
        from cask_tpu.ops.bdia import bdia_plan

        a = fem_blocks(16, dof=4, return_bsr=True)
        p = bdia_plan(a, (4, 4))
        X = np.random.default_rng(61).standard_normal((p.shape[1], 96))

        @jax.jit
        def f(P, XX):
            return spmm(P, XX)

        Y = np.asarray(f(p, jnp.asarray(X)))
        np.testing.assert_allclose(Y, to_scipy(a) @ X, rtol=1e-10, atol=1e-9)
        Yt = np.asarray(spmm(p, jnp.asarray(X), transpose=True))
        np.testing.assert_allclose(Yt, to_scipy(a).T @ X, rtol=1e-10, atol=1e-9)
