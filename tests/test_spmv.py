"""SpMV vs scipy ground truth (BASELINE config 1: f64 CSR exact-ish).

Matrix classes mirror the SuiteSparse classes cask benchmarked on
(banded/FEM/stencil + graph), generated synthetically (no network)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cask_tpu import spmv
from cask_tpu.formats.convert import csr_to_bsr, csr_to_coo, to_scipy
from cask_tpu.formats.generate import banded, fem_blocks, power_law, stencil_2d, suite
from cask_tpu.ops.dia import dia_plan


def _x(a, seed=0, k=None):
    rng = np.random.default_rng(seed)
    n = a.shape[1]
    return rng.standard_normal(n).astype(np.asarray(a.data).dtype)


MATS = {
    "banded": lambda: banded(301, 5, seed=1),
    "stencil": lambda: stencil_2d(20),
    "fem": lambda: fem_blocks(9, dof=4),
    "powerlaw": lambda: power_law(500, avg_degree=6, seed=2),
}


@pytest.mark.parametrize("name", list(MATS))
class TestSpmvFormats:
    def _check(self, a, x, y, rtol=1e-12):
        ref = to_scipy(a) @ x
        np.testing.assert_allclose(np.asarray(y), ref, rtol=rtol, atol=1e-12)

    def test_csr_f64(self, name):
        a = MATS[name]()
        x = _x(a)
        y = spmv(a, x, method="xla")
        self._check(a, x, y)

    def test_coo(self, name):
        a = MATS[name]()
        x = _x(a)
        y = spmv(csr_to_coo(a), x)
        self._check(a, x, y)

    @pytest.mark.parametrize("bs", [2, 4, 8])
    def test_bsr(self, name, bs):
        a = MATS[name]()
        x = _x(a)
        y = spmv(csr_to_bsr(a, bs), x)
        self._check(a, x, y)

    def test_csr_transpose(self, name):
        a = MATS[name]()
        rng = np.random.default_rng(7)
        x = rng.standard_normal(a.shape[0])
        y = spmv(a, x, transpose=True)
        np.testing.assert_allclose(np.asarray(y), to_scipy(a).T @ x, rtol=1e-12)

    def test_bsr_transpose(self, name):
        a = MATS[name]()
        rng = np.random.default_rng(8)
        x = rng.standard_normal(a.shape[0])
        y = spmv(csr_to_bsr(a, 4), x, transpose=True)
        np.testing.assert_allclose(np.asarray(y), to_scipy(a).T @ x, rtol=1e-12)

    def test_jit_with_matrix_argument(self, name):
        a = MATS[name]().device_put()
        x = jnp.asarray(_x(a))
        f = jax.jit(lambda mat, v: spmv(mat, v))
        np.testing.assert_allclose(np.asarray(f(a, x)), to_scipy(a) @ np.asarray(x), rtol=1e-12)


class TestSpmvDia:
    @pytest.mark.parametrize("name", ["banded", "stencil", "fem"])
    def test_dia_xla(self, name):
        a = MATS[name]()
        x = _x(a)
        d = dia_plan(a)
        y = d.spmv(jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(y), to_scipy(a) @ x, rtol=1e-12)

    def test_dia_remainder_split(self):
        a = power_law(400, avg_degree=6, seed=3)
        x = _x(a)
        d = dia_plan(a, min_density=0.5)  # force most entries into remainder
        assert d.rem_data.shape[0] > 0
        y = d.spmv(jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(y), to_scipy(a) @ x, rtol=1e-12)

    def test_dia_pallas_interpret(self):
        # the DIA formulation at a size with many row blocks, jitted
        a = banded(9000, 3, seed=4)
        x = _x(a)
        d = dia_plan(a)
        y = jax.jit(lambda m, v: m.spmv(v))(d, jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(y), to_scipy(a) @ x, rtol=1e-12)

    def test_dia_pallas_negative_and_large_offsets(self):
        a = stencil_2d(95)  # offsets ±95, ±1, 0
        x = _x(a)
        d = dia_plan(a)
        assert d.offsets == (-95, -1, 0, 1, 95)
        y = spmv(d, jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(y), to_scipy(a) @ x, rtol=1e-12)


class TestConfig1:
    """BASELINE config 1: ~2k-row SuiteSparse-style matrix, f64, vs scipy."""

    def test_bcsstk_like_f64_exact(self):
        mats = suite("small")
        a = mats["bcsstk_like"]
        rng = np.random.default_rng(0)
        x = rng.standard_normal(a.shape[1])
        y = spmv(a, x, method="xla")
        ref = to_scipy(a) @ x
        np.testing.assert_allclose(np.asarray(y), ref, rtol=1e-12, atol=0)

    def test_f32_accumulation_bound(self):
        a = suite("small")["stencil5_45x45"]
        a32 = type(a)(
            data=np.asarray(a.data, dtype=np.float32),
            indices=a.indices,
            indptr=a.indptr,
            shape=a.shape,
        )
        rng = np.random.default_rng(1)
        x = rng.standard_normal(a.shape[1]).astype(np.float32)
        y = spmv(a32, x)
        ref = to_scipy(a) @ x.astype(np.float64)
        np.testing.assert_allclose(np.asarray(y), ref, rtol=1e-4, atol=1e-5)


class TestSpmvBdiaDispatch:
    def test_method_bdia_on_bsr(self):
        import jax.numpy as jnp

        from cask_tpu import spmv
        from cask_tpu.formats.convert import csr_to_bsr, to_scipy
        from cask_tpu.formats.generate import fem_blocks

        a = fem_blocks(8, dof=4)
        b = csr_to_bsr(a, (4, 4))
        x = np.random.default_rng(0).standard_normal(a.shape[1])
        y = spmv(b, jnp.asarray(x), method="bdia")
        np.testing.assert_allclose(np.asarray(y), to_scipy(a) @ x, rtol=1e-11)

    def test_bdia_matrix_instance(self):
        import jax.numpy as jnp

        from cask_tpu import bdia_plan, spmv
        from cask_tpu.formats.convert import to_scipy
        from cask_tpu.formats.generate import fem_blocks

        a = fem_blocks(8, dof=2)
        plan = bdia_plan(a, (2, 2))
        x = np.random.default_rng(1).standard_normal(a.shape[1])
        y = spmv(plan, jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(y), to_scipy(a) @ x, rtol=1e-11)


class TestTransposePlans:
    def test_bdia_transpose_plan(self):
        from cask_tpu import bdia_plan
        from cask_tpu.ops.bdia import bdia_to_coo, transpose_plan

        a = fem_blocks(8, dof=3)
        plan = bdia_plan(a, (3, 3))
        # reconstruction is faithful
        np.testing.assert_allclose(bdia_to_coo(plan).todense(), to_scipy(a).toarray())
        pt = transpose_plan(plan)
        assert pt.blocksize == (3, 3)
        x = np.random.default_rng(2).standard_normal(a.shape[0])
        y = pt.spmv(jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(y), to_scipy(a).T @ x, rtol=1e-11)

    def test_bdia_transpose_rect_blocks(self):
        from cask_tpu.formats.convert import transpose
        from cask_tpu.ops.bdia import bdia_plan, transpose_plan

        a = fem_blocks(6, dof=2)
        plan = bdia_plan(a, (2, 2))
        # dispatch-level transpose on the plan object
        from cask_tpu import spmv as _spmv

        x = np.random.default_rng(3).standard_normal(a.shape[0])
        y = _spmv(plan, jnp.asarray(x), transpose=True)
        np.testing.assert_allclose(np.asarray(y), to_scipy(a).T @ x, rtol=1e-11)

    def test_dispatch_bdia_method_transpose_on_bsr(self):
        a = fem_blocks(7, dof=2)
        b = csr_to_bsr(a, (2, 2))
        x = np.random.default_rng(4).standard_normal(a.shape[0])
        y = spmv(b, jnp.asarray(x), method="bdia", transpose=True)
        np.testing.assert_allclose(np.asarray(y), to_scipy(a).T @ x, rtol=1e-11)

    def test_dia_transpose_rectangular(self):
        from cask_tpu.formats.generate import random_uniform
        from cask_tpu.ops.dia import dia_plan, transpose_plan

        a = banded(97, 3, seed=9)
        plan = dia_plan(a)
        pt = transpose_plan(plan)
        x = np.random.default_rng(5).standard_normal(a.shape[0])
        np.testing.assert_allclose(
            np.asarray(pt.spmv(jnp.asarray(x))), to_scipy(a).T @ x, rtol=1e-11)


class TestBsrAutoPlanRoute:
    """`spmv(bsr, x)` is the tuned path where the platform's route says
    so — a cached BDIA plan behind the obvious API call."""

    def test_auto_route_bit_exact_and_cached(self, auto_plans):
        from cask_tpu.ops.bdia import bdia_plan

        a = fem_blocks(12, dof=4)
        b = csr_to_bsr(a, (4, 4))
        x = jnp.asarray(np.random.default_rng(6).standard_normal(a.shape[1]))
        y_auto = np.asarray(spmv(b, x))
        plan = getattr(b, "_bdia_auto_plan")
        assert plan is not None, "qualifying FEM blocks must take the plan route"
        y_plan = np.asarray(plan.spmv(x))
        np.testing.assert_array_equal(y_auto, y_plan)  # bit-exact
        # independent reference plan agrees to fp
        y_ref = np.asarray(bdia_plan(b, (4, 4)).spmv(x))
        np.testing.assert_allclose(y_auto, y_ref, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(y_auto, to_scipy(a) @ np.asarray(x),
                                   rtol=1e-10, atol=1e-10)
        # plan is memoized on the instance: second dispatch re-uses it
        before = b._bdia_auto_plan
        spmv(b, x)
        assert b._bdia_auto_plan is before

    def test_auto_route_declines_unstructured(self, auto_plans):
        a = power_law(400, avg_degree=5, seed=7)
        b = csr_to_bsr(a, (4, 4))
        x = jnp.asarray(np.random.default_rng(7).standard_normal(b.shape[1]))
        y = np.asarray(spmv(b, x))
        # unstructured blocks must memoize a None plan and use XLA
        assert getattr(b, "_bdia_auto_plan", "missing") is None
        np.testing.assert_allclose(y, to_scipy(a) @ np.asarray(x),
                                   rtol=1e-10, atol=1e-10)

    def test_auto_route_never_plans_under_trace(self, auto_plans):
        a = fem_blocks(8, dof=2)
        b = csr_to_bsr(a, (2, 2))
        x = np.random.default_rng(8).standard_normal(b.shape[1])

        @jax.jit
        def f(bb, xx):
            return spmv(bb, xx)

        y = np.asarray(f(b, jnp.asarray(x)))
        np.testing.assert_allclose(y, to_scipy(a) @ x, rtol=1e-10, atol=1e-10)
        # tracer leaves must not be memoized
        assert getattr(b, "_bdia_auto_plan", None) is None


class TestCsrAutoPlanRoute:
    """Banded CSR rides a cached DIA plan where the route enables it."""

    def test_auto_route_banded_and_cached(self, auto_plans):
        a = banded(500, 4, seed=11)
        x = jnp.asarray(np.random.default_rng(11).standard_normal(a.shape[1]))
        y = np.asarray(spmv(a, x))
        plan = getattr(a, "_dia_auto_plan")
        assert plan is not None
        np.testing.assert_allclose(y, to_scipy(a) @ np.asarray(x),
                                   rtol=1e-10, atol=1e-10)
        before = a._dia_auto_plan
        spmv(a, x)
        assert a._dia_auto_plan is before

    def test_auto_route_declines_powerlaw(self, auto_plans):
        a = power_law(400, avg_degree=5, seed=12)
        x = jnp.asarray(np.random.default_rng(12).standard_normal(a.shape[1]))
        y = np.asarray(spmv(a, x))
        assert getattr(a, "_dia_auto_plan", "missing") is None
        np.testing.assert_allclose(y, to_scipy(a) @ np.asarray(x),
                                   rtol=1e-10, atol=1e-10)


class TestWideBandFusedGate:
    """A band far from the diagonal (offset 17000 of 40000 rows) packs
    into a two-diagonal BDIA plan like any other band: the auto route
    takes it and the plan is exact."""

    def _wide_band(self, n=40_000, off=17_000):
        import scipy.sparse as sp

        from cask_tpu.formats.convert import from_scipy

        s = sp.diags([np.ones(n), 0.5 * np.ones(n - off)], [0, off],
                     shape=(n, n), format="csr")
        return csr_to_bsr(from_scipy(s), (1, 1))

    def test_fixture_hits_the_gap(self):
        from cask_tpu.ops.bdia import bdia_plan

        p = bdia_plan(self._wide_band(), (1, 1))
        assert p.block_offsets == (0, 17_000)
        assert p.hi == 17_000 and p.rem_data.shape[0] == 0

    def test_auto_route_declines_wide_band(self, auto_plans):
        b = self._wide_band()
        x = jnp.asarray(np.random.default_rng(21).standard_normal(b.shape[1]))
        y = np.asarray(spmv(b, x))
        assert getattr(b, "_bdia_auto_plan", None) is not None
        np.testing.assert_allclose(y, to_scipy(b) @ np.asarray(x),
                                   rtol=1e-10, atol=1e-10)

    def test_plan_spmv_falls_back_instead_of_raising(self):
        from cask_tpu.ops.bdia import bdia_plan

        b = self._wide_band()
        p = bdia_plan(b, (1, 1))
        x = jnp.asarray(np.random.default_rng(22).standard_normal(b.shape[1]))
        for y in (p.spmv(x), spmv(p, x), jax.jit(spmv)(p, x)):
            np.testing.assert_allclose(np.asarray(y), to_scipy(b) @ np.asarray(x),
                                       rtol=1e-10, atol=1e-10)
