"""SpGEMM (A·A, A·B) vs scipy (BASELINE config 4: graph matrices)."""

import jax
import numpy as np
import pytest
import scipy.sparse as sp

from cask_tpu import spgemm
from cask_tpu.formats.convert import from_scipy, to_scipy
from cask_tpu.formats.generate import power_law, random_uniform, stencil_2d
from cask_tpu.ops.spgemm import spgemm_plan


def _close(c, ref):
    ref = ref.tocsr()
    ref.sum_duplicates()
    ref.eliminate_zeros()
    got = to_scipy(c)
    got.eliminate_zeros()
    d = abs(got - ref)
    assert d.nnz == 0 or d.max() < 1e-10


class TestSpgemm:
    def test_aa_graph(self):
        a = power_law(300, avg_degree=5, seed=1)
        c = spgemm(a)
        _close(c, to_scipy(a) @ to_scipy(a))

    def test_aa_stencil(self):
        a = stencil_2d(15)
        c = spgemm(a)
        _close(c, to_scipy(a) @ to_scipy(a))

    def test_ab_rectangular(self):
        a = random_uniform(80, 120, density=0.05, seed=2)
        b = random_uniform(120, 60, density=0.05, seed=3)
        c = spgemm(a, b)
        _close(c, to_scipy(a) @ to_scipy(b))

    def test_plan_reuse_across_values(self):
        rs = np.random.RandomState(0)
        s1 = sp.random(70, 70, density=0.08, format="csr", random_state=rs)
        s2 = s1.copy()
        s2.data = rs.standard_normal(s2.nnz)
        a1, a2 = from_scipy(s1), from_scipy(s2)
        plan = spgemm_plan(a1, a1)
        c1 = plan.numeric(a1.data, a1.data)
        c2 = plan.numeric(a2.data, a2.data)
        _close(c1, s1 @ s1)
        _close(c2, s2 @ s2)

    def test_empty_rows(self):
        s = sp.csr_matrix((5, 5))
        s[1, 2] = 3.0
        a = from_scipy(s.tocsr())
        c = spgemm(a)
        _close(c, s @ s)

    def test_structure_matches_scipy(self):
        a = power_law(200, avg_degree=4, seed=4)
        plan = spgemm_plan(a, a)
        ref = (to_scipy(a) @ to_scipy(a)).tocsr()
        ref.sum_duplicates()
        # structural nnz equal (we keep explicit numerical zeros; scipy may too)
        assert plan.nnz == ref.nnz

    def test_dimension_mismatch_raises(self):
        a = random_uniform(10, 20, density=0.2)
        b = random_uniform(30, 10, density=0.2)
        with pytest.raises(ValueError):
            spgemm(a, b)


class TestNativeBackend:
    def test_native_matches_plan(self):
        import pytest as _pt

        from cask_tpu.native import available

        if not available():
            _pt.skip("no C++ toolchain")
        from cask_tpu.ops.spgemm import spgemm_native

        a = power_law(400, avg_degree=6, seed=9)
        c1 = spgemm(a, backend="plan")
        c2 = spgemm_native(a, a)
        _close(c2, to_scipy(c1))

    def test_native_rectangular(self):
        import pytest as _pt

        from cask_tpu.native import available

        if not available():
            _pt.skip("no C++ toolchain")
        from cask_tpu.ops.spgemm import spgemm_native

        a = random_uniform(70, 110, density=0.06, seed=10)
        b = random_uniform(110, 50, density=0.06, seed=11)
        _close(spgemm_native(a, b), to_scipy(a) @ to_scipy(b))


class TestSparseAdd:
    def test_add_union(self):
        from cask_tpu.ops.add import sp_add

        a = random_uniform(60, 60, density=0.05, seed=30)
        b = random_uniform(60, 60, density=0.05, seed=31)
        c = sp_add(a, b, alpha=2.0, beta=-0.5)
        ref = 2.0 * to_scipy(a) - 0.5 * to_scipy(b)
        _close(c, ref)

    def test_plan_reuse(self):
        from cask_tpu.ops.add import add_plan

        a = random_uniform(50, 50, density=0.06, seed=32)
        b = random_uniform(50, 50, density=0.06, seed=33)
        plan = add_plan(a, b)
        c1 = plan.numeric(a.data, b.data)
        c2 = plan.numeric(np.asarray(a.data) * 3, b.data)
        _close(c1, to_scipy(a) + to_scipy(b))
        _close(c2, 3 * to_scipy(a) + to_scipy(b))

    def test_shift_identity(self):
        import scipy.sparse as sp

        from cask_tpu.ops.add import shift_identity

        a = power_law(80, avg_degree=4, seed=34)
        c = shift_identity(a, -2.5)
        ref = to_scipy(a) - 2.5 * sp.eye(80)
        _close(c, ref)


class TestPohNumeric:
    """The numeric phase on a held plan: values update without
    re-planning (the solver-pipeline mode)."""

    def test_aa_powerlaw_matches_scipy(self):
        a = power_law(300, avg_degree=5, seed=7, dtype=np.float32)
        plan = spgemm_plan(a, a)
        c = jax.jit(plan.numeric)(a.data, a.data)
        ref = (to_scipy(a) @ to_scipy(a)).tocsr()
        ref.sum_duplicates()
        d = abs(to_scipy(c) - ref)
        assert d.nnz == 0 or d.max() < 1e-4

    def test_ab_value_stream(self):
        # A static, B values change: numeric updates on one plan
        a = random_uniform(80, 120, density=0.05, seed=3, dtype=np.float32)
        b = random_uniform(120, 60, density=0.05, seed=4, dtype=np.float32)
        plan = spgemm_plan(a, b)
        for seed in (0, 1):
            bd = np.random.default_rng(seed).standard_normal(b.nnz).astype(np.float32)
            c = plan.numeric(np.asarray(a.data), bd)
            ref = (to_scipy(a) @ sp.csr_matrix(
                (bd, np.asarray(b.indices), np.asarray(b.indptr)), shape=b.shape)).tocsr()
            d = abs(to_scipy(c) - ref)
            assert d.nnz == 0 or d.max() < 1e-4

    def test_out_id_sorted(self):
        # the segment_sum hint in numeric() relies on this invariant
        a = power_law(200, avg_degree=6, seed=9)
        plan = spgemm_plan(a, a)
        assert (np.diff(plan.out_id) >= 0).all()
