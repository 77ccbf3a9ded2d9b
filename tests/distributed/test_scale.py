"""Config-5-scale check: ≥10M-row row-partitioned SpMV on 8 virtual devices.

The slim variant runs in every CI round (VERDICT r1 item 7): the
partition plan is built formulaically (no 50M-entry CSR materialization)
and validated against an independent device-side construction, plus
three distributed CG iterations.  The full CSR-driven version (a minute
of numpy) stays behind CASK_TPU_SLOW=1.
"""

import os

import numpy as np
import pytest


class TestSlim10M:
    """Runs un-gated every round (~15 s on 8 virtual CPU devices)."""

    SIDE = 3240  # 10.49M rows

    def test_parity_with_partition_dia_small(self):
        # the formulaic plan is bit-identical to the CSR-driven one
        from cask_tpu.formats.generate import stencil_2d
        from cask_tpu.parallel import partition_dia, stencil_dia_partition

        a = stencil_2d(40, dtype=np.float32)
        p1 = partition_dia(a, 4)
        p2 = stencil_dia_partition(40, nshards=4)
        assert p1.offsets == p2.offsets and p1.mloc == p2.mloc
        np.testing.assert_array_equal(np.asarray(p1.vals), np.asarray(p2.vals))
        assert p1.remainder is None or p1.remainder.int_data.size == 0

    def test_10m_row_distributed_spmv(self):
        from cask_tpu.formats.device_gen import stencil2d_dia_device
        from cask_tpu.parallel import DistSpmv, row_mesh, stencil_dia_partition

        plan = stencil_dia_partition(self.SIDE, nshards=8)
        assert plan.shape[0] >= 10_000_000
        op = DistSpmv(plan, row_mesh(8))
        rng = np.random.default_rng(0)
        x = rng.standard_normal(plan.shape[1]).astype(np.float32)
        y = np.asarray(op(x))
        # independent reference: the single-device DIA XLA formulation
        ref = np.asarray(stencil2d_dia_device(self.SIDE, dtype=np.float32).spmv(x))
        err = np.abs(y - ref).max() / np.abs(ref).max()
        assert err < 1e-5

    def test_10m_row_distributed_cg_iterations(self):
        # 3 CG iterations through the ring-halo operator (not a full
        # solve): exercises the solver-side distributed path at scale
        import jax.numpy as jnp

        from cask_tpu.parallel import DistSpmv, row_mesh, stencil_dia_partition
        from cask_tpu.solvers import cg

        plan = stencil_dia_partition(self.SIDE, nshards=8)
        op = DistSpmv(plan, row_mesh(8))
        n = plan.shape[0]
        # consistent RHS (b = A·x*): avoids the Laplacian's near-null
        # ones-direction, where early CG residuals legitimately spike
        rng = np.random.default_rng(1)
        b = op(jnp.asarray(rng.standard_normal(n).astype(np.float32)))
        res = cg(op, b, tol=0.0, maxiter=3)
        assert int(res.iterations) == 3
        assert np.isfinite(float(res.residual_norm))
        assert float(res.residual_norm) < float(jnp.linalg.norm(b))


@pytest.mark.skipif(os.environ.get("CASK_TPU_SLOW") != "1",
                    reason="set CASK_TPU_SLOW=1")
def test_10m_row_distributed_spmv_full_csr():
    """The original CSR-driven build (slow numpy path), scipy-checked."""
    from cask_tpu.formats.convert import to_scipy
    from cask_tpu.formats.generate import stencil_2d
    from cask_tpu.parallel import DistSpmv, partition_dia, row_mesh

    side = 3240
    a = stencil_2d(side, dtype=np.float32)
    assert a.shape[0] >= 10_000_000
    plan = partition_dia(a, 8)
    op = DistSpmv(plan, row_mesh(8))
    rng = np.random.default_rng(0)
    x = rng.standard_normal(a.shape[1]).astype(np.float32)
    y = np.asarray(op(x))
    ref = to_scipy(a) @ x
    err = np.abs(y - ref).max() / np.abs(ref).max()
    assert err < 1e-5
