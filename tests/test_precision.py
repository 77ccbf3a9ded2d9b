"""Every f32 contraction on the main path asks for HIGHEST precision, so
a GPU never runs it in TF32 (three decimal digits)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cask_tpu.formats.convert import csr_to_bsr
from cask_tpu.formats.generate import fem_blocks, stencil_2d

HIGHEST = jax.lax.Precision.HIGHEST


def _contractions(jaxpr):
    """Precision of every matrix-level dot_general (an operand of rank
    ≥ 2; vector inner products are reductions, not tensor-core work),
    sub-jaxprs included."""
    jaxpr = getattr(jaxpr, "jaxpr", jaxpr)
    out = []
    for eqn in jaxpr.eqns:
        if (eqn.primitive.name == "dot_general"
                and max(v.aval.ndim for v in eqn.invars) >= 2):
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if hasattr(sub, "eqns") or hasattr(sub, "jaxpr"):
                    out += _contractions(sub)
    return out


def _assert_highest(fn, *args):
    precs = _contractions(jax.make_jaxpr(fn)(*args))
    assert precs, "expected at least one contraction"
    for p in precs:
        assert p is not None and all(q == HIGHEST for q in p), p


A32 = stencil_2d(12, dtype=np.float32)
F32 = fem_blocks(4, dof=4, dtype=np.float32)


def _bsr():
    return csr_to_bsr(F32, (4, 4))


@pytest.mark.parametrize("transpose", [False, True])
def test_bsr_spmv(transpose):
    from cask_tpu.ops.spmv import spmv

    b = _bsr()
    _assert_highest(lambda x: spmv(b, x, method="xla", transpose=transpose),
                    jnp.ones(F32.shape[0], jnp.float32))


@pytest.mark.parametrize("transpose", [False, True])
def test_bsr_spmm(transpose):
    from cask_tpu.ops.spmm import spmm

    b = _bsr()
    _assert_highest(lambda x: spmm(b, x, method="xla", transpose=transpose),
                    jnp.ones((F32.shape[0], 8), jnp.float32))


def test_block_jacobi():
    from cask_tpu.solvers.precond import block_jacobi

    M = block_jacobi(A32, block=16)
    _assert_highest(M, jnp.ones(A32.shape[0], jnp.float32))


def test_lanczos_reorthogonalization(monkeypatch):
    # the Lanczos scan is jitted inside the call: capture its jaxpr there
    from cask_tpu.solvers.precond import lanczos_extremal

    real_jit, traced = jax.jit, []

    def recording_jit(f):
        def run(*args):
            traced.append(jax.make_jaxpr(f)(*args))
            return real_jit(f)(*args)
        return run

    monkeypatch.setattr(jax, "jit", recording_jit)
    lanczos_extremal(A32.device_put(), A32.shape[0], iters=6)
    monkeypatch.undo()
    assert len(traced) == 1
    precs = _contractions(traced[0])
    assert precs and all(all(q == HIGHEST for q in p) for p in precs)


def test_block_cg():
    from cask_tpu.solvers import block_cg

    a = A32.device_put()
    _assert_highest(lambda b: block_cg(a, b, maxiter=3).x,
                    jnp.ones((A32.shape[0], 4), jnp.float32))


def test_gmres():
    from cask_tpu.solvers import gmres

    a = A32.device_put()
    _assert_highest(lambda b: gmres(a, b, maxiter=2, restart=4).x,
                    jnp.ones(A32.shape[0], jnp.float32))


def test_amg_dense_levels():
    from cask_tpu.solvers import smoothed_aggregation_amg

    M = smoothed_aggregation_amg(stencil_2d(24), dtype=np.float32)
    _assert_highest(M, jnp.ones(576, jnp.float32))


def test_lobpcg():
    from cask_tpu.solvers import lobpcg

    a = A32.device_put()
    x0 = np.random.default_rng(0).standard_normal((A32.shape[0], 3)).astype(np.float32)
    _assert_highest(lambda x: lobpcg(a, x, maxiter=2).theta, jnp.asarray(x0))
