"""Sparse matrix–vector product  y = A @ x  (and  y = Aᵀ @ x).

cask analog: the ``Spmv`` frontend object and its hardware kernels
(SURVEY.md §2 R2/R5).  Dispatch:

- ``method='xla'``   — gather + ``segment_sum`` formulation.  Every
  format, every platform; the correctness reference (BASELINE config 1
  runs this at f64).
- ``method='dia'``   — diagonal-packed shifted FMAs for banded/stencil
  matrices (see :mod:`cask_tpu.ops.dia`): no gathers, no index stream.
- ``method='bdia'``  — the block-diagonal twin for BSR/FEM matrices
  (see :mod:`cask_tpu.ops.bdia`).
- ``method='auto'``  — a cached DIA/BDIA plan where the structure
  qualifies and :mod:`cask_tpu.utils.platform` says the plan wins on this
  platform, the gather formulation otherwise.  The *tuned* path is
  :func:`cask_tpu.tune.tune`, which times variants per matrix and caches
  the winner by sparsity signature (cask's DSE analog).

All paths are jittable with the matrix as a pytree argument: static
metadata (shape, blocksize) is pytree aux data, so retracing happens per
sparsity structure, not per value — the analog of cask compiling one
bitstream per matrix class.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from cask_tpu.formats.matrix import BSR, COO, CSR

# f32 contractions stay f32: the GPU would otherwise run them in TF32
_HIGHEST = jax.lax.Precision.HIGHEST


def _accum_dtype(dtype, accum_dtype):
    if accum_dtype is not None:
        return jnp.dtype(accum_dtype)
    d = jnp.dtype(dtype)
    if d in (jnp.dtype(jnp.bfloat16), jnp.dtype(jnp.float16)):
        return jnp.dtype(jnp.float32)
    return d


def row_ids_from_indptr(indptr: jax.Array, nnz: int) -> jax.Array:
    """Expand CSR indptr into per-entry row ids, jit-compatibly.

    ``jnp.repeat`` with traced counts is shape-dynamic; instead use
    searchsorted: entry k belongs to the row whose indptr bracket holds k.
    """
    return (
        jnp.searchsorted(indptr, jnp.arange(nnz, dtype=indptr.dtype), side="right") - 1
    ).astype(jnp.int32)


# ---------------------------------------------------------------------------
# XLA formulations
# ---------------------------------------------------------------------------


def _spmv_xla_csr(a: CSR, x, transpose, accum_dtype):
    acc = _accum_dtype(a.dtype, accum_dtype)
    data = jnp.asarray(a.data)
    indices = jnp.asarray(a.indices)
    rows = row_ids_from_indptr(jnp.asarray(a.indptr), a.nnz)
    if not transpose:
        prod = (data * x[indices]).astype(acc)
        y = jax.ops.segment_sum(prod, rows, num_segments=a.shape[0], indices_are_sorted=True)
    else:
        prod = (data * x[rows]).astype(acc)
        y = jax.ops.segment_sum(prod, indices, num_segments=a.shape[1], indices_are_sorted=False)
    return y.astype(x.dtype) if jnp.dtype(x.dtype) == jnp.dtype(a.dtype) else y


def _spmv_xla_coo(a: COO, x, transpose, accum_dtype):
    acc = _accum_dtype(a.dtype, accum_dtype)
    data = jnp.asarray(a.data)
    row, col = jnp.asarray(a.row), jnp.asarray(a.col)
    if transpose:
        row, col = col, row
        m = a.shape[1]
    else:
        m = a.shape[0]
    prod = (data * x[col]).astype(acc)
    return jax.ops.segment_sum(prod, row, num_segments=m)


def _spmv_xla_bsr(a: BSR, x, transpose, accum_dtype):
    acc = _accum_dtype(a.dtype, accum_dtype)
    br, bc = a.blocksize
    pm, pn = a.padded_shape
    data = jnp.asarray(a.data)  # (nb, br, bc)
    indices = jnp.asarray(a.indices)
    brow = row_ids_from_indptr(jnp.asarray(a.indptr), a.n_blocks)
    if not transpose:
        xp = jnp.zeros(pn, dtype=x.dtype).at[: a.shape[1]].set(x)
        xb = xp.reshape(a.n_block_cols, bc)[indices]  # (nb, bc) — one gather per block
        part = jnp.einsum("kij,kj->ki", data, xb, preferred_element_type=acc,
                          precision=_HIGHEST)
        yb = jax.ops.segment_sum(part, brow, num_segments=a.n_block_rows, indices_are_sorted=True)
        return yb.reshape(pm)[: a.shape[0]]
    else:
        xp = jnp.zeros(pm, dtype=x.dtype).at[: a.shape[0]].set(x)
        xb = xp.reshape(a.n_block_rows, br)[brow]  # (nb, br)
        part = jnp.einsum("kij,ki->kj", data, xb, preferred_element_type=acc,
                          precision=_HIGHEST)
        yb = jax.ops.segment_sum(part, indices, num_segments=a.n_block_cols)
        return yb.reshape(pn)[: a.shape[1]]


def transposed(a):
    """The transpose of ``a`` in its own format/plan family, built ONCE.

    CSR/COO/BSR re-encode via :func:`cask_tpu.formats.convert.transpose`;
    plan types (DIA/BDIA) rebuild through their ``transpose_plan``.
    Iterating algorithms that apply both A and Aᵀ (CGLS, LSQR-style
    loops) should call this once up front instead of passing
    ``transpose=True`` per application, which re-encodes at every trace.
    """
    from cask_tpu.ops.bdia import BdiaMatrix
    from cask_tpu.ops.bdia import transpose_plan as _bdia_t
    from cask_tpu.ops.dia import DiaMatrix
    from cask_tpu.ops.dia import transpose_plan as _dia_t

    if isinstance(a, (CSR, COO, BSR)):
        from cask_tpu.formats.convert import transpose as _t

        return _t(a)
    if isinstance(a, DiaMatrix):
        return _dia_t(a)
    if isinstance(a, BdiaMatrix):
        return _bdia_t(a)
    raise TypeError(f"cannot transpose {type(a)}")


# ---------------------------------------------------------------------------
# public op
# ---------------------------------------------------------------------------

_PLAN_MISS = object()


def _memo_plan(a, attr: str, build):
    """Instance-memoized auto plan.

    Cache policy: the plan is built ONCE per matrix instance (host-side
    numpy planning) and memoized on the object, so repeat ``spmv(a, x)``
    calls — and every trace of a jitted caller holding the same matrix —
    reuse it without re-planning.  ``None`` is memoized too: a matrix
    whose diagonals don't qualify (>10 % of entries spilling to the
    scalar remainder) never re-pays the planning probe.  Never caches
    under a trace (host planning needs concrete arrays; a tracer result
    would poison later calls).
    """
    cached = getattr(a, attr, _PLAN_MISS)
    if cached is not _PLAN_MISS:
        return cached
    if isinstance(a.data, jax.core.Tracer):
        return None
    plan = build(a)
    object.__setattr__(a, attr, plan)
    return plan


def _build_bdia(a: BSR):
    from cask_tpu.ops.bdia import bdia_plan

    p = bdia_plan(a, a.blocksize)
    stored = max(a.nnz, 1)
    if p.vals.size <= 2 * stored and p.rem_data.shape[0] <= 0.1 * stored:
        return p
    return None


def _build_dia(a: CSR):
    from cask_tpu.ops.dia import dia_plan, estimate_dia_traffic

    if estimate_dia_traffic(a) is None:
        return None
    p = dia_plan(a)
    return p if p.rem_data.shape[0] <= 0.1 * max(a.nnz, 1) else None


def _bdia_auto_plan(a: BSR):
    """The BDIA plan the BSR auto route uses, or None (memoized)."""
    return _memo_plan(a, "_bdia_auto_plan", _build_bdia)


def _dia_auto_plan(a: CSR):
    """The DIA plan the banded-CSR auto route uses, or None (memoized)."""
    return _memo_plan(a, "_dia_auto_plan", _build_dia)


def auto_route(a, transpose: bool = False, accum_dtype=None):
    """The plan ``method='auto'`` runs ``a`` through, or None for the
    gather formulation: a DIA plan for banded CSR, a BDIA plan for BSR,
    where :func:`cask_tpu.utils.platform.auto_plan` enables it."""
    from cask_tpu.utils import platform

    if transpose or accum_dtype is not None:
        return None
    if isinstance(a, CSR) and platform.auto_plan("dia"):
        return _dia_auto_plan(a)
    if isinstance(a, BSR) and platform.auto_plan("bdia"):
        return _bdia_auto_plan(a)
    return None


def spmv(a, x, *, transpose: bool = False, method: str = "auto",
         accum_dtype: Optional[object] = None):
    """``y = a @ x`` (or ``aᵀ @ x``).  See module docstring for methods."""
    x = jnp.asarray(x)
    if x.ndim != 1:
        raise ValueError(f"x must be 1-D, got shape {x.shape}")
    n_expect = a.shape[0] if transpose else a.shape[1]
    if x.shape[0] != n_expect:
        raise ValueError(f"dimension mismatch: A {a.shape} (transpose={transpose}) vs x {x.shape}")

    if method == "dia":
        from cask_tpu.ops.dia import spmv_dia

        return spmv_dia(a, x, transpose=transpose)
    if method == "bdia":
        from cask_tpu.ops.bdia import bdia_plan

        if transpose:
            from cask_tpu.formats.convert import transpose as _t

            a = _t(a)  # BSR transposes in place; blocksize swaps with it
        return bdia_plan(a, getattr(a, "blocksize", None)).spmv(x)
    if method not in ("auto", "xla"):
        raise ValueError(f"unknown spmv method {method!r}")

    if isinstance(a, (CSR, BSR)) and method == "auto":
        plan = auto_route(a, transpose, accum_dtype)
        if plan is not None:
            return plan.spmv(x)
    if isinstance(a, CSR):
        return _spmv_xla_csr(a, x, transpose, accum_dtype)
    if isinstance(a, COO):
        return _spmv_xla_coo(a, x, transpose, accum_dtype)
    if isinstance(a, BSR):
        return _spmv_xla_bsr(a, x, transpose, accum_dtype)
    from cask_tpu.ops.bdia import BdiaMatrix
    from cask_tpu.ops.dia import DiaMatrix, spmv_dia

    if isinstance(a, BdiaMatrix):
        if transpose:
            from cask_tpu.ops.bdia import transpose_plan as _bdia_t

            a = _bdia_t(a)  # one-time host rebuild; hold the plan to reuse
        return a.spmv(x)
    if isinstance(a, DiaMatrix):
        return spmv_dia(a, x, transpose=transpose)
    raise TypeError(f"unsupported matrix type {type(a)}")
