"""Sparse × dense matrix product  Y = A @ X  with tall-skinny X (n, k).

BASELINE config 3: k ∈ {32, 128}, CSR + BSR, bandwidth-roofline bench.
The gather formulations here are the reference; ``method='auto'`` takes
the same cached DIA/BDIA plan as :func:`cask_tpu.ops.spmv.spmv` where
the platform's route enables it.  cask analog: dense-multiple SpMV in
the Spmv frontend (SURVEY.md §2 R2).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from cask_tpu.formats.matrix import BSR, COO, CSR
from cask_tpu.ops.spmv import _HIGHEST, _accum_dtype, auto_route, row_ids_from_indptr


def _spmm_xla_csr(a: CSR, x, transpose, accum_dtype):
    acc = _accum_dtype(a.dtype, accum_dtype)
    data = jnp.asarray(a.data)
    indices = jnp.asarray(a.indices)
    rows = row_ids_from_indptr(jnp.asarray(a.indptr), a.nnz)
    if not transpose:
        prod = (data[:, None] * x[indices]).astype(acc)  # (nnz, k)
        return jax.ops.segment_sum(prod, rows, num_segments=a.shape[0], indices_are_sorted=True)
    else:
        prod = (data[:, None] * x[rows]).astype(acc)
        return jax.ops.segment_sum(prod, indices, num_segments=a.shape[1])


def _spmm_xla_coo(a: COO, x, transpose, accum_dtype):
    acc = _accum_dtype(a.dtype, accum_dtype)
    data = jnp.asarray(a.data)
    row, col = jnp.asarray(a.row), jnp.asarray(a.col)
    if transpose:
        row, col, m = col, row, a.shape[1]
    else:
        m = a.shape[0]
    prod = (data[:, None] * x[col]).astype(acc)
    return jax.ops.segment_sum(prod, row, num_segments=m)


def _spmm_xla_bsr(a: BSR, x, transpose, accum_dtype):
    acc = _accum_dtype(a.dtype, accum_dtype)
    br, bc = a.blocksize
    pm, pn = a.padded_shape
    k = x.shape[1]
    data = jnp.asarray(a.data)
    indices = jnp.asarray(a.indices)
    brow = row_ids_from_indptr(jnp.asarray(a.indptr), a.n_blocks)
    if not transpose:
        xp = jnp.zeros((pn, k), dtype=x.dtype).at[: a.shape[1]].set(x)
        xb = xp.reshape(a.n_block_cols, bc, k)[indices]  # (nb, bc, k)
        part = jnp.einsum("kij,kjl->kil", data, xb, preferred_element_type=acc,
                          precision=_HIGHEST)
        yb = jax.ops.segment_sum(part, brow, num_segments=a.n_block_rows, indices_are_sorted=True)
        return yb.reshape(pm, k)[: a.shape[0]]
    else:
        xp = jnp.zeros((pm, k), dtype=x.dtype).at[: a.shape[0]].set(x)
        xb = xp.reshape(a.n_block_rows, br, k)[brow]
        part = jnp.einsum("kij,kil->kjl", data, xb, preferred_element_type=acc,
                          precision=_HIGHEST)
        yb = jax.ops.segment_sum(part, indices, num_segments=a.n_block_cols)
        return yb.reshape(pn, k)[: a.shape[1]]


def spmm(a, x, *, transpose: bool = False, method: str = "auto",
         accum_dtype: Optional[object] = None):
    """``Y = a @ X`` (or ``aᵀ @ X``) with dense ``X`` of shape (n, k)."""
    x = jnp.asarray(x)
    if x.ndim != 2:
        raise ValueError(f"X must be 2-D, got shape {x.shape}")
    n_expect = a.shape[0] if transpose else a.shape[1]
    if x.shape[0] != n_expect:
        raise ValueError(f"dimension mismatch: A {a.shape} (transpose={transpose}) vs X {x.shape}")

    if method == "dia":
        from cask_tpu.ops.dia import spmm_dia

        return spmm_dia(a, x, transpose=transpose)
    if method not in ("auto", "xla"):
        raise ValueError(f"unknown spmm method {method!r}")

    if isinstance(a, (CSR, BSR)) and method == "auto":
        # one cached plan per instance serves spmv and spmm alike
        plan = auto_route(a, transpose, accum_dtype)
        if plan is not None:
            return plan.spmm(x)
    if isinstance(a, CSR):
        return _spmm_xla_csr(a, x, transpose, accum_dtype)
    if isinstance(a, COO):
        return _spmm_xla_coo(a, x, transpose, accum_dtype)
    if isinstance(a, BSR):
        return _spmm_xla_bsr(a, x, transpose, accum_dtype)
    from cask_tpu.ops.bdia import BdiaMatrix, transpose_plan as _bdia_t
    from cask_tpu.ops.dia import DiaMatrix, spmm_dia

    if isinstance(a, DiaMatrix):
        return spmm_dia(a, x, transpose=transpose)
    if isinstance(a, BdiaMatrix):
        if transpose:
            a = _bdia_t(a)  # one-time host rebuild; hold the plan to reuse
        return a.spmm(x)
    raise TypeError(f"unsupported matrix type {type(a)}")

