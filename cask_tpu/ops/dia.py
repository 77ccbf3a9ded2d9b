"""Diagonal-packed (DIA/HYB) SpMV & SpMM for banded and stencil matrices.

cask's hardware SpMV streamed the matrix through parallel pipes while the
x vector sat in an on-chip BRAM cache (SURVEY.md §2 R5).  The analog
here: pack the matrix's populated *diagonals* into a dense
(ndiags, m) value array that streams from device memory once, while x
is re-read from cache; each diagonal contributes a *shifted* elementwise
FMA — no gathers and no index stream at all.  XLA fuses the whole
shifted-FMA loop into one pass over the values.

Matrices rarely are purely banded, so this is a HYB scheme: diagonals
below a density threshold spill their entries to a COO *remainder*
handled by the gather + segment-sum formulation and added in.  The
autotuner decides when the split wins (its traffic model is
:func:`estimate_dia_traffic`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cask_tpu.formats.matrix import CSR


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DiaMatrix:
    """Diagonal-packed matrix plus COO remainder (HYB).

    ``vals[d, r]`` is entry ``A[r, r + offsets[d]]`` (0 outside bounds).
    ``offsets`` is static metadata so XLA sees the shift amounts as
    constants.
    """

    vals: jax.Array  # (ndiags, m)
    rem_data: jax.Array  # (nrem,) remainder values (may be size 0)
    rem_row: jax.Array  # (nrem,) int32
    rem_col: jax.Array  # (nrem,) int32
    offsets: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))

    @property
    def ndiags(self) -> int:
        return len(self.offsets)

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def traffic_bytes(self) -> int:
        """Device-memory bytes per SpMV: the streamed values + remainder."""
        db = jnp.dtype(self.vals.dtype).itemsize
        return int(self.vals.size * db + self.rem_data.shape[0] * (db + 8))

    def device_put(self, device=None) -> "DiaMatrix":
        return jax.tree.map(lambda x: jax.device_put(x, device), self)

    def astype(self, dtype) -> "DiaMatrix":
        """Value-dtype cast (plan structure unchanged) — what
        :func:`cask_tpu.solvers.ir_solve` uses to build its
        low-precision working copy."""
        return dataclasses.replace(
            self, vals=self.vals.astype(dtype),
            rem_data=self.rem_data.astype(dtype))

    # -- compute ---------------------------------------------------------

    def _padded_x(self, x):
        """x with zeros around it, so every diagonal's shifted window is
        one static slice of length m."""
        m, n = self.shape
        lo = -min(min(self.offsets), 0)
        hi = max(max(self.offsets), 0)
        pad = [(lo, max(m + hi - n, 0))] + [(0, 0)] * (x.ndim - 1)
        return lo, jnp.pad(x, pad)

    def spmv(self, x):
        """One shifted FMA per diagonal over a zero-padded x."""
        m = self.shape[0]
        x = jnp.asarray(x)
        lo, xp = self._padded_x(x)
        y = jnp.zeros(m, dtype=jnp.result_type(self.vals.dtype, x.dtype))
        for d, off in enumerate(self.offsets):
            y = y + self.vals[d] * xp[lo + off : lo + off + m]
        if self.rem_data.shape[0]:
            y = y + self._remainder(x)
        return y

    def spmm(self, x):
        m = self.shape[0]
        x = jnp.asarray(x)
        lo, xp = self._padded_x(x)
        y = jnp.zeros((m, x.shape[1]),
                      dtype=jnp.result_type(self.vals.dtype, x.dtype))
        for d, off in enumerate(self.offsets):
            y = y + self.vals[d][:, None] * xp[lo + off : lo + off + m]
        if self.rem_data.shape[0]:
            y = y + self._remainder(x)
        return y

    def _remainder(self, x):
        data = self.rem_data if x.ndim == 1 else self.rem_data[:, None]
        return jax.ops.segment_sum(data * x[self.rem_col], self.rem_row,
                                   num_segments=self.shape[0])


class DiaOperator:
    """Solver-facing SpMV operator over a DIA plan.

    The plan is built once, so a Krylov loop applies A as one fused
    shifted-FMA pass per iteration.  ``to_padded``/``from_padded`` are
    identities, kept so solver code is uniform with the distributed
    operators::

        op = DiaOperator(dia)                    # or DiaOperator(csr)
        res = cg(op, op.to_padded(b))
        x = op.from_padded(res.x)
    """

    def __init__(self, a):
        if isinstance(a, CSR):
            a = dia_plan(a)
        self.dia = a

    def to_padded(self, v):
        return jnp.asarray(v)

    def from_padded(self, v):
        return v

    def __call__(self, v):
        return self.dia.spmv(v)


def solver_operator(a):
    """SpMV operator for iterative solves over a DIA plan of ``a``.

    Returns an object with ``to_padded`` / ``from_padded`` / ``__call__``,
    so solver code is uniform::

        op = cask_tpu.solver_operator(a)
        res = cask_tpu.solvers.cg(op, op.to_padded(b))
        x = op.from_padded(res.x)
    """
    return DiaOperator(a)


def dia_plan(a: CSR, *, min_density: float = 0.10,
             max_diags: int = 1024) -> DiaMatrix:
    """Pack ``a``'s dense-enough diagonals; spill the rest to COO.

    ``min_density``: keep a diagonal if it holds ≥ this fraction of its
    maximum possible entries — below that, streaming the padded diagonal
    moves more bytes than the COO fallback would.
    """
    m, n = a.shape
    indptr = np.asarray(a.indptr, dtype=np.int64)
    indices = np.asarray(a.indices, dtype=np.int64)
    data = np.asarray(a.data)
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(indptr))
    offs = indices - rows

    uniq, counts = np.unique(offs, return_counts=True)
    diag_len = np.minimum(np.minimum(m, n - uniq), np.minimum(n, m + uniq))
    density = counts / np.maximum(diag_len, 1)
    keep = density >= min_density
    if keep.sum() > max_diags:
        top = np.argsort(-counts)[:max_diags]
        keep = np.zeros_like(keep)
        keep[top] = True
    kept_offsets = uniq[keep]

    in_dia = np.isin(offs, kept_offsets)

    vals = np.zeros((max(len(kept_offsets), 1), m), dtype=data.dtype)
    if len(kept_offsets):
        d_ids = np.searchsorted(kept_offsets, offs[in_dia])
        vals[d_ids, rows[in_dia]] = data[in_dia]
        offsets = tuple(int(o) for o in kept_offsets)
    else:
        offsets = (0,)

    rem = ~in_dia
    return DiaMatrix(
        vals=jnp.asarray(vals),
        rem_data=jnp.asarray(data[rem]),
        rem_row=jnp.asarray(rows[rem].astype(np.int32)),
        rem_col=jnp.asarray(indices[rem].astype(np.int32)),
        offsets=offsets,
        shape=(m, n),
    )


def estimate_dia_traffic(a: CSR, *, min_density: float = 0.10,
                         max_diags: int = 1024) -> Optional[float]:
    """Analytic prefilter for the tuner: streamed entries per SpMV under
    the DIA split, or None when the split is clearly unprofitable."""
    m, n = a.shape
    indptr = np.asarray(a.indptr, dtype=np.int64)
    indices = np.asarray(a.indices, dtype=np.int64)
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(indptr))
    offs = indices - rows
    uniq, counts = np.unique(offs, return_counts=True)
    diag_len = np.minimum(np.minimum(m, n - uniq), np.minimum(n, m + uniq))
    density = counts / np.maximum(diag_len, 1)
    keep = density >= min_density
    if keep.sum() > max_diags:
        keep &= counts >= np.sort(counts[keep])[-max_diags]
    dia_entries = int(keep.sum()) * m
    rem_entries = int(counts[~keep].sum())
    covered = counts[keep].sum() / max(a.nnz, 1)
    if covered < 0.5:  # mostly remainder → DIA adds no value
        return None
    return dia_entries + rem_entries * 3.0  # remainder entries cost ~3x (idx+scatter)


# Conveniences used by cask_tpu.ops.spmv/spmm dispatch -----------------------


def transpose_plan(a: DiaMatrix) -> DiaMatrix:
    """Plan for ``Aᵀ``: diagonal d of A at offset k is diagonal of Aᵀ at
    offset −k, with values shifted along the diagonal by k.

    ``Aᵀ[r, r−k] = A[r−k, r]`` ⇒ ``valsᵀ[d', r] = vals[d, r − k]``.
    Host-side one-time shuffle (numpy), like every other plan build.
    """
    m, n = a.shape
    vals = np.asarray(a.vals)
    new_vals = np.zeros((vals.shape[0], n), vals.dtype)
    r = np.arange(n)
    for d, off in enumerate(a.offsets):
        src = r - off
        ok = (src >= 0) & (src < m)
        new_vals[d, r[ok]] = vals[d, src[ok]]
    return DiaMatrix(
        vals=jnp.asarray(new_vals),
        rem_data=a.rem_data,
        rem_row=a.rem_col,
        rem_col=a.rem_row,
        offsets=tuple(-off for off in a.offsets),
        shape=(n, m),
    )


def spmv_dia(a, x, *, transpose: bool = False):
    if isinstance(a, CSR):
        a = dia_plan(a)
    if not isinstance(a, DiaMatrix):
        raise TypeError(f"spmv_dia needs CSR or DiaMatrix, got {type(a)}")
    if transpose:
        a = transpose_plan(a)
    return a.spmv(x)


def spmm_dia(a, x, *, transpose: bool = False):
    if isinstance(a, CSR):
        a = dia_plan(a)
    if not isinstance(a, DiaMatrix):
        raise TypeError(f"spmm_dia needs CSR or DiaMatrix, got {type(a)}")
    if transpose:
        a = transpose_plan(a)
    return a.spmm(x)
