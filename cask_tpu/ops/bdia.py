"""Block-diagonal-packed (BDIA) SpMV & SpMM — the fast BSR path.

The scalar DIA format (:mod:`cask_tpu.ops.dia`) streams banded matrices
with no index traffic, but dof-expanded FEM/block matrices defeat it: a
``b×b``-blocked band expands to ``(2b−1)`` scalar diagonals per block
offset, each only ``b/(2b−1)`` dense (57 % for b=4), so ~43 % of the
streamed bytes are structural-zero fill.  BDIA removes the fill with a
block-aware de-interleave — the analog of cask's multi-pipe stream
partitioning (SURVEY.md §2 R5), applied at dof granularity:

- **x** is split by block *component*: ``x_c = x[c::bc]`` (length = block
  columns), each an independent contiguous segment.
- **y** likewise by block row component: ``y_r = y[r::br]``.
- a block diagonal at block offset ``d`` contributes, for every ``(r,c)``
  element position, one **full-density** diagonal over the block index:
  ``y_r[i] += A_{d}[i][r,c] · x_c[i+d]``.

Every term is a shifted elementwise FMA exactly like scalar DIA — zero
gathers, zero fill: the value stream is exactly the stored block
entries, and XLA fuses the loop over pairs into one pass.  Blocks on
sparse block diagonals spill to a scalar COO remainder (HYB discipline,
same as DIA).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from cask_tpu.formats.matrix import BSR, CSR

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BdiaMatrix:
    """Block-diagonal-packed matrix plus scalar COO remainder.

    ``vals[r, j, i]`` is the ``(r, c)`` element of the block at block row
    ``i`` on block offset ``d``, where ``j = dpos·bc + c`` enumerates the
    static ``pairs`` (block offset × column component).  Each
    ``vals[r, j]`` is one full-density diagonal over the block index.
    """

    vals: jax.Array  # (br, npairs, nbr)
    rem_data: jax.Array  # scalar COO remainder (may be size 0)
    rem_row: jax.Array
    rem_col: jax.Array
    block_offsets: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    blocksize: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))

    # -- geometry ---------------------------------------------------------

    @property
    def nbr(self) -> int:
        br = self.blocksize[0]
        return -(-self.shape[0] // br)

    @property
    def nbc(self) -> int:
        bc = self.blocksize[1]
        return -(-self.shape[1] // bc)

    @property
    def npairs(self) -> int:
        return int(self.vals.shape[1])

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def lo(self) -> int:
        return -min(min(self.block_offsets), 0)

    @property
    def hi(self) -> int:
        return max(max(self.block_offsets), 0)

    @property
    def pairs(self) -> Tuple[Tuple[int, int], ...]:
        """Static (c, d) per vals slot j — the unrolled FMA schedule."""
        bc = self.blocksize[1]
        return tuple(
            (c, d) for d in self.block_offsets for c in range(bc)
        )

    @property
    def traffic_bytes(self) -> int:
        db = jnp.dtype(self.vals.dtype).itemsize
        return int(self.vals.size * db + self.rem_data.shape[0] * (db + 8))

    def device_put(self, device=None) -> "BdiaMatrix":
        return jax.tree.map(lambda x: jax.device_put(x, device), self)

    def astype(self, dtype) -> "BdiaMatrix":
        return dataclasses.replace(
            self, vals=self.vals.astype(dtype), rem_data=self.rem_data.astype(dtype)
        )

    # -- compute ----------------------------------------------------------

    def _components(self, x):
        """``(bc, lo + nbr + hi, ...)``: x split by block column component
        and zero-padded so every pair's shifted window is one static
        slice of length nbr."""
        bc = self.blocksize[1]
        rest = x.shape[1:]
        xb = jnp.pad(x, [(0, self.nbc * bc - x.shape[0])] + [(0, 0)] * len(rest))
        xc = jnp.moveaxis(xb.reshape((self.nbc, bc) + rest), 1, 0)
        pad = [(0, 0), (self.lo, max(self.nbr + self.hi - self.nbc, 0))]
        return jnp.pad(xc, pad + [(0, 0)] * len(rest))

    def _acc_dtype(self, x):
        acc_t = jnp.promote_types(self.vals.dtype, x.dtype)
        if jnp.bfloat16 in (self.vals.dtype, x.dtype):
            acc_t = jnp.promote_types(acc_t, jnp.float32)
        return acc_t

    def spmv(self, x):
        """``y = A x``: the banded kernel where the platform's route
        enables it (:func:`cask_tpu.utils.platform.kernel`), the XLA
        formulation otherwise.  ``x`` may be an (n, k) block (SpMM),
        which always takes the XLA formulation."""
        from cask_tpu.utils import platform

        x = jnp.asarray(x)
        if x.ndim != 1 or not platform.kernel("bdia"):
            return self._xla(x)
        from cask_tpu.ops.banded_kernel import banded_spmv

        y = banded_spmv(self.vals, x, pairs=self.pairs,
                        blocksize=self.blocksize, shape=self.shape)
        if self.rem_data.shape[0]:
            y = y + jax.ops.segment_sum(self.rem_data * x[self.rem_col],
                                        self.rem_row, num_segments=self.shape[0])
        return y

    def spmm(self, x):
        return self._xla(jnp.asarray(x))

    def _xla(self, x):
        """``y_r[i] += vals[r, j, i] · x_c[i + d]`` for every pair
        ``j = (c, d)``: shifted FMAs over component planes, which XLA
        fuses into one pass over the values."""
        br = self.blocksize[0]
        m = self.shape[0]
        nbr, lo = self.nbr, self.lo
        xp = self._components(x)
        acc_t = self._acc_dtype(x)
        rest = x.shape[1:]
        y = jnp.zeros((br, nbr) + rest, dtype=acc_t)
        for j, (c, d) in enumerate(self.pairs):
            v = self.vals[:, j, :].astype(acc_t)
            if rest:
                v = v[..., None]
            y = y + v * xp[c, lo + d : lo + d + nbr].astype(acc_t)
        out = jnp.moveaxis(y, 0, 1).reshape((nbr * br,) + rest)[:m]
        if self.rem_data.shape[0]:
            data = self.rem_data if not rest else self.rem_data[:, None]
            out = out + jax.ops.segment_sum(
                data * x[self.rem_col], self.rem_row, num_segments=m)
        return out


class BdiaOperator:
    """Solver-facing SpMV operator over a BDIA plan — the BDIA twin of
    :class:`cask_tpu.ops.dia.DiaOperator` (identity paddings)."""

    def __init__(self, a, blocksize=None):
        if not isinstance(a, BdiaMatrix):
            a = bdia_plan(a, blocksize)
        self.bdia = a

    def to_padded(self, v):
        return jnp.asarray(v)

    def from_padded(self, v):
        return v

    def __call__(self, v):
        return self.bdia.spmv(v)


def bdia_plan(a: Union[BSR, CSR], blocksize: Optional[Tuple[int, int]] = None,
              *, min_density: float = 0.10, max_block_diags: int = 64) -> BdiaMatrix:
    """Pack a block matrix's dense-enough block diagonals; spill the rest
    to a scalar COO remainder (HYB discipline, like :func:`dia_plan`)."""
    if isinstance(a, CSR):
        if blocksize is None:
            raise ValueError("bdia_plan on CSR needs an explicit blocksize")
        from cask_tpu.formats.convert import csr_to_bsr

        a = csr_to_bsr(a, blocksize)
    br, bc = a.blocksize
    m, n = a.shape
    nbr, nbc = a.n_block_rows, a.n_block_cols
    indptr = np.asarray(a.indptr, dtype=np.int64)
    indices = np.asarray(a.indices, dtype=np.int64)
    data = np.asarray(a.data)
    ib = np.repeat(np.arange(nbr, dtype=np.int64), np.diff(indptr))
    d = indices - ib

    uniq, counts = np.unique(d, return_counts=True)
    diag_len = np.minimum(np.minimum(nbr, nbc - uniq), np.minimum(nbc, nbr + uniq))
    density = counts / np.maximum(diag_len, 1)
    keep = density >= min_density
    if keep.sum() > max_block_diags:
        top = np.argsort(-counts)[:max_block_diags]
        keep = np.zeros_like(keep)
        keep[top] = True
    kept = uniq[keep]
    if len(kept) == 0:
        kept = np.array([0], dtype=np.int64)
    in_dia = np.isin(d, kept)

    npairs = len(kept) * bc
    vals = np.zeros((br, npairs, nbr), dtype=data.dtype)

    kb = np.nonzero(in_dia)[0]
    if kb.size:
        dpos = np.searchsorted(kept, d[kb])
        c_rng = np.arange(bc)
        vals[:, dpos[:, None] * bc + c_rng[None, :], ib[kb][:, None]] = \
            data[kb].transpose(1, 0, 2)

    # spill remainder blocks to scalar COO triples
    rb = np.nonzero(~in_dia)[0]
    if rb.size:
        ri = ib[rb]
        rj = indices[rb]
        rr = (ri[:, None, None] * br + np.arange(br)[None, :, None])
        rc = (rj[:, None, None] * bc + np.arange(bc)[None, None, :])
        rr = np.broadcast_to(rr, (rb.size, br, bc)).ravel()
        rc = np.broadcast_to(rc, (rb.size, br, bc)).ravel()
        rv = data[rb].ravel()
        inside = (rr < m) & (rc < n) & (rv != 0)
        rem_data, rem_row, rem_col = rv[inside], rr[inside], rc[inside]
    else:
        rem_data = np.zeros((0,), data.dtype)
        rem_row = np.zeros((0,), np.int32)
        rem_col = np.zeros((0,), np.int32)

    return BdiaMatrix(
        vals=jnp.asarray(vals),
        rem_data=jnp.asarray(rem_data),
        rem_row=jnp.asarray(rem_row.astype(np.int32)),
        rem_col=jnp.asarray(rem_col.astype(np.int32)),
        block_offsets=tuple(int(o) for o in kept),
        shape=(m, n),
        blocksize=(br, bc),
    )


def bdia_to_coo(a: BdiaMatrix):
    """Host-side scalar triples of the packed matrix (plan introspection
    and transpose builds).  Structural zeros in stored blocks drop out —
    they carry no value and re-form at the next ``bdia_plan``."""
    from cask_tpu.formats.matrix import COO

    br, bc = a.blocksize
    m, n = a.shape
    vflat = np.asarray(a.vals)[:, :, : a.nbr]
    r_i, j_i, i_i = np.nonzero(vflat)
    offs = np.asarray(a.block_offsets, dtype=np.int64)
    d = offs[j_i // bc]
    rows = i_i * br + r_i
    cols = (i_i + d) * bc + (j_i % bc)
    vals = vflat[r_i, j_i, i_i]
    ok = (rows < m) & (cols >= 0) & (cols < n)
    rows = np.concatenate([rows[ok], np.asarray(a.rem_row, np.int64)])
    cols = np.concatenate([cols[ok], np.asarray(a.rem_col, np.int64)])
    vals = np.concatenate([vals[ok], np.asarray(a.rem_data)])
    return COO(data=vals, row=rows.astype(np.int32),
               col=cols.astype(np.int32), shape=(m, n))


def transpose_plan(a: BdiaMatrix, *, min_density: float = 0.10,
                   max_block_diags: int = 64) -> BdiaMatrix:
    """Plan for ``Aᵀ``: block offsets negate, blocks transpose, the
    blocksize swaps.  A host-side one-time rebuild, exactly like
    :func:`cask_tpu.ops.dia.transpose_plan` — build once and reuse;
    iterating callers should hold both plans, not transpose per op."""
    from cask_tpu.formats.convert import coo_to_csr
    from cask_tpu.formats.matrix import COO

    coo = bdia_to_coo(a)
    coo_t = COO(data=coo.data, row=coo.col, col=coo.row,
                shape=(coo.shape[1], coo.shape[0]))
    br, bc = a.blocksize
    return bdia_plan(coo_to_csr(coo_t), (bc, br), min_density=min_density,
                     max_block_diags=max_block_diags)


def estimate_bdia_traffic(a: CSR, b: int) -> Optional[Tuple[float, float]]:
    """Analytic tuner prefilter: (streamed entries, block fill fraction)
    under a (b, b) BDIA split, or None when clearly unprofitable.

    O(nnz) numpy; mirrors :func:`cask_tpu.ops.dia.estimate_dia_traffic`
    but at block granularity (block presence deduplicated per block)."""
    m, n = a.shape
    nbr, nbc = -(-m // b), -(-n // b)
    indptr = np.asarray(a.indptr, dtype=np.int64)
    indices = np.asarray(a.indices, dtype=np.int64)
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(indptr))
    keys = (rows // b) * nbc + (indices // b)
    ukeys, kcounts = np.unique(keys, return_counts=True)
    d = (ukeys % nbc) - (ukeys // nbc)
    uniq, idx = np.unique(d, return_inverse=True)
    counts = np.bincount(idx)  # blocks per block diagonal
    scalar_per_diag = np.bincount(idx, weights=kcounts)  # true entries
    diag_len = np.minimum(np.minimum(nbr, nbc - uniq), np.minimum(nbc, nbr + uniq))
    density = counts / np.maximum(diag_len, 1)
    keep = density >= 0.10
    if keep.sum() > 64:
        keep &= counts >= np.sort(counts[keep])[-64]
    covered = scalar_per_diag[keep].sum() / max(a.nnz, 1)
    if covered < 0.5 or not keep.any():
        return None
    streamed = float(keep.sum()) * b * b * nbr
    rem = float(scalar_per_diag[~keep].sum())
    fill = scalar_per_diag[keep].sum() / max(streamed, 1.0)
    if fill < 0.25:  # block diagonals exist but blocks are mostly empty
        return None
    return streamed + rem * 3.0, float(fill)
