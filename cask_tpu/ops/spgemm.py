"""SpGEMM:  C = A @ B  for sparse A, B (BASELINE config 4: A·A and A·B on
graph matrices).

XLA compiles static shapes, but SpGEMM's output sparsity is data-
dependent (SURVEY.md §7 hard-part (a)).  Resolution: split the op in the
classic two phases —

- **symbolic** (host, structure-only, cacheable): compute the expansion
  map (every scalar product A[i,k]·B[k,j] gets a slot) and the output
  structure C.indices/C.indptr, via numpy (native C++ core for large
  inputs).  This depends only on the sparsity patterns, so it is reused
  across value updates — the common case in solvers and graph pipelines.
- **numeric** (device, jittable): two gathers + one multiply + one
  ``segment_sum`` over precomputed static index arrays.

This mirrors how cask split preprocess (host encode) from compute (DFE
stream), and is also the standard GPU SpGEMM decomposition (row-merge /
expansion-sort-compress), re-cut along the host/XLA boundary.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cask_tpu.formats.matrix import CSR

_INT = np.int32


@dataclasses.dataclass(frozen=True)
class SpGEMMPlan:
    """Host-side symbolic product of two sparsity patterns.

    ``src_a[t]`` / ``src_b[t]`` index the A/B entries whose product feeds
    expansion slot ``t``; ``out_id[t]`` maps the slot to its C entry.
    """

    shape: Tuple[int, int]
    src_a: np.ndarray  # (E,) int32 into A.data
    src_b: np.ndarray  # (E,) int32 into B.data
    out_id: np.ndarray  # (E,) int32 into C.data
    c_indices: np.ndarray  # (nnz_C,) int32
    c_indptr: np.ndarray  # (m+1,) int32

    @property
    def nnz(self) -> int:
        return int(self.c_indices.shape[0])

    @property
    def expansion(self) -> int:
        return int(self.src_a.shape[0])

    def numeric(self, a_data, b_data) -> CSR:
        """Device-side numeric phase (jittable)."""
        a_data = jnp.asarray(a_data)
        b_data = jnp.asarray(b_data)
        prod = a_data[jnp.asarray(self.src_a)] * b_data[jnp.asarray(self.src_b)]
        c_data = jax.ops.segment_sum(
            prod, jnp.asarray(self.out_id), num_segments=self.nnz, indices_are_sorted=True
        )
        return CSR(
            data=c_data,
            indices=jnp.asarray(self.c_indices),
            indptr=jnp.asarray(self.c_indptr),
            shape=self.shape,
        )


def spgemm_plan(a: CSR, b: CSR) -> SpGEMMPlan:
    """Symbolic phase: expansion map + output structure (host, numpy)."""
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"dimension mismatch: {a.shape} @ {b.shape}")
    m, p = a.shape[0], b.shape[1]

    a_indptr = np.asarray(a.indptr, dtype=np.int64)
    a_indices = np.asarray(a.indices, dtype=np.int64)
    b_indptr = np.asarray(b.indptr, dtype=np.int64)
    b_indices = np.asarray(b.indices, dtype=np.int64)

    a_rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(a_indptr))
    # expansion slots: A entry e pairs with the whole B row a_indices[e]
    b_counts = np.diff(b_indptr)
    exp_counts = b_counts[a_indices]  # products per A entry
    E = int(exp_counts.sum())
    if E > np.iinfo(_INT).max:
        raise OverflowError(
            f"SpGEMM expansion ({E:.2e} products) exceeds int32 indexing; "
            "use spgemm(..., backend='native')"
        )
    src_a = np.repeat(np.arange(a_indices.shape[0], dtype=np.int64), exp_counts)
    # src_b: for slot t within A-entry e, b_indptr[a_indices[e]] + local_offset
    slot_start = np.zeros(a_indices.shape[0] + 1, dtype=np.int64)
    np.cumsum(exp_counts, out=slot_start[1:])
    local = np.arange(E, dtype=np.int64) - slot_start[src_a]
    src_b = b_indptr[a_indices[src_a]] + local

    rows = a_rows[src_a]
    cols = b_indices[src_b]
    key = rows * p + cols
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq_mask = np.empty(E, dtype=bool)
    if E:
        uniq_mask[0] = True
        np.not_equal(key_s[1:], key_s[:-1], out=uniq_mask[1:])
        out_of_order = np.cumsum(uniq_mask) - 1  # C id per sorted slot
        nnz_c = int(out_of_order[-1]) + 1
        out_id = np.empty(E, dtype=np.int64)
        out_id[order] = out_of_order
        uniq_key = key_s[uniq_mask]
    else:
        out_id = np.zeros(0, dtype=np.int64)
        nnz_c = 0
        uniq_key = np.zeros(0, dtype=np.int64)

    c_rows = uniq_key // p
    c_indices = (uniq_key % p).astype(_INT)
    c_indptr = np.zeros(m + 1, dtype=np.int64)
    np.add.at(c_indptr, c_rows + 1, 1)
    c_indptr = np.cumsum(c_indptr)

    # store slots sorted by output id: the segment_sum in numeric() then
    # legitimately uses indices_are_sorted=True (in A-entry order the ids
    # revisit earlier C entries within a row — the hint would be wrong).
    src_a = src_a[order]
    src_b = src_b[order]
    out_id = out_id[order]

    return SpGEMMPlan(
        shape=(m, p),
        src_a=src_a.astype(_INT),
        src_b=src_b.astype(_INT),
        out_id=out_id.astype(_INT),
        c_indices=c_indices,
        c_indptr=c_indptr.astype(_INT),
    )


def expansion_size(a: CSR, b: CSR) -> int:
    """Scalar products in A·B (= FLOPs/2) — the expansion-plan footprint."""
    b_counts = np.diff(np.asarray(b.indptr, dtype=np.int64))
    return int(b_counts[np.asarray(a.indices, dtype=np.int64)].sum())


# Above this expansion size the device plan's index arrays get heavy
# (≈12 bytes/slot host + device); Gustavson in the native core wins.
_NATIVE_THRESHOLD = 30_000_000


def spgemm_native(a: CSR, b: CSR) -> CSR:
    """Full host Gustavson SpGEMM via the C++ core (heavy-tailed graphs
    where the expansion plan blows up).  Returns a host CSR."""
    from cask_tpu.native import binding as nat

    c_ptr, c_col, c_val = nat.spgemm(
        a.shape[0], a.shape[1], b.shape[1],
        np.asarray(a.indptr), np.asarray(a.indices), np.asarray(a.data),
        np.asarray(b.indptr), np.asarray(b.indices), np.asarray(b.data),
    )
    return CSR(
        data=c_val.astype(np.asarray(a.data).dtype),
        indices=c_col,
        indptr=c_ptr,
        shape=(a.shape[0], b.shape[1]),
    )


def spgemm(a: CSR, b: Optional[CSR] = None, *, plan: Optional[SpGEMMPlan] = None,
           backend: str = "auto") -> CSR:
    """``C = A @ B`` (``B=None`` means ``A @ A``).

    backend:
    - ``'plan'``   — host symbolic + device numeric (structure cached,
      values updatable on device; the solver-pipeline mode)
    - ``'native'`` — one-shot host Gustavson in C++ (big irregular graphs)
    - ``'auto'``   — native when the expansion would exceed
      ``_NATIVE_THRESHOLD`` products and the native core is available
    """
    if b is None:
        b = a
    if not isinstance(a, CSR) or not isinstance(b, CSR):
        raise TypeError("spgemm requires CSR operands (convert first)")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"dimension mismatch: {a.shape} @ {b.shape}")
    if plan is not None:
        return plan.numeric(a.data, b.data)
    if backend == "native":
        return spgemm_native(a, b)
    if backend == "auto" and expansion_size(a, b) > _NATIVE_THRESHOLD:
        try:
            return spgemm_native(a, b)
        except Exception:
            pass  # fall through to the plan path
    return spgemm_plan(a, b).numeric(a.data, b.data)
