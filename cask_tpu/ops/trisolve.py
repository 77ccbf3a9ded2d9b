"""Sparse triangular solve  L x = b  /  U x = b  (BASELINE T5).

Sequential dependences are the hard part on a SIMD machine (SURVEY.md §7
hard-part (c)).  Strategy: **level scheduling** — rows are grouped into
levels such that every row's dependencies live in earlier levels; the
device then runs one ``lax.scan`` over levels, each step a batched
gather / segment-sum / divide over a padded level worth of rows.  The
level analysis runs on the host once per sparsity pattern and is cached
in a :class:`TriSolvePlan` (cask analog: host preprocess vs DFE compute
split, SURVEY.md §3.1).

Padding discipline: rows/cols are padded with index ``n`` into an
(n+1)-slot solution vector whose last slot stays 0, so the scan body
needs no masks (same trick as BSR structural-zero padding).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from cask_tpu.formats.matrix import CSR

_INT = np.int32


def _split_triangle(a: CSR, lower: bool):
    """Host split of CSR into (strict off-diag entries, diag values)."""
    indptr = np.asarray(a.indptr, dtype=np.int64)
    indices = np.asarray(a.indices, dtype=np.int64)
    n = a.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    on_diag = rows == indices
    strict = (indices < rows) if lower else (indices > rows)
    wrong_side = ~(on_diag | strict)
    if np.any(wrong_side):
        raise ValueError(
            "matrix has entries on the wrong side of the diagonal for "
            f"{'lower' if lower else 'upper'} trisolve"
        )
    diag_val_idx = np.full(n, -1, dtype=np.int64)
    diag_val_idx[rows[on_diag]] = np.nonzero(on_diag)[0]
    return rows, indices, strict, diag_val_idx


def compute_levels(rows: np.ndarray, cols: np.ndarray, n: int, lower: bool) -> np.ndarray:
    """Level of each row (0-based) via vectorized frontier propagation.

    O(nnz) total work: each pass retires the rows whose remaining
    dependency count hit zero and decrements their dependents.  The
    native core computes the same thing with a single sequential sweep
    (dependencies always point to earlier rows after triangular
    ordering); this numpy version is the fallback/reference.
    """
    try:
        from cask_tpu.native import binding as nat

        # the native sweep processes rows in ascending order, which is a
        # topological order only for lower patterns — reflect upper ones
        r = rows if lower else (n - 1 - rows)
        c = cols if lower else (n - 1 - cols)
        order = np.argsort(r, kind="stable")
        sptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(sptr, r + 1, 1)
        sptr = np.cumsum(sptr)
        lv, _ = nat.levels_lower(n, sptr, c[order])
        lv = lv.astype(np.int64)
        # undo the reflection: original row i lives at reflected slot n-1-i
        return lv if lower else np.ascontiguousarray(lv[::-1])
    except Exception:
        pass
    # dependency edges: row r depends on row c (strict triangle entries)
    dep_counts = np.zeros(n, dtype=np.int64)
    np.add.at(dep_counts, rows, 1)
    # group edges by their *column* (CSC-ish) to find dependents of a row
    order = np.argsort(cols, kind="stable")
    e_rows = rows[order]
    e_cols = cols[order]
    col_ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(col_ptr, e_cols + 1, 1)
    col_ptr = np.cumsum(col_ptr)

    level = np.full(n, -1, dtype=np.int64)
    frontier = np.nonzero(dep_counts == 0)[0]
    lvl = 0
    while frontier.size:
        level[frontier] = lvl
        # all edges whose source column is in the frontier
        starts = col_ptr[frontier]
        ends = col_ptr[frontier + 1]
        lens = ends - starts
        tot = int(lens.sum())
        if tot:
            base = np.repeat(starts, lens)
            offs = np.arange(tot, dtype=np.int64) - np.repeat(
                np.cumsum(lens) - lens, lens
            )
            touched = e_rows[base + offs]
            np.add.at(dep_counts, touched, -1)
            dep_counts[frontier] = -1  # retired
            frontier = np.unique(touched[dep_counts[touched] == 0])
        else:
            dep_counts[frontier] = -1
            frontier = np.zeros(0, dtype=np.int64)
        lvl += 1
    if np.any(level < 0):
        raise ValueError("dependency cycle — not a permuted triangular matrix?")
    return level


@dataclasses.dataclass(frozen=True)
class TriSolvePlan:
    """Level schedule + padded index arrays for one triangular pattern."""

    n: int
    lower: bool
    unit_diag: bool
    nlevels: int
    max_rows: int  # rows per level, padded
    max_ents: int  # strict entries per level, padded
    lvl_rows: np.ndarray  # (nlevels, max_rows) int32, pad = n
    lvl_diag_idx: np.ndarray  # (nlevels, max_rows) int32 into data, pad = 0
    lvl_ent_local: np.ndarray  # (nlevels, max_ents) int32 into [0, max_rows), pad→max_rows
    lvl_ent_col: np.ndarray  # (nlevels, max_ents) int32, pad = n
    lvl_ent_idx: np.ndarray  # (nlevels, max_ents) int32 into data, pad = 0
    lvl_ent_valid: np.ndarray  # (nlevels, max_ents) bool

    def solve(self, data, b):
        """Jittable solve given the pattern's value array ``data``.

        ``b`` may be (n,) or (n, k) — the level sweep is batched over
        the trailing axis at no extra scheduling cost."""
        return tri_solve_arrays(
            jnp.asarray(data), b,
            jnp.asarray(self.lvl_rows), jnp.asarray(self.lvl_diag_idx),
            jnp.asarray(self.lvl_ent_local), jnp.asarray(self.lvl_ent_col),
            jnp.asarray(self.lvl_ent_idx), jnp.asarray(self.lvl_ent_valid),
            n=self.n, max_rows=self.max_rows, unit_diag=self.unit_diag,
        )


def tri_solve_arrays(data, b, lvl_rows, lvl_diag, ent_local, ent_col,
                     ent_idx, ent_valid, *, n: int, max_rows: int,
                     unit_diag: bool):
    """The level sweep on raw plan arrays (jittable).

    Factored out of :meth:`TriSolvePlan.solve` so stacked per-shard plans
    (distributed block-ILU, :func:`cask_tpu.solvers.precond.shard_ilu0`)
    can run the identical program under ``shard_map``."""
    b = jnp.asarray(b)
    vec = b.ndim == 1
    b2 = b[:, None] if vec else b
    k = b2.shape[1]
    xe = jnp.zeros((n + 1, k), dtype=b.dtype)
    be = jnp.concatenate([b2, jnp.zeros((1, k), b.dtype)])

    def body(xe, lv):
        rows, diag_idx, e_local, e_col, e_idx, e_valid = lv
        vals = jnp.where(e_valid, data[e_idx], 0).astype(b.dtype)
        contrib = jax.ops.segment_sum(
            vals[:, None] * xe[e_col], e_local, num_segments=max_rows + 1
        )[:max_rows]
        rhs = be[rows] - contrib
        if unit_diag:
            xr = rhs
        else:
            xr = rhs / jnp.where(rows < n, data[diag_idx], 1).astype(b.dtype)[:, None]
        xe = xe.at[rows].set(xr, mode="drop")
        return xe, None

    xe, _ = jax.lax.scan(
        body, xe, (lvl_rows, lvl_diag, ent_local, ent_col, ent_idx, ent_valid)
    )
    out = xe[:n]
    return out[:, 0] if vec else out


def trisolve_plan(a: CSR, *, lower: bool = True, unit_diag: bool = False) -> TriSolvePlan:
    n = a.shape[0]
    if a.shape[0] != a.shape[1]:
        raise ValueError("triangular solve needs a square matrix")
    rows, cols, strict, diag_idx = _split_triangle(a, lower)
    if not unit_diag and np.any(diag_idx < 0):
        raise ValueError("zero diagonal entry (missing from pattern)")
    s_rows = rows[strict]
    s_cols = cols[strict]
    s_idx = np.nonzero(strict)[0]
    level = compute_levels(s_rows, s_cols, n, lower)

    nlevels = int(level.max()) + 1 if n else 0
    order = np.argsort(level, kind="stable")
    lvl_sizes = np.bincount(level, minlength=nlevels)
    max_rows = int(lvl_sizes.max()) if nlevels else 0

    lvl_rows = np.full((nlevels, max_rows), n, dtype=_INT)
    lvl_diag = np.zeros((nlevels, max_rows), dtype=_INT)
    pos_in_level = np.zeros(n, dtype=np.int64)
    # position of each row inside its level
    start = np.zeros(nlevels + 1, dtype=np.int64)
    np.cumsum(lvl_sizes, out=start[1:])
    pos_in_level[order] = np.arange(n) - start[level[order]]
    lvl_rows[level, pos_in_level] = np.arange(n, dtype=_INT)
    if not unit_diag:
        lvl_diag[level, pos_in_level] = diag_idx.astype(_INT)

    e_level = level[s_rows]
    ents_per_level = np.bincount(e_level, minlength=nlevels) if s_rows.size else np.zeros(nlevels, np.int64)
    max_ents = int(ents_per_level.max()) if nlevels and ents_per_level.size else 0
    max_ents = max(max_ents, 1)

    lvl_ent_local = np.full((nlevels, max_ents), max_rows, dtype=_INT)
    lvl_ent_col = np.full((nlevels, max_ents), n, dtype=_INT)
    lvl_ent_idx = np.zeros((nlevels, max_ents), dtype=_INT)
    lvl_ent_valid = np.zeros((nlevels, max_ents), dtype=bool)
    if s_rows.size:
        e_order = np.argsort(e_level, kind="stable")
        e_start = np.zeros(nlevels + 1, dtype=np.int64)
        np.cumsum(ents_per_level, out=e_start[1:])
        e_pos = np.arange(s_rows.size) - e_start[e_level[e_order]]
        el = e_level[e_order]
        lvl_ent_local[el, e_pos] = pos_in_level[s_rows[e_order]].astype(_INT)
        lvl_ent_col[el, e_pos] = s_cols[e_order].astype(_INT)
        lvl_ent_idx[el, e_pos] = s_idx[e_order].astype(_INT)
        lvl_ent_valid[el, e_pos] = True

    return TriSolvePlan(
        n=n,
        lower=lower,
        unit_diag=unit_diag,
        nlevels=nlevels,
        max_rows=max_rows,
        max_ents=max_ents,
        lvl_rows=lvl_rows,
        lvl_diag_idx=lvl_diag,
        lvl_ent_local=lvl_ent_local,
        lvl_ent_col=lvl_ent_col,
        lvl_ent_idx=lvl_ent_idx,
        lvl_ent_valid=lvl_ent_valid,
    )


# ---------------------------------------------------------------------------
# Iterative (Jacobi–Richardson) triangular solve — the accelerator answer
# to the level-scheduling latency wall (PERF.md "Trisolve": ~68 µs *per
# level* makes exact wavefront sweeps 3–4 orders off the per-iteration
# budget on v5e).  Split A = D + N (diagonal + strict triangle) and
# iterate  x⁽ᵏ⁺¹⁾ = D⁻¹(b − N x⁽ᵏ⁾): each sweep is ONE SpMV-class, fully
# parallel op (a DIA-plan kernel when the triangle is banded), no levels,
# no scan.  The iteration matrix D⁻¹N is strictly triangular, hence
# NILPOTENT — the sweep is exact after n steps and, for the diagonally
# dominant factors ILU(0)/IC(0) produce on PDE matrices, accurate to
# preconditioner quality in ~3–10 sweeps (Anzt et al., ISC 2015-style
# iterative triangular solves).  This is what turns ILU from
# "correct but latency-bound" into a usable parallel preconditioner.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class JacobiTriSolvePlan:
    """Strict-triangle operator + inverse diagonal for sweep solves.

    ``strict`` is the planned N (a DIA plan when the triangle is banded —
    the fast path — else a device CSR riding the gather formulation);
    values are baked in at plan time (re-plan to re-bind, like every
    host-planned structure).
    """

    n: int
    lower: bool
    unit_diag: bool
    strict: object  # DiaMatrix or CSR (device) for N = A - D
    dinv: Optional[jax.Array]  # None for unit_diag

    def solve(self, b, *, sweeps: int = 5):
        """``sweeps`` Jacobi–Richardson iterations toward ``A x = b``
        (jittable; ``b`` may be (n,) or (n, k))."""
        from cask_tpu.ops.spmv import spmv
        from cask_tpu.ops.spmm import spmm

        b = jnp.asarray(b)
        op = (lambda v: spmv(self.strict, v)) if b.ndim == 1 else \
            (lambda v: spmm(self.strict, v))
        if self.unit_diag:
            scale = lambda v: v  # noqa: E731
        elif b.ndim == 1:
            scale = lambda v: v * self.dinv  # noqa: E731
        else:
            scale = lambda v: v * self.dinv[:, None]  # noqa: E731
        x = scale(b)

        def body(_, x):
            return scale(b - op(x))

        return jax.lax.fori_loop(0, sweeps, body, x)


def jacobi_trisolve_plan(a: CSR, *, lower: bool = True,
                         unit_diag: bool = False) -> JacobiTriSolvePlan:
    """Plan the sweep solve: split D / strict-N on the host, route N
    through the DIA plan when banded (zero-gather sweeps)."""
    n = a.shape[0]
    if a.shape[0] != a.shape[1]:
        raise ValueError("triangular solve needs a square matrix")
    rows, cols, strict, diag_idx = _split_triangle(a, lower)
    if not unit_diag and np.any(diag_idx < 0):
        raise ValueError("zero diagonal entry (missing from pattern)")
    data = np.asarray(a.data)
    dinv = None
    if not unit_diag:
        d = data[diag_idx]
        if np.any(d == 0):
            raise ValueError("zero diagonal entry")
        dinv = jnp.asarray(1.0 / d)

    from cask_tpu.formats.convert import coo_from_arrays, coo_to_csr

    n_csr = coo_to_csr(coo_from_arrays(
        data[strict], rows[strict], cols[strict], (n, n)),
        sum_duplicates=False)
    from cask_tpu.ops.dia import dia_plan, estimate_dia_traffic

    if n_csr.nnz and estimate_dia_traffic(n_csr) is not None:
        strict_op = dia_plan(n_csr).device_put()
    else:
        strict_op = n_csr.device_put()
    return JacobiTriSolvePlan(n=n, lower=lower, unit_diag=unit_diag,
                              strict=strict_op, dinv=dinv)


def trisolve(a: CSR, b, *, lower: bool = True, unit_diag: bool = False,
             method: str = "levels", sweeps: int = 5,
             plan: Optional[object] = None):
    """Solve the sparse triangular system ``a x = b``.

    ``method='levels'``: exact level-scheduled wavefront solve (host plan
    + one ``lax.scan``) — correct everywhere, latency-bound on a wide
    accelerator.
    ``method='jacobi'``: ``sweeps`` Jacobi–Richardson iterations, each an
    SpMV-class parallel op — the fast approximate solve for
    preconditioner application (exact once ``sweeps ≥ n``, accurate much
    sooner on diagonally dominant triangles).

    Build (or pass) the matching plan; the solve itself is jittable and
    lives on device.  For repeated solves with one pattern (the
    preconditioner case) keep the plan.
    """
    if method == "jacobi":
        if plan is None:
            plan = jacobi_trisolve_plan(a, lower=lower, unit_diag=unit_diag)
        return plan.solve(b, sweeps=sweeps)
    if method != "levels":
        raise ValueError(f"unknown trisolve method {method!r}")
    if plan is None:
        plan = trisolve_plan(a, lower=lower, unit_diag=unit_diag)
    return plan.solve(jnp.asarray(a.data), b)
