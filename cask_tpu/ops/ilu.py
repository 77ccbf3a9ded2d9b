"""ILU(0): incomplete LU factorization with zero fill-in (BASELINE T5).

Two factorization paths:

- **Host** (:func:`ilu0`): the exact sequential IKJ row recurrence
  (numpy reference; the native C++ core provides the fast path).
- **Device** (:func:`ilu0_device` / :class:`ILU0DevicePlan`): the
  Chow–Patel fine-grained parallel ILU (SISC 2015) — the factorization
  is recast as the fixed point of ``F(v)`` where every nonzero updates
  independently per sweep, which is exactly the data-parallel shape a
  wide accelerator wants.
  A host *symbolic* phase enumerates each nonzero's L·U dependency
  pairs once per pattern; the *numeric* sweeps are a jittable
  gather/segment-sum loop, so factorization joins the solver on device
  and values re-bind without re-planning (the architecture invariant).

Either way the preconditioner *apply* (two triangular solves) runs on
device via cached :class:`~cask_tpu.ops.trisolve.TriSolvePlan`s, keeping
solver iterations device-resident (SURVEY.md §3.3 boundary lesson).

Storage follows the classic convention: one CSR on A's pattern holding
strict-lower = L (unit diagonal implied) and diag+upper = U.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from cask_tpu.formats.matrix import CSR
from cask_tpu.ops.trisolve import TriSolvePlan, trisolve_plan


def _ilu0_numpy(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Reference IKJ ILU(0) on a CSR pattern with sorted column indices."""
    n = indptr.shape[0] - 1
    lu = data.astype(np.float64, copy=True)
    # position of the diagonal entry in each row
    diag_pos = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        s, e = indptr[i], indptr[i + 1]
        cols_i = indices[s:e]
        dp = np.searchsorted(cols_i, i)
        if dp < cols_i.shape[0] and cols_i[dp] == i:
            diag_pos[i] = s + dp
        else:
            raise ValueError(f"ILU(0): missing diagonal in row {i}")

    for i in range(n):
        s, e = indptr[i], indptr[i + 1]
        cols_i = indices[s:e]
        row_i = lu[s:e]
        for t in range(e - s):
            k = cols_i[t]
            if k >= i:
                break
            dk = lu[diag_pos[k]]
            lik = row_i[t] / dk
            row_i[t] = lik
            # subtract lik * U-row(k) restricted to row i's pattern
            ks, ke = diag_pos[k] + 1, indptr[k + 1]
            if ks < ke:
                cols_k = indices[ks:ke]
                # merge: positions of cols_k within cols_i (both sorted)
                pos = np.searchsorted(cols_i, cols_k)
                ok = (pos < cols_i.shape[0])
                ok &= cols_i[np.minimum(pos, cols_i.shape[0] - 1)] == cols_k
                row_i[pos[ok]] -= lik * lu[ks:ke][ok]
        if lu[diag_pos[i]] == 0.0:
            raise ZeroDivisionError(f"ILU(0): zero pivot at row {i}")
    return lu


@dataclasses.dataclass(frozen=True)
class ILU0Factors:
    """Combined LU values on A's pattern, plus cached device solve plans."""

    lu: CSR  # values = factorization, pattern = A's
    _lower_plan: TriSolvePlan
    _upper_plan: TriSolvePlan
    _lower_data: np.ndarray  # values rearranged for each plan's pattern
    _upper_data: np.ndarray

    def apply(self, b, *, method: str = "levels", sweeps: int = 5):
        """Preconditioner solve  x = U⁻¹ L⁻¹ b  (jittable).

        ``method='jacobi'`` replaces each exact triangular solve with
        ``sweeps`` Jacobi–Richardson sweeps (SpMV-class parallel ops —
        the usable ILU apply on a wide accelerator); 'levels' is the
        exact wavefront solve."""
        if method == "jacobi":
            lp, up = self._jacobi_plans()
            return up.solve(lp.solve(b, sweeps=sweeps), sweeps=sweeps)
        y = self._lower_plan.solve(self._lower_data, b)
        return self._upper_plan.solve(self._upper_data, y)

    def jacobi_applier(self, sweeps: int = 5):
        """A jit-friendly ``r → M⁻¹r`` callable using sweep solves —
        pass as ``M=`` to the Krylov solvers."""
        lp, up = self._jacobi_plans()
        return lambda r: up.solve(lp.solve(r, sweeps=sweeps), sweeps=sweeps)

    def _jacobi_plans(self):
        cached = getattr(self, "_jacobi_cache", None)
        if cached is None:
            from cask_tpu.ops.trisolve import jacobi_trisolve_plan

            low, up = self.split()
            cached = (jacobi_trisolve_plan(low, lower=True, unit_diag=True),
                      jacobi_trisolve_plan(up, lower=False, unit_diag=False))
            object.__setattr__(self, "_jacobi_cache", cached)
        return cached

    def split(self):
        """Return (L with unit diag, U) as separate host CSRs."""
        return _split_lu(self.lu)


def _split_lu(lu: CSR):
    indptr = np.asarray(lu.indptr, dtype=np.int64)
    indices = np.asarray(lu.indices, dtype=np.int64)
    data = np.asarray(lu.data)
    n = lu.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))

    def build(mask, extra_diag):
        r = rows[mask]
        c = indices[mask]
        d = data[mask]
        if extra_diag:
            r = np.concatenate([r, np.arange(n, dtype=np.int64)])
            c = np.concatenate([c, np.arange(n, dtype=np.int64)])
            d = np.concatenate([d, np.ones(n, dtype=data.dtype)])
        from cask_tpu.formats.convert import coo_from_arrays, coo_to_csr

        return coo_to_csr(coo_from_arrays(d, r, c, lu.shape), sum_duplicates=False)

    low = build(indices < rows, extra_diag=True)
    up = build(indices >= rows, extra_diag=False)
    return low, up


def _diag_positions(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    n = indptr.shape[0] - 1
    diag_pos = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        s, e = indptr[i], indptr[i + 1]
        dp = int(np.searchsorted(indices[s:e], i))
        if dp < e - s and indices[s + dp] == i:
            diag_pos[i] = s + dp
        else:
            raise ValueError(f"ILU(0): missing diagonal in row {i}")
    return diag_pos


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ILU0DevicePlan:
    """Chow–Patel symbolic plan: per-nonzero L·U dependency pairs.

    ``factorize``/``apply`` are jittable; the plan caches per pattern and
    new values re-bind without re-planning.

    Convergence domain: the fixed-point iteration contracts for the
    diagonally-dominant / M-matrix class typical of PDE discretizations
    (machine precision in ~10–20 sweeps measured); for wildly indefinite
    values it can diverge — check :meth:`residual` and fall back to the
    host :func:`ilu0`.  This mirrors the behavior of fine-grained
    parallel ILU implementations on other accelerators.
    """

    a_vals: jax.Array  # (nnz,) A's values (re-bindable)
    pair_out: jax.Array  # (npairs,) int32 target nnz, sorted
    pair_l: jax.Array  # (npairs,) int32 position of l_ik
    pair_u: jax.Array  # (npairs,) int32 position of u_kj
    diag_of_col: jax.Array  # (nnz,) int32 diag position of each entry's column
    is_lower: jax.Array  # (nnz,) bool
    low_src: jax.Array  # (nnz_low,) int32 into vals; -1 → unit diagonal 1.0
    up_src: jax.Array  # (nnz_up,) int32 into vals
    lower_plan: TriSolvePlan = dataclasses.field(metadata=dict(static=True))
    upper_plan: TriSolvePlan = dataclasses.field(metadata=dict(static=True))

    @property
    def nnz(self) -> int:
        return int(self.a_vals.shape[0])

    def factorize(self, a_vals=None, *, sweeps: int = 5):
        """Fixed-point sweeps → combined LU values on A's pattern."""
        a = self.a_vals if a_vals is None else jnp.asarray(a_vals)
        dj0 = a[self.diag_of_col]
        v0 = jnp.where(self.is_lower, a / dj0, a)

        def body(_, v):
            prod = v[self.pair_l] * v[self.pair_u]
            corr = jax.ops.segment_sum(prod, self.pair_out,
                                       num_segments=self.nnz,
                                       indices_are_sorted=True)
            new = a - corr
            dj = v[self.diag_of_col]
            return jnp.where(self.is_lower, new / dj, new)

        return jax.lax.fori_loop(0, sweeps, body, v0)

    def residual(self, vals):
        """‖vals − F(vals)‖∞ / ‖A‖∞ — fixed-point convergence check."""
        prod = vals[self.pair_l] * vals[self.pair_u]
        corr = jax.ops.segment_sum(prod, self.pair_out,
                                   num_segments=self.nnz,
                                   indices_are_sorted=True)
        new = self.a_vals - corr
        dj = vals[self.diag_of_col]
        f = jnp.where(self.is_lower, new / dj, new)
        return jnp.max(jnp.abs(f - vals)) / jnp.max(jnp.abs(self.a_vals))

    def apply(self, vals, b):
        """Preconditioner solve ``x = U⁻¹ L⁻¹ b`` from factorized vals."""
        low_data = jnp.where(self.low_src < 0,
                             jnp.ones((), vals.dtype),
                             vals[jnp.maximum(self.low_src, 0)])
        up_data = vals[self.up_src]
        y = self.lower_plan.solve(low_data, b)
        return self.upper_plan.solve(up_data, y)


def ilu0_device_plan(a: CSR) -> ILU0DevicePlan:
    """Symbolic Chow–Patel plan for A's pattern (host, once per pattern)."""
    import scipy.sparse as sp

    indptr = np.asarray(a.indptr, dtype=np.int64)
    indices = np.asarray(a.indices, dtype=np.int64)
    data = np.asarray(a.data)
    n = a.shape[0]
    nnz = indices.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    diag_pos = _diag_positions(indptr, indices)

    # candidate pairs: target (i,j) at p needs k ∈ cols(i), k < min(i,j)
    p_all, l_all, k_all, j_all = [], [], [], []
    for i in range(n):
        s, e = int(indptr[i]), int(indptr[i + 1])
        cols_i = indices[s:e]
        kmax = np.minimum(cols_i, i)
        tt = np.searchsorted(cols_i, kmax)
        tot = int(tt.sum())
        if tot == 0:
            continue
        t_idx = np.repeat(np.arange(e - s), tt)
        base = np.cumsum(tt) - tt
        q_idx = np.arange(tot) - np.repeat(base, tt)
        p_all.append(s + t_idx)
        l_all.append(s + q_idx)
        k_all.append(cols_i[q_idx])
        j_all.append(cols_i[t_idx])
    if p_all:
        p_c = np.concatenate(p_all)
        l_c = np.concatenate(l_all)
        k_c = np.concatenate(k_all)
        j_c = np.concatenate(j_all)
        # vectorized (k,j) ∈ pattern lookup via a position matrix
        P = sp.csr_matrix((np.arange(1, nnz + 1, dtype=np.int64),
                           indices.astype(np.int64), indptr), shape=a.shape)
        upos = np.asarray(P[k_c, j_c]).ravel()
        keep = upos > 0
        pair_out = p_c[keep].astype(np.int32)
        pair_l = l_c[keep].astype(np.int32)
        pair_u = (upos[keep] - 1).astype(np.int32)
    else:
        pair_out = np.zeros(0, np.int32)
        pair_l = np.zeros(0, np.int32)
        pair_u = np.zeros(0, np.int32)

    # triangular split patterns + value-assembly permutations
    lu_pattern = CSR(data=data, indices=indices.astype(np.int32),
                     indptr=indptr.astype(np.int32), shape=a.shape)
    low, up = _split_lu(lu_pattern)
    lower_mask = indices < rows
    up_src = np.nonzero(~lower_mask)[0].astype(np.int32)
    low_positions = np.nonzero(lower_mask)[0]
    low_rows = rows[lower_mask]
    cnt = np.zeros(n, np.int64)
    np.add.at(cnt, low_rows, 1)
    # ordinal within row (rows are sorted runs)
    starts = np.cumsum(cnt) - cnt
    ordinal = np.arange(low_positions.shape[0]) - starts[low_rows]
    low_indptr = np.asarray(low.indptr, dtype=np.int64)
    low_src = np.full(low.nnz, -1, dtype=np.int32)
    low_src[low_indptr[low_rows] + ordinal] = low_positions.astype(np.int32)

    return ILU0DevicePlan(
        a_vals=jnp.asarray(data),
        pair_out=jnp.asarray(pair_out),
        pair_l=jnp.asarray(pair_l),
        pair_u=jnp.asarray(pair_u),
        diag_of_col=jnp.asarray(diag_pos[indices].astype(np.int32)),
        is_lower=jnp.asarray(lower_mask),
        low_src=jnp.asarray(low_src),
        up_src=jnp.asarray(up_src),
        lower_plan=trisolve_plan(low, lower=True, unit_diag=True),
        upper_plan=trisolve_plan(up, lower=False, unit_diag=False),
    )


@dataclasses.dataclass(frozen=True)
class ILU0DeviceFactors:
    """Factorized values bound to their plan — drop-in ``.apply`` like
    :class:`ILU0Factors`, but fully device-resident."""

    plan: ILU0DevicePlan
    vals: jax.Array

    def apply(self, b):
        return self.plan.apply(self.vals, b)


def ilu0_device(a: CSR, *, sweeps: int = 5) -> ILU0DeviceFactors:
    """Chow–Patel parallel ILU(0) on device (plan + factorize)."""
    plan = ilu0_device_plan(a)
    vals = jax.jit(plan.factorize, static_argnames=("sweeps",))(sweeps=sweeps)
    return ILU0DeviceFactors(plan=plan, vals=vals)


def ilu0(a: CSR, *, use_native: Optional[bool] = None) -> ILU0Factors:
    """Factor ``A ≈ L U`` on A's own sparsity pattern."""
    if not isinstance(a, CSR):
        raise TypeError("ilu0 requires a CSR matrix")
    indptr = np.asarray(a.indptr, dtype=np.int64)
    indices = np.asarray(a.indices, dtype=np.int64)
    data = np.asarray(a.data)

    lu_vals = None
    if use_native is not False:
        try:
            from cask_tpu.native import binding as nat

            lu_vals = nat.ilu0(indptr, indices, data)
        except Exception:
            if use_native:
                raise
    if lu_vals is None:
        lu_vals = _ilu0_numpy(indptr, indices, data)

    lu = CSR(
        data=lu_vals.astype(data.dtype),
        indices=indices.astype(np.int32),
        indptr=indptr.astype(np.int32),
        shape=a.shape,
    )
    low, up = _split_lu(lu)
    lp = trisolve_plan(low, lower=True, unit_diag=True)
    upl = trisolve_plan(up, lower=False, unit_diag=False)
    return ILU0Factors(
        lu=lu,
        _lower_plan=lp,
        _upper_plan=upl,
        _lower_data=np.asarray(low.data),
        _upper_data=np.asarray(up.data),
    )
