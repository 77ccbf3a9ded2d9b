"""Smoothed-aggregation algebraic multigrid (AMG) preconditioner.

The scalable preconditioner for the Poisson/FEM class of matrices the
framework targets (cask's solver demo matrices — SURVEY.md §2 R7): CG
iteration counts stay O(1) as the grid grows, where ILU/Jacobi degrade.

Split per the architecture invariant (host planning / device compute):

- **Setup (host, once per structure+values):** strength-of-connection
  graph → greedy (Vaněk-style) aggregation → piecewise-constant
  tentative prolongator → Jacobi-smoothed prolongator → Galerkin
  ``A_c = Pᵀ A P`` coarse operators, recursing until the coarsest level
  is small enough to invert densely.  scipy.sparse does the one-off
  triple products, like the ILU(0) host path.
- **Apply (device):** one V-cycle — weighted-Jacobi pre/post smoothing,
  restriction/prolongation as SpMVs on device-resident CSRs, a dense
  matmul coarse solve — unrolled over the (static) level hierarchy into
  a single jittable callable, so ``cg(..., M=amg)`` compiles to one
  device program with no host round-trips.

With ``nu_pre == nu_post`` and the symmetric Jacobi smoother the
V-cycle is a symmetric positive-definite operator for SPD ``A``, hence
a valid CG preconditioner.  Levels are single-shard; distributed AMG
(aggregating within shards) is future work — use
:func:`~cask_tpu.solvers.precond.chebyshev_precond` or ``shard_ilu0``
on meshes.
"""

from __future__ import annotations

import dataclasses
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from cask_tpu.formats.convert import from_scipy, to_scipy
from cask_tpu.formats.matrix import CSR
from cask_tpu.ops.spmv import spmv
from cask_tpu.utils import platform


def _strength_graph(a_sp, theta: float):
    """Symmetric strength-of-connection mask: |a_ij| ≥ θ·√(a_ii·a_jj)."""
    import scipy.sparse as sp

    d = np.abs(a_sp.diagonal())
    d = np.where(d == 0, 1.0, d)
    coo = a_sp.tocoo()
    scale = np.sqrt(d[coo.row] * d[coo.col])
    keep = (np.abs(coo.data) >= theta * scale) & (coo.row != coo.col)
    s = sp.csr_matrix(
        (np.ones(int(keep.sum())), (coo.row[keep], coo.col[keep])),
        shape=a_sp.shape)
    return s.maximum(s.T).tocsr()


def _aggregate(strength) -> np.ndarray:
    """Greedy aggregation over the strength graph (Vaněk pass 1+2+3).

    Returns ``agg[i]`` = aggregate id of node ``i`` (every node is
    assigned; isolated nodes become singletons).  Routes through the
    native C++ core when available — the row-order greedy passes are a
    pure-Python O(n) loop otherwise, the dominant term of AMG setup at
    1M rows — with this Python body as the bit-identical fallback
    (parity-tested).
    """
    try:
        from cask_tpu.native import binding

        agg, _ = binding.aggregate(strength.indptr, strength.indices)
        return agg
    except Exception:
        pass
    n = strength.shape[0]
    indptr, indices = strength.indptr, strength.indices
    agg = np.full(n, -1, dtype=np.int64)
    next_id = 0
    # pass 1: roots whose strong neighborhood is fully unaggregated
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        if (agg[nbrs] == -1).all():
            agg[i] = next_id
            agg[nbrs] = next_id
            next_id += 1
    # pass 2: attach leftovers to any aggregated strong neighbor
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        hit = nbrs[agg[nbrs] != -1]
        if hit.size:
            agg[i] = agg[hit[0]]
    # pass 3: remaining isolated nodes become singletons
    for i in range(n):
        if agg[i] == -1:
            agg[i] = next_id
            next_id += 1
    return agg


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class AmgLevel:
    # operators are whatever the router picked: a DiaMatrix (banded
    # levels), device CSR (unstructured levels) or a dense jax.Array
    # (small levels); the generic `spmv` dispatch serves them all.
    # Registered as a pytree so the WHOLE hierarchy can ride into jitted
    # solves as an ARGUMENT instead of closure constants (a closure
    # re-hashes hundreds of MB of inline constants at every trace)
    a: object  # level operator (device)
    p: object  # prolongator (n_fine × n_coarse, device)
    r: object  # restriction = Pᵀ (device)
    dinv: jax.Array  # 1/diag(a) for Jacobi smoothing (device)


def _apply_op(op, x):
    if isinstance(op, jax.Array):
        return jnp.matmul(op, x, precision=jax.lax.Precision.HIGHEST)
    if isinstance(op, _FactoredApply):
        return op(x)
    return spmv(op, x)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Aggregates:
    """The tentative prolongator ``T`` (n × n_coarse, a single 1 in each
    row) held as its aggregate map: ``T·xc = xc[agg]`` is one gather and
    ``Tᵀ·r`` one ``segment_sum`` — no value stream at all."""

    agg: jax.Array  # (n,) int32 aggregate id of each fine node
    n_coarse: int = dataclasses.field(metadata=dict(static=True))

    def prolong(self, xc):
        return xc[self.agg]

    def restrict(self, r):
        return jax.ops.segment_sum(r, self.agg, num_segments=self.n_coarse)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class _FactoredApply:
    """Smoothed prolongator applied in FACTORED form.  With
    ``P = (I − ω_s D⁻¹A)·T``:

        P·xc = t − ω_s·D⁻¹·(A·t),          t = T·xc
        R·r  = Tᵀ·(r − ω_s·A·(D⁻¹·r))      (A symmetric)

    so each application is one gather or segment-sum over the aggregate
    map plus one application of the level operator ``a``, which is
    already routed through the fast device path (DIA at the fine level)
    — instead of streaming a materialized smoothed P with ~3 entries per
    fine row each way."""

    kind: str = dataclasses.field(metadata=dict(static=True))  # 'p' | 'r'
    tent: Aggregates
    a: object  # routed level operator
    dinv: jax.Array
    omega_s: float = dataclasses.field(metadata=dict(static=True))

    @property
    def shape(self):
        n, nc = self.tent.agg.shape[0], self.tent.n_coarse
        return (n, nc) if self.kind == "p" else (nc, n)

    def __call__(self, x):
        w = jnp.asarray(self.omega_s, self.dinv.dtype)
        if self.kind == "p":
            t = self.tent.prolong(x)
            return t - w * self.dinv * _apply_op(self.a, t)
        return self.tent.restrict(x - w * _apply_op(self.a, self.dinv * x))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class AmgPrecond:
    """Callable ``r → V-cycle(r) ≈ A⁻¹r``; pass as ``M=`` to the solvers.

    A registered pytree: pass the hierarchy INTO a jitted solve as an
    argument — ``jax.jit(lambda b, M: cg(op, b, M=M).x)(b, M)`` — and
    hold that one jitted callable for repeat solves.  Re-tracing a
    solve that closes over the hierarchy hashes hundreds of MB of
    inline constants per call.
    """

    levels: List[AmgLevel]
    coarse_inv: jax.Array  # dense inverse of the coarsest operator
    omega: float = dataclasses.field(metadata=dict(static=True))
    nu_pre: int = dataclasses.field(metadata=dict(static=True))
    nu_post: int = dataclasses.field(metadata=dict(static=True))

    @property
    def level_sizes(self) -> List[int]:
        return [lv.a.shape[0] for lv in self.levels] + [self.coarse_inv.shape[0]]

    def _cycle(self, b, lvl: int):
        if lvl == len(self.levels):
            return _apply_op(self.coarse_inv, b)
        level = self.levels[lvl]
        w = self.omega
        x = w * level.dinv * b  # first sweep from x = 0
        for _ in range(self.nu_pre - 1):
            x = x + w * level.dinv * (b - _apply_op(level.a, x))
        resid = b - _apply_op(level.a, x)
        xc = self._cycle(_apply_op(level.r, resid), lvl + 1)
        x = x + _apply_op(level.p, xc)
        for _ in range(self.nu_post):
            x = x + w * level.dinv * (b - _apply_op(level.a, x))
        return x

    def apply(self, r):
        return self._cycle(r, 0)

    def __call__(self, r):
        return self.apply(r)


def smoothed_aggregation_amg(a: CSR, *, theta: float = 0.08, omega: float = 2.0 / 3.0,
                             nu_pre: int = 1, nu_post: int = 1, smooth: bool = True,
                             max_levels: int = 12, coarse_size: int = 256,
                             dtype=None, route: str = "auto",
                             dense_cutoff: int = 2048) -> AmgPrecond:
    """Build a smoothed-aggregation AMG hierarchy for SPD ``a``.

    ``theta`` is the strength threshold (smaller ⇒ coarser aggregates);
    ``smooth=False`` gives plain (unsmoothed) aggregation — cheaper
    setup, slower convergence.  ``dtype`` overrides the apply precision
    (e.g. ``jnp.float32`` to run the V-cycle at half the bytes inside an
    f64 outer solve via :func:`~cask_tpu.solvers.ir_solve`).

    ``route='auto'`` sends each level operator through the fastest
    device path — DIA plans for banded levels where the platform's route
    enables them (:mod:`cask_tpu.utils.platform`), device CSR for the
    rest, dense matmuls below ``dense_cutoff`` rows — and applies the
    smoothed prolongator in factored form over the aggregate map.
    ``route='csr'`` keeps every operator a device CSR (reference/debug).
    """
    import scipy.sparse as sp

    a_sp = to_scipy(a).tocsr().astype(np.float64)
    levels: List[AmgLevel] = []

    def put(mat_sp):
        mat_sp = mat_sp.tocsr()
        apply_dt = np.dtype(dtype) if dtype is not None else mat_sp.dtype
        if route == "auto" and max(mat_sp.shape) <= dense_cutoff:
            return jnp.asarray(mat_sp.toarray().astype(apply_dt))
        csr = from_scipy(mat_sp, format="csr")
        if dtype is not None:
            csr = csr.astype(dtype)
        if route == "auto" and platform.auto_plan("dia"):
            from cask_tpu.ops.dia import dia_plan, estimate_dia_traffic

            if estimate_dia_traffic(csr) is not None:
                return dia_plan(csr).device_put()
        return csr.device_put()

    while a_sp.shape[0] > coarse_size and len(levels) < max_levels:
        strength = _strength_graph(a_sp, theta)
        agg = _aggregate(strength)
        n_agg = int(agg.max()) + 1
        if n_agg >= a_sp.shape[0]:  # no coarsening possible (e.g. diagonal)
            break
        n = a_sp.shape[0]
        tent = sp.csr_matrix(
            (np.ones(n), (np.arange(n), agg)), shape=(n, n_agg))
        rho = None
        if smooth:
            dvals = a_sp.diagonal()
            dinv_h = np.where(dvals == 0, 0.0, 1.0 / np.where(dvals == 0, 1.0, dvals))
            da = sp.diags(dinv_h) @ a_sp
            # spectral-radius upper bound for the smoothing weight
            rho = float(abs(da).sum(axis=1).max())
            prol = (tent - (4.0 / 3.0 / rho) * (da @ tent)).tocsr()
        else:
            prol = tent
        a_coarse = (prol.T @ a_sp @ prol).tocsr()
        a_coarse.sum_duplicates()

        dvals = a_sp.diagonal()
        dinv = np.where(dvals == 0, 0.0, 1.0 / np.where(dvals == 0, 1.0, dvals))
        apply_dtype = np.dtype(dtype) if dtype is not None else a_sp.dtype
        a_dev = put(a_sp)
        dinv_dev = jnp.asarray(dinv.astype(apply_dtype))
        if smooth and route == "auto" and n > dense_cutoff:
            # factored application: the device never materializes the
            # smoothed P/R — only the aggregate map plus the
            # already-routed level operator (_FactoredApply docstring)
            fp = dict(tent=Aggregates(agg=jnp.asarray(agg.astype(np.int32)),
                                      n_coarse=n_agg),
                      a=a_dev, dinv=dinv_dev, omega_s=4.0 / 3.0 / rho)
            p_dev = _FactoredApply(kind="p", **fp)
            r_dev = _FactoredApply(kind="r", **fp)
        else:
            p_dev = put(prol)
            r_dev = put(prol.T.tocsr())
        levels.append(AmgLevel(a=a_dev, p=p_dev, r=r_dev, dinv=dinv_dev))
        a_sp = a_coarse

    coarse = np.linalg.inv(a_sp.toarray())
    if dtype is not None:
        coarse = coarse.astype(np.dtype(dtype))
    return AmgPrecond(levels=levels, coarse_inv=jnp.asarray(coarse),
                      omega=omega, nu_pre=nu_pre, nu_post=nu_post)
