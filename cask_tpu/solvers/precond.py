"""Preconditioners beyond ILU(0).

All device-resident callables ``r → M⁻¹r`` compatible with the Krylov
solvers.  ILU(0) (the strongest of these) lives in
:mod:`cask_tpu.ops.ilu`; these lighter ones need no factorization and
work distributed (Jacobi is embarrassingly parallel; block-Jacobi's
blocks live within shards).

**Which to use.** *Level-scheduled* (exact) triangular solves — and
therefore the exact ILU(0)/IC(0)/SSOR applies — serialize into ~2·√n
scan steps whose fixed per-step cost never amortizes on a wide
accelerator.  The usable ILU apply is ``method='jacobi'``
(Jacobi–Richardson sweep solves, each sweep one SpMV-class parallel
op); it pays when it cuts iterations by more than its per-iteration
overhead, which anisotropic and line-coupled systems do.  Default to
:func:`jacobi` / :func:`block_jacobi` / :func:`chebyshev_precond` on
well-conditioned isotropic problems; reach for
``ilu0(a).jacobi_applier(sweeps=2)`` on anisotropic systems.  Keep
``method='levels'`` for correctness tests, small systems, and many-RHS
batches.

**AMG:** the routed + factored V-cycle cuts iterations to O(10)
without degrading under anisotropy.  Hold ONE jitted solve with the
hierarchy passed as a pytree ARGUMENT — a solve that closes over the
hierarchy re-traces and re-hashes it as inline constants at every
call::

    solve = jax.jit(lambda b, M: cg(op, b, tol=1e-6, M=M).x)
    x = solve(b, M)      # compiles once
    x = solve(b2, M)     # warm

AMG-PCG in this form is the recommendation at ≥1M rows whenever more
than one solve amortizes the setup + compile; jacobi/ILU-jac remain the
zero-setup defaults for one-shot solves and small systems.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from cask_tpu.formats.matrix import CSR

# f32 contractions stay f32: the GPU would otherwise run them in TF32
_HIGHEST = jax.lax.Precision.HIGHEST


def extract_diagonal(a: CSR) -> np.ndarray:
    indptr = np.asarray(a.indptr, dtype=np.int64)
    indices = np.asarray(a.indices, dtype=np.int64)
    data = np.asarray(a.data)
    n = min(a.shape)
    rows = np.repeat(np.arange(a.shape[0], dtype=np.int64), np.diff(indptr))
    on = (rows == indices) & (rows < n)
    d = np.zeros(n, dtype=data.dtype)
    d[rows[on]] = data[on]
    return d


def jacobi(a: CSR):
    """Diagonal (Jacobi) preconditioner: ``r → r / diag(A)``."""
    d = extract_diagonal(a)
    if np.any(d == 0):
        raise ValueError("Jacobi preconditioner requires a nonzero diagonal")
    inv = jnp.asarray(1.0 / d)

    def apply(r):
        if r.ndim == 1:
            return r * inv
        return r * inv[:, None]

    return apply


def block_jacobi(a: CSR, block: int = 64):
    """Dense-inverted diagonal blocks: ``r → blkdiag(A)⁻¹ r``.

    Blocks are inverted once on the host (LU), applied as a batched
    matmul on device — shard-local when ``block``
    divides the partition size.
    """
    n = a.shape[0]
    nb = -(-n // block)
    dense = np.zeros((nb, block, block), dtype=np.asarray(a.data).dtype)
    indptr = np.asarray(a.indptr, dtype=np.int64)
    indices = np.asarray(a.indices, dtype=np.int64)
    data = np.asarray(a.data)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    inblk = rows // block == indices // block
    r, c, v = rows[inblk], indices[inblk], data[inblk]
    dense[r // block, r % block, c % block] = v
    for b in range(nb):
        hi = min(block, n - b * block)
        blk = dense[b, :hi, :hi]
        if np.any(np.diag(blk) == 0):
            np.fill_diagonal(blk, np.where(np.diag(blk) == 0, 1.0, np.diag(blk)))
        dense[b, :hi, :hi] = np.linalg.inv(blk)
        if hi < block:  # identity on padding
            for i in range(hi, block):
                dense[b, i, i] = 1.0
    inv = jnp.asarray(dense)

    def apply(r):
        vec = r.ndim == 1
        r2 = r[:, None] if vec else r
        pad = nb * block - n
        rp = jnp.pad(r2, ((0, pad), (0, 0)))
        out = jnp.einsum("bij,bjk->bik", inv, rp.reshape(nb, block, -1),
                         precision=_HIGHEST)
        out = out.reshape(nb * block, -1)[:n]
        return out[:, 0] if vec else out

    return apply



@dataclasses.dataclass(frozen=True)
class IC0Factors:
    """IC(0) factor ``L_c`` with ``A ≈ L_c L_cᵀ`` plus cached solve plans."""

    l: CSR  # lower-triangular Cholesky factor (diag included)
    _lower_plan: object
    _upper_plan: object
    _lower_data: np.ndarray
    _upper_data: np.ndarray

    def apply(self, b, *, method: str = "levels", sweeps: int = 5):
        """Preconditioner solve ``x = L_c⁻ᵀ L_c⁻¹ b`` (jittable, symmetric).

        ``method='jacobi'`` uses sweep solves (see
        :meth:`cask_tpu.ops.ilu.ILU0Factors.apply`)."""
        if method == "jacobi":
            lp, up = self._jacobi_plans()
            return up.solve(lp.solve(b, sweeps=sweeps), sweeps=sweeps)
        y = self._lower_plan.solve(self._lower_data, b)
        return self._upper_plan.solve(self._upper_data, y)

    def jacobi_applier(self, sweeps: int = 5):
        """``r → M⁻¹r`` via Jacobi–Richardson sweep solves (parallel)."""
        lp, up = self._jacobi_plans()
        return lambda r: up.solve(lp.solve(r, sweeps=sweeps), sweeps=sweeps)

    def _jacobi_plans(self):
        cached = getattr(self, "_jacobi_cache", None)
        if cached is None:
            from cask_tpu.formats.convert import from_scipy, to_scipy
            from cask_tpu.ops.trisolve import jacobi_trisolve_plan

            lct = from_scipy(to_scipy(self.l).T.tocsr())
            cached = (jacobi_trisolve_plan(self.l, lower=True, unit_diag=False),
                      jacobi_trisolve_plan(lct, lower=False, unit_diag=False))
            object.__setattr__(self, "_jacobi_cache", cached)
        return cached


def ic0(a: CSR) -> IC0Factors:
    """Incomplete Cholesky IC(0) for SPD ``a`` with a symmetric pattern.

    Built through the algebraic identity that ILU(0) on a symmetric
    matrix/pattern yields ``U = D Lᵀ``, hence ``L_c = L D^{1/2}``
    satisfies ``A ≈ L_c L_cᵀ`` on A's pattern (cask analog: the classic
    CG-preconditioner pairing for the R7 solver path).  Unlike raw
    ILU(0) the resulting ``apply`` is a *symmetric* operator, the form
    CG and MINRES actually require of ``M``; it reuses the
    level-scheduled trisolve plans, so the device program is identical
    in cost to the ILU(0) apply.

    Raises if a pivot is nonpositive (matrix not SPD-compatible on its
    own pattern) — fall back to :func:`cask_tpu.ops.ilu.ilu0` then.
    """
    from cask_tpu.formats.convert import from_scipy, to_scipy
    from cask_tpu.ops.ilu import ilu0
    from cask_tpu.ops.trisolve import trisolve_plan

    f = ilu0(a)
    low, up = f.split()  # L has an explicit unit diagonal; U carries D
    d = extract_diagonal(up)
    if np.any(d <= 0):
        raise ValueError(
            "IC(0): nonpositive pivot — matrix is not SPD on its own pattern")
    sq = np.sqrt(d)
    lc = CSR(
        data=np.asarray(low.data) * sq[np.asarray(low.indices, dtype=np.int64)],
        indices=low.indices,
        indptr=low.indptr,
        shape=low.shape,
    )
    lct = from_scipy(to_scipy(lc).T.tocsr())  # host planning only
    lp = trisolve_plan(lc, lower=True, unit_diag=False)
    upl = trisolve_plan(lct, lower=False, unit_diag=False)
    return IC0Factors(l=lc, _lower_plan=lp, _upper_plan=upl,
                      _lower_data=np.asarray(lc.data),
                      _upper_data=np.asarray(lct.data))


def ssor(a: CSR, omega: float = 1.0):
    """SSOR preconditioner ``M = (D+ωL) D⁻¹ (D+ωU) / (ω(2−ω))``.

    Factorization-free (uses A's own triangles, so it never breaks down
    where ILU can), symmetric for symmetric A, and one knob: ω ∈ (0, 2),
    ω = 1 giving symmetric Gauss–Seidel.  The apply is two
    level-scheduled triangular sweeps plus a diagonal scale — the same
    device program shape as the ILU(0)/IC(0) applies, without the host
    factorization cost (useful when the matrix values change every
    solve but the pattern is fixed).
    """
    if not 0.0 < omega < 2.0:
        raise ValueError("SSOR requires 0 < omega < 2")
    from cask_tpu.formats.convert import coo_from_arrays, coo_to_csr
    from cask_tpu.ops.trisolve import trisolve_plan

    indptr = np.asarray(a.indptr, dtype=np.int64)
    indices = np.asarray(a.indices, dtype=np.int64)
    data = np.asarray(a.data)
    n = a.shape[0]
    d = extract_diagonal(a)
    if np.any(d == 0):
        raise ValueError("SSOR requires a nonzero diagonal")
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    diag_idx = np.arange(n, dtype=np.int64)

    def tri(strict_mask):
        r = np.concatenate([rows[strict_mask], diag_idx])
        c = np.concatenate([indices[strict_mask], diag_idx])
        v = np.concatenate([omega * data[strict_mask], d])
        return coo_to_csr(coo_from_arrays(v, r, c, a.shape), sum_duplicates=False)

    low = tri(indices < rows)
    up = tri(indices > rows)
    lowplan = trisolve_plan(low, lower=True, unit_diag=False)
    upplan = trisolve_plan(up, lower=False, unit_diag=False)
    low_data = np.asarray(low.data)
    up_data = np.asarray(up.data)
    dj = jnp.asarray(d)
    scale = omega * (2.0 - omega)

    def apply(r):
        y = lowplan.solve(low_data, r)
        y = y * dj if y.ndim == 1 else y * dj[:, None]
        return scale * upplan.solve(up_data, y)

    return apply


def _stack_tri_plans(plans, datas):
    """Pad per-shard :class:`TriSolvePlan`s to common shapes and stack.

    Structural-zero discipline carries over: padded levels solve row n
    (the drop slot), padded entries are invalid, padded data is 1.0.
    Returns (arrays dict, static dims dict)."""
    nl = max(p.nlevels for p in plans)
    mr = max(max(p.max_rows for p in plans), 1)
    me = max(max(p.max_ents for p in plans), 1)
    n = plans[0].n
    nd = max(max(d.shape[0] for d in datas), 1)
    P = len(plans)

    rows = np.full((P, nl, mr), n, dtype=np.int32)
    diag = np.zeros((P, nl, mr), dtype=np.int32)
    entl = np.full((P, nl, me), mr, dtype=np.int32)
    entc = np.full((P, nl, me), n, dtype=np.int32)
    enti = np.zeros((P, nl, me), dtype=np.int32)
    entv = np.zeros((P, nl, me), dtype=bool)
    data = np.ones((P, nd), dtype=np.asarray(datas[0]).dtype)
    for s, (p, d) in enumerate(zip(plans, datas)):
        if p.nlevels == 0:
            continue
        rows[s, : p.nlevels, : p.max_rows] = p.lvl_rows
        diag[s, : p.nlevels, : p.max_rows] = p.lvl_diag_idx
        # remap the plan's own pad sentinel (its max_rows) to the common one
        entl[s, : p.nlevels, : p.max_ents] = np.where(
            p.lvl_ent_valid, p.lvl_ent_local, mr)
        entc[s, : p.nlevels, : p.max_ents] = np.where(
            p.lvl_ent_valid, p.lvl_ent_col, n)
        enti[s, : p.nlevels, : p.max_ents] = p.lvl_ent_idx
        entv[s, : p.nlevels, : p.max_ents] = p.lvl_ent_valid
        data[s, : d.shape[0]] = d
    arrays = dict(rows=rows, diag=diag, entl=entl, entc=entc, enti=enti,
                  entv=entv, data=data)
    return arrays, dict(n=n, max_rows=mr, unit_diag=plans[0].unit_diag)


def shard_ilu0(a: CSR, dist):
    """Additive-Schwarz block ILU(0): each shard factors its own diagonal
    block ``A_ss`` and applies ``U_s⁻¹ L_s⁻¹`` locally — zero
    communication, one SPMD program for all shards (plans padded to
    common shapes and stacked over the mesh axis).

    ``dist`` is a :class:`cask_tpu.parallel.DistSpmv`; the returned
    callable preconditions its *padded* vectors (use with
    ``cg(dist.padded_op, bp, M=shard_ilu0(a, dist))``).  Needs A's
    diagonal present in every local block (true whenever A has a full
    diagonal).  cask analog: SURVEY.md §2 T7 — the distributed twin of
    the ILU solver path.
    """
    import scipy.sparse as sp

    import jax
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cask_tpu.formats.convert import from_scipy, to_scipy
    from cask_tpu.ops.ilu import ilu0
    from cask_tpu.ops.trisolve import tri_solve_arrays
    from cask_tpu.parallel.dist import AXIS

    plan = dist.plan
    mesh = dist.mesh
    nshards, mloc = plan.nshards, plan.mloc
    m = a.shape[0]
    spa = to_scipy(a).tocsr()

    lows, ups, ldat, udat = [], [], [], []
    for s in range(nshards):
        r0, r1 = s * mloc, min((s + 1) * mloc, m)
        if r1 > r0:
            blk = spa[r0:r1, r0:r1].tocsr()
        else:
            blk = sp.csr_matrix((0, 0))
        pad = mloc - blk.shape[0]
        if pad:
            blk = sp.block_diag([blk, sp.identity(pad, format="csr")],
                                format="csr")
        blk.sort_indices()
        f = ilu0(from_scipy(blk, format="csr"))
        lows.append(f._lower_plan)
        ups.append(f._upper_plan)
        ldat.append(f._lower_data)
        udat.append(f._upper_data)

    larr, lstat = _stack_tri_plans(lows, ldat)
    uarr, ustat = _stack_tri_plans(ups, udat)

    def put(d):
        return {k: jax.device_put(jnp.asarray(v),
                                  NamedSharding(mesh, P(AXIS, *([None] * (v.ndim - 1)))))
                for k, v in d.items()}

    larr_d, uarr_d = put(larr), put(uarr)

    def local(la, ua, r):
        def solve(ar, st, b):
            return tri_solve_arrays(
                ar["data"][0], b, ar["rows"][0], ar["diag"][0],
                ar["entl"][0], ar["entc"][0], ar["enti"][0], ar["entv"][0],
                **st)

        y = solve(la, lstat, r)
        return solve(ua, ustat, y)

    vec_spec = P(AXIS)
    arr_specs = jax.tree.map(lambda _: P(AXIS), larr)
    fn = jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(arr_specs, arr_specs, vec_spec),
        out_specs=vec_spec,
        check_vma=False,  # scan carry starts unvarying (as in DistSpmv)
    ))
    fn_mm = jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(arr_specs, arr_specs, P(AXIS, None)),
        out_specs=P(AXIS, None),
        check_vma=False,
    ))

    def apply(r):
        if r.ndim == 1:
            return fn(larr_d, uarr_d, r)
        return fn_mm(larr_d, uarr_d, r)

    return apply


def estimate_lmax(a, n: int, *, iters: int = 20, seed: int = 0):
    """Largest-eigenvalue estimate by power iteration (device, jittable).

    ``a`` is a matrix or an ``x → A@x`` callable over length-``n``
    vectors.  Returns a slightly inflated float (×1.05 safety) suitable
    as the ``lmax`` bound for Chebyshev methods.
    """
    import jax

    from cask_tpu.ops.spmv import spmv

    op = a if callable(a) and not hasattr(a, "shape") else (lambda v: spmv(a, v))

    def run(v0):
        def body(_, v):
            w = op(v)
            return (w / jnp.linalg.norm(w)).astype(v0.dtype)

        v = jax.lax.fori_loop(0, iters, body, v0)
        return jnp.vdot(v, op(v)) / jnp.vdot(v, v)

    v0 = jax.random.normal(jax.random.PRNGKey(seed), (n,), jnp.float32)
    return float(run(v0)) * 1.05


def lanczos_extremal(a, n: int, *, iters: int = 30, seed: int = 0):
    """Extremal-eigenvalue estimates ``(lmin, lmax)`` for symmetric ``a``.

    ``iters``-step Lanczos tridiagonalization with full
    reorthogonalization against the stored basis, run as one jitted
    ``lax.scan`` on device (static shapes), ending in an
    ``eigvalsh`` of the small tridiagonal Ritz matrix.  Unlike
    :func:`estimate_lmax` this also bounds the *bottom* of the spectrum,
    which Chebyshev methods need.  The returned pair is nudged outward
    (lmin ×0.95, lmax ×1.05) so it is directly usable as
    :func:`chebyshev_precond` / :func:`~cask_tpu.solvers.chebyshev`
    bounds.  Ritz values converge to extremal eigenvalues first, so
    ``lmax`` is accurate within a few percent at ``iters≈30``; ``lmin``
    of ill-conditioned operators converges more slowly and lands above
    the true minimum — acceptable for preconditioning, not a rigorous
    bound.  On exact breakdown (Krylov space smaller than ``iters``)
    trailing Ritz values are spurious zeros, which only makes the
    bounds more conservative for positive-definite operators.
    """
    import jax

    from cask_tpu.ops.spmv import spmv

    op = a if callable(a) and not hasattr(a, "shape") else (lambda v: spmv(a, v))
    m = int(min(iters, n))

    def run(v0):
        v0 = v0 / jnp.linalg.norm(v0)
        basis = jnp.zeros((m + 1, v0.shape[0]), v0.dtype).at[0].set(v0)

        def step(carry, j):
            V, beta_prev = carry
            vj = V[j]
            w = op(vj).astype(v0.dtype) - beta_prev * V[j - 1]
            alpha = jnp.vdot(vj, w)
            w = w - alpha * vj
            # full reorthogonalization (masked to the filled rows)
            mask = (jnp.arange(m + 1) <= j).astype(v0.dtype)
            w = w - jnp.matmul(V.T, jnp.matmul(V, w, precision=_HIGHEST) * mask,
                               precision=_HIGHEST)
            beta = jnp.linalg.norm(w)
            V = V.at[j + 1].set(w / jnp.where(beta == 0, 1, beta))
            return (V, beta), (alpha, beta)

        _, (alphas, betas) = jax.lax.scan(
            step, (basis, jnp.zeros((), v0.dtype)), jnp.arange(m))
        t = (jnp.diag(alphas)
             + jnp.diag(betas[:-1], 1)
             + jnp.diag(betas[:-1], -1))
        return jnp.linalg.eigvalsh(t)

    dt = a.dtype if hasattr(a, "dtype") else jnp.float32
    v0 = jax.random.normal(jax.random.PRNGKey(seed), (n,), dt)
    evals = np.asarray(jax.jit(run)(v0))
    lmin, lmax = float(evals[0]), float(evals[-1])
    lmin *= 0.95 if lmin > 0 else 1.05
    lmax *= 1.05 if lmax > 0 else 0.95
    return lmin, lmax


def chebyshev_precond(a, *, lmin: float, lmax: float, degree: int = 8,
                      M=None):
    """Polynomial preconditioner: ``r → p(A) r ≈ A⁻¹ r`` via a fixed
    number of Chebyshev steps (no inner products, no triangular solves).

    The parallel alternative to ILU where level-scheduled trisolve is
    latency-bound (deep wavefronts on large grids): every application is
    ``degree`` SpMVs + axpys, fully parallel, and distributes with zero
    extra collectives.  Fixed ``degree`` makes the operator *linear and
    SPD*, so it is a valid CG preconditioner.  ``M`` is an optional
    inner preconditioner (e.g. :func:`jacobi`) applied inside each step.
    """
    from cask_tpu.ops.spmv import spmv

    op = a if callable(a) and not hasattr(a, "shape") else (lambda v: spmv(a, v))
    inner = M or (lambda r: r)
    theta = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0

    def apply(r):
        x = jnp.zeros_like(r)
        alpha = 1.0 / theta
        d = inner(r) * alpha
        rr = r
        for _ in range(degree):
            x = x + d
            rr = rr - op(d)
            beta = (delta * alpha / 2.0) ** 2
            alpha_new = 1.0 / (theta - beta / alpha)
            d = alpha_new * (inner(rr) + beta * d / alpha)
            alpha = alpha_new
        return x + d

    return apply
