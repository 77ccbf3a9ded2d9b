"""Iterative Krylov solvers: CG, block CG, pipelined CG, BiCGStab,
MINRES, GMRES(m), CGLS, Chebyshev, and mixed-precision iterative
refinement.

cask analog: the CG-flavored solver demo (SURVEY.md §2 R7, §3.3).  The
design lesson from cask's call stack applies directly: cask paid a PCIe
round-trip per iteration for the host-side vector ops; here the *entire*
iteration loop is one jitted ``lax.while_loop``, so SpMV, dots, axpys and
the preconditioner solve all stay device-resident, and only the final
(x, stats) leave the chip.

``a`` may be a cask_tpu matrix (CSR/COO/BSR — :func:`cask_tpu.spmv` is
used) or any callable ``x -> A@x`` (e.g. a tuned kernel or a distributed
``shard_map`` SpMV).  ``M`` is an optional preconditioner callable
``r -> M⁻¹r`` (e.g. :meth:`cask_tpu.ops.ilu.ILU0Factors.apply`).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from cask_tpu.ops.spmm import spmm
from cask_tpu.ops.spmv import spmv

# f32 products stay f32: the GPU would otherwise run them in TF32
_mm = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)


@dataclasses.dataclass
class SolveResult:
    x: jax.Array
    iterations: jax.Array  # int32
    residual_norm: jax.Array  # ||b - A x||₂ estimate at exit
    converged: jax.Array  # bool


jax.tree_util.register_dataclass(
    SolveResult, data_fields=["x", "iterations", "residual_norm", "converged"], meta_fields=[]
)


def _as_operator(a) -> Callable:
    if callable(a) and not hasattr(a, "shape"):
        return a
    return lambda v: spmv(a, v)


def _ident(r):
    return r


def cg(a, b, *, x0=None, tol: float = 1e-8, atol: float = 0.0, maxiter: int = 1000,
       M: Optional[Callable] = None) -> SolveResult:
    """Conjugate gradients for SPD ``a`` (optionally preconditioned)."""
    op = _as_operator(a)
    M = M or _ident
    b = jnp.asarray(b)
    x0 = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)

    bnorm = jnp.linalg.norm(b)
    target = jnp.maximum(tol * bnorm, atol).astype(b.dtype)

    r0 = b - op(x0)
    z0 = M(r0)
    p0 = z0
    rz0 = jnp.vdot(r0, z0)

    def cond(state):
        _, r, _, _, k = state
        return (jnp.linalg.norm(r) > target) & (k < maxiter)

    def body(state):
        x, r, p, rz, k = state
        ap = op(p)
        alpha = rz / jnp.vdot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = M(r)
        rz_new = jnp.vdot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        return (x, r, p, rz_new, k + 1)

    x, r, _, _, k = jax.lax.while_loop(cond, body, (x0, r0, p0, rz0, jnp.int32(0)))
    rn = jnp.linalg.norm(r)
    return SolveResult(x=x, iterations=k, residual_norm=rn, converged=rn <= target)


def block_cg(a, b, *, x0=None, tol: float = 1e-8, atol: float = 0.0,
             maxiter: int = 1000, M: Optional[Callable] = None) -> SolveResult:
    """Block CG (O'Leary 1980) for SPD ``a`` with ``s`` right-hand sides.

    ``b`` is (n, s).  All RHS share one Krylov iteration: the per-step
    SpMV becomes an SpMM (:func:`cask_tpu.spmm`, amortizing the matrix
    stream over ``s`` vectors), and the recurrence coefficients are tiny
    (s, s) dense solves.  The shared block Krylov space also converges in
    fewer iterations than ``s`` independent CG runs whenever the RHS
    overlap spectrally.

    Caveat: when individual columns converge much earlier than others the
    (s, s) Gram matrices go ill-conditioned; the recurrence solves use
    ``lstsq`` so the iteration degrades gracefully instead of emitting
    NaNs, but for wildly heterogeneous RHS prefer separate :func:`cg`
    calls.  ``M`` must accept (n, s) blocks (``jacobi``/``block_jacobi``/
    ILU plans all do — the trisolve sweep batches over trailing axes).
    """
    if callable(a) and not hasattr(a, "shape"):
        op = a
    else:
        op = lambda v: spmm(a, v)  # noqa: E731
    M = M or _ident
    b = jnp.asarray(b)
    if b.ndim != 2:
        raise ValueError("block_cg expects b of shape (n, s); use cg for one RHS")
    x0 = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)

    bnorms = jnp.linalg.norm(b, axis=0)
    target = jnp.maximum(tol * bnorms, atol).astype(b.dtype)

    r0 = b - op(x0)
    z0 = M(r0)
    p0 = z0
    s0 = _mm(r0.conj().T, z0)  # (s, s)

    def _solve_small(g, rhs):
        return jnp.linalg.lstsq(g, rhs)[0]

    def cond(st):
        _, r, _, _, k = st
        return jnp.any(jnp.linalg.norm(r, axis=0) > target) & (k < maxiter)

    def body(st):
        x, r, p, s, k = st
        q = op(p)
        alpha = _solve_small(_mm(p.conj().T, q), s)
        x = x + _mm(p, alpha)
        r = r - _mm(q, alpha)
        z = M(r)
        s_new = _mm(r.conj().T, z)
        beta = _solve_small(s, s_new)
        p = z + _mm(p, beta)
        return (x, r, p, s_new, k + 1)

    x, r, _, _, k = jax.lax.while_loop(cond, body, (x0, r0, p0, s0, jnp.int32(0)))
    rns = jnp.linalg.norm(r, axis=0)
    return SolveResult(x=x, iterations=k, residual_norm=jnp.max(rns),
                       converged=jnp.all(rns <= target))


def pipelined_cg(a, b, *, x0=None, tol: float = 1e-8, atol: float = 0.0,
                 maxiter: int = 1000, M: Optional[Callable] = None) -> SolveResult:
    """Pipelined PCG (Ghysels & Vanroose 2014) — one overlappable
    reduction phase per iteration.

    Standard PCG has two *dependent* inner products per iteration; on a
    device mesh each is a global ``psum`` that serializes against the
    halo-exchange SpMV.  The pipelined recurrences compute both dots
    (``gamma``, ``delta``) from vectors available *before* the
    iteration's SpMV + preconditioner applications, so under
    ``shard_map`` XLA can schedule the cross-chip reduction concurrently
    with the SpMV — the solver-level analog of the interior/halo overlap
    in :class:`cask_tpu.parallel.DistSpmv`.  Cost: four extra axpy-class
    vector updates per iteration (bandwidth-cheap next to the SpMV) and
    mildly weaker residual-recurrence stability; for tight tolerances on
    ill-conditioned systems prefer :func:`cg`.
    """
    op = _as_operator(a)
    M = M or _ident
    b = jnp.asarray(b)
    x0 = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)

    bnorm = jnp.linalg.norm(b)
    target = jnp.maximum(tol * bnorm, atol).astype(b.dtype)

    r0 = b - op(x0)
    u0 = M(r0)
    w0 = op(u0)
    zeros = jnp.zeros_like(b)
    one = jnp.ones((), b.dtype)

    # carry: x, r, u, w, z(=A q-dir), q, p, s(=A p), gamma_old, alpha_old, k
    st0 = (x0, r0, u0, w0, zeros, zeros, zeros, zeros, one, one, jnp.int32(0))

    def cond(st):
        r, k = st[1], st[10]
        return (jnp.linalg.norm(r) > target) & (k < maxiter)

    def body(st):
        x, r, u, w, z, q, p, s, gamma_old, alpha_old, k = st
        gamma = jnp.vdot(r, u)
        delta = jnp.vdot(w, u)
        m = M(w)
        n_ = op(m)
        beta = jnp.where(k == 0, jnp.zeros((), b.dtype), gamma / gamma_old)
        alpha = gamma / (delta - beta * gamma / alpha_old)
        z = n_ + beta * z
        q = m + beta * q
        p = u + beta * p
        s = w + beta * s
        x = x + alpha * p
        r = r - alpha * s
        u = u - alpha * q
        w = w - alpha * z
        return (x, r, u, w, z, q, p, s, gamma, alpha, k + 1)

    st = jax.lax.while_loop(cond, body, st0)
    x, k = st[0], st[10]
    # The recurrence residual drifts from b - A·x over long runs; pay one
    # SpMV outside the loop so the reported norm/converged flag reflect
    # the *true* residual.
    rn = jnp.linalg.norm(b - op(x))
    return SolveResult(x=x, iterations=k, residual_norm=rn, converged=rn <= target)


def bicgstab(a, b, *, x0=None, tol: float = 1e-8, atol: float = 0.0, maxiter: int = 1000,
             M: Optional[Callable] = None) -> SolveResult:
    """BiCGStab for general (nonsymmetric) ``a``."""
    op = _as_operator(a)
    M = M or _ident
    b = jnp.asarray(b)
    x0 = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)

    bnorm = jnp.linalg.norm(b)
    target = jnp.maximum(tol * bnorm, atol).astype(b.dtype)

    r0 = b - op(x0)
    rhat = r0
    state0 = (
        x0, r0,
        jnp.ones((), b.dtype),  # rho
        jnp.ones((), b.dtype),  # alpha
        jnp.ones((), b.dtype),  # omega
        jnp.zeros_like(b),  # v
        jnp.zeros_like(b),  # p
        jnp.int32(0),
    )

    def cond(st):
        _, r, *_, k = st
        return (jnp.linalg.norm(r) > target) & (k < maxiter)

    def body(st):
        x, r, rho, alpha, omega, v, p, k = st
        rho_new = jnp.vdot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = op(phat)
        alpha = rho_new / jnp.vdot(rhat, v)
        s = r - alpha * v
        shat = M(s)
        t = op(shat)
        omega = jnp.vdot(t, s) / jnp.vdot(t, t)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        return (x, r, rho_new, alpha, omega, v, p, k + 1)

    x, r, *_, k = jax.lax.while_loop(cond, body, state0)
    rn = jnp.linalg.norm(r)
    return SolveResult(x=x, iterations=k, residual_norm=rn, converged=rn <= target)


def chebyshev(a, b, *, lmin: float, lmax: float, x0=None, tol: float = 1e-8,
              atol: float = 0.0, maxiter: int = 1000,
              M: Optional[Callable] = None) -> SolveResult:
    """Chebyshev iteration for SPD ``a`` with spectrum in [lmin, lmax].

    No inner products — every iteration is SpMV + axpys, so on a mesh
    there are *zero* cross-chip reductions (the halo exchange is the only
    communication).  Needs eigenvalue bounds; for diagonally scaled
    Poisson-like operators [lmin, lmax] ≈ [c·h², 2] works.  Convergence
    is checked every iteration against ‖r‖ like CG (that check is the
    only reduction and could be amortized; kept per-iteration for parity
    with the other solvers).
    """
    op = _as_operator(a)
    M = M or _ident
    b = jnp.asarray(b)
    x0 = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)

    bnorm = jnp.linalg.norm(b)
    target = jnp.maximum(tol * bnorm, atol).astype(b.dtype)

    theta = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0

    r0 = b - op(x0)
    # first step
    alpha0 = 1.0 / theta
    d0 = M(r0) * alpha0

    def cond(st):
        _, r, _, _, k = st
        return (jnp.linalg.norm(r) > target) & (k < maxiter)

    def body(st):
        x, r, d, alpha_prev, k = st
        x = x + d
        r = r - op(d)
        beta = (delta * alpha_prev / 2.0) ** 2
        alpha = 1.0 / (theta - beta / alpha_prev)
        d = alpha * (M(r) + beta * d / alpha_prev)
        return (x, r, d, alpha, k + 1)

    st = (x0, r0, d0, jnp.asarray(alpha0, b.dtype), jnp.int32(0))
    x, r, _, _, k = jax.lax.while_loop(cond, body, st)
    rn = jnp.linalg.norm(r)
    return SolveResult(x=x, iterations=k, residual_norm=rn, converged=rn <= target)


def minres(a, b, *, x0=None, tol: float = 1e-8, atol: float = 0.0, maxiter: int = 1000,
           M: Optional[Callable] = None) -> SolveResult:
    """MINRES for symmetric (possibly indefinite) ``a``.

    Lanczos + Givens QR with three-term recurrences — per iteration one
    SpMV, one preconditioner apply, two dots and a handful of axpys, all
    inside one jitted ``lax.while_loop`` like the other solvers.  Where
    CG requires positive definiteness, MINRES only needs symmetry
    (saddle-point systems, shifted Laplacians).  ``M`` must be SPD; the
    convergence test is then on the M⁻¹-norm of the residual (the
    quantity MINRES minimizes), and reduces to ‖r‖₂ when ``M`` is None.
    """
    op = _as_operator(a)
    M = M or _ident
    b = jnp.asarray(b)
    x0 = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)

    r0 = b - op(x0)
    z0 = M(r0)
    gamma0 = jnp.sqrt(jnp.maximum(jnp.vdot(r0, z0), 0))
    target = jnp.maximum(tol * gamma0, atol).astype(b.dtype)
    zeros = jnp.zeros_like(b)
    one = jnp.ones((), b.dtype)
    nil = jnp.zeros((), b.dtype)

    # carry: x, v_old, v, z (=M v, both unnormalized), gamma_old, gamma,
    #        eta (residual estimate), c_old, c, s_old, s, w_old, w, k
    state0 = (x0, zeros, r0, z0, one, gamma0, gamma0,
              one, one, nil, nil, zeros, zeros, jnp.int32(0))

    def cond(st):
        eta, k = st[6], st[13]
        return (jnp.abs(eta) > target) & (k < maxiter)

    def body(st):
        (x, v_old, v, z, gamma_old, gamma, eta,
         c_old, c, s_old, s, w_old, w, k) = st
        g = jnp.where(gamma == 0, 1, gamma)
        zj = z / g
        az = op(zj)
        delta = jnp.vdot(zj, az)
        v_new = az - (delta / g) * v - (gamma / jnp.where(gamma_old == 0, 1, gamma_old)) * v_old
        z_new = M(v_new)
        gamma_new = jnp.sqrt(jnp.maximum(jnp.vdot(z_new, v_new), 0))
        a0 = c * delta - c_old * s * gamma
        a1 = jnp.sqrt(a0 * a0 + gamma_new * gamma_new)
        a2 = s * delta + c_old * c * gamma
        a3 = s_old * gamma
        a1s = jnp.where(a1 == 0, 1, a1)
        c_new = a0 / a1s
        s_new = gamma_new / a1s
        w_new = (zj - a3 * w_old - a2 * w) / a1s
        x = x + c_new * eta * w_new
        eta = -s_new * eta
        return (x, v, v_new, z_new, gamma, gamma_new, eta,
                c, c_new, s, s_new, w, w_new, k + 1)

    st = jax.lax.while_loop(cond, body, state0)
    x, k = st[0], st[13]
    rn = jnp.linalg.norm(b - op(x))
    return SolveResult(x=x, iterations=k, residual_norm=rn,
                       converged=jnp.abs(st[6]) <= target)


def cgls(a, b, *, at: Optional[Callable] = None, x0=None, tol: float = 1e-8,
         atol: float = 0.0, maxiter: int = 1000) -> SolveResult:
    """CGLS: least-squares ``min ‖A x − b‖₂`` for rectangular ``a``.

    Conjugate gradients on the normal equations ``AᵀA x = Aᵀ b`` without
    ever forming ``AᵀA`` — each iteration is one SpMV plus one
    transposed SpMV (:func:`cask_tpu.spmv` with ``transpose=True``; no
    explicit Aᵀ is materialized).  For a callable ``a``, pass the
    transposed operator as ``at``.  Convergence is on the
    normal-equation residual ``‖Aᵀr‖`` relative to ``‖Aᵀb‖``; the
    reported ``residual_norm`` is ``‖Aᵀr‖`` (zero at the least-squares
    solution even when ``‖r‖`` is not).
    """
    if callable(a) and not hasattr(a, "shape"):
        if at is None:
            raise ValueError("cgls with a callable operator requires at= (x -> A^T x)")
        op, opt = a, at
    else:
        from cask_tpu.formats.matrix import BSR, COO, CSR

        if isinstance(a, (CSR, COO, BSR)):
            # index-swap transpose: zero-cost per trace AND fully
            # traceable, so a jit-wrapped cgls works on these formats
            # (transposed() does host-side re-encoding)
            op = lambda v: spmv(a, v)  # noqa: E731
            opt = lambda v: spmv(a, v, transpose=True)  # noqa: E731
        else:
            from cask_tpu.ops.spmv import transposed

            a_t = transposed(a)  # plan types: build A^T once, not per trace
            op = lambda v: spmv(a, v)  # noqa: E731
            opt = lambda v: spmv(a_t, v)  # noqa: E731

    b = jnp.asarray(b)
    s_b = opt(b)
    x0 = jnp.zeros_like(s_b) if x0 is None else jnp.asarray(x0)
    target = jnp.maximum(tol * jnp.linalg.norm(s_b), atol).astype(b.dtype)

    r0 = b - op(x0)
    s0 = opt(r0)
    p0 = s0
    gamma0 = jnp.vdot(s0, s0)

    def cond(st):
        _, _, _, gamma, k = st
        return (jnp.sqrt(gamma) > target) & (k < maxiter)

    def body(st):
        x, r, p, gamma, k = st
        q = op(p)
        alpha = gamma / jnp.vdot(q, q)
        x = x + alpha * p
        r = r - alpha * q
        s = opt(r)
        gamma_new = jnp.vdot(s, s)
        p = s + (gamma_new / gamma) * p
        return (x, r, p, gamma_new, k + 1)

    x, r, _, gamma, k = jax.lax.while_loop(
        cond, body, (x0, r0, p0, gamma0, jnp.int32(0)))
    rn = jnp.sqrt(gamma)
    return SolveResult(x=x, iterations=k, residual_norm=rn, converged=rn <= target)


def ir_solve(a, b, *, work_dtype=jnp.float32, tol: float = 1e-12, atol: float = 0.0,
             maxiter: int = 20, inner: str = "cg", inner_tol: float = 1e-5,
             inner_maxiter: int = 300, M: Optional[Callable] = None) -> SolveResult:
    """Mixed-precision iterative refinement: f64 accuracy at f32 speed.

    The dtype story (SURVEY.md §7 hard-part (e)): SpMV is bound by the
    bytes it streams, so the correction solve runs entirely in
    ``work_dtype`` (f32 by default — half the bytes of f64), while the
    residual ``r = b − A x`` is recomputed in the precision of ``b``
    (f64 under x64) each outer step.  Classic Wilkinson refinement: as long as the
    inner solver contracts the error at all, the outer loop converges to
    working-precision accuracy of the *high*-precision system.  The
    whole nest (outer while_loop, inner Krylov while_loop) is one jitted
    device-resident program.

    ``a`` must be a cask_tpu matrix (both precisions are needed; the
    low-precision copy is built with :meth:`astype`).  ``M`` is an
    optional preconditioner for the inner solver, built at
    ``work_dtype``.  ``iterations`` counts outer refinement steps.
    """
    if callable(a) and not hasattr(a, "shape"):
        raise ValueError("ir_solve needs a matrix (it builds a low-precision copy)")
    b = jnp.asarray(b)
    a_lo = a.astype(work_dtype)
    inner_fn = {"cg": cg, "bicgstab": bicgstab, "minres": minres}[inner]

    op_hi = lambda v: spmv(a, v)  # noqa: E731
    bnorm = jnp.linalg.norm(b)
    target = jnp.maximum(tol * bnorm, atol).astype(b.dtype)

    def cond(st):
        _, r, k = st
        return (jnp.linalg.norm(r) > target) & (k < maxiter)

    def body(st):
        x, r, k = st
        d = inner_fn(a_lo, r.astype(work_dtype), tol=inner_tol,
                     maxiter=inner_maxiter, M=M).x
        x = x + d.astype(b.dtype)
        r = b - op_hi(x)
        return (x, r, k + 1)

    x0 = jnp.zeros_like(b)
    x, r, k = jax.lax.while_loop(cond, body, (x0, b, jnp.int32(0)))
    rn = jnp.linalg.norm(r)
    return SolveResult(x=x, iterations=k, residual_norm=rn, converged=rn <= target)


def gmres(a, b, *, x0=None, tol: float = 1e-8, atol: float = 0.0, restart: int = 32,
          maxiter: int = 50, M: Optional[Callable] = None) -> SolveResult:
    """Restarted GMRES(m) with (left-preconditioned) Arnoldi, fully jitted.

    ``maxiter`` counts outer restarts.  The Krylov basis is a fixed
    (restart+1, n) buffer — static shapes for XLA; the least-squares
    problem per restart is solved densely on device.
    """
    op = _as_operator(a)
    M = M or _ident
    b = jnp.asarray(b)
    n = b.shape[0]
    x0 = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)
    m = restart

    bnorm = jnp.linalg.norm(M(b))
    target = jnp.maximum(tol * bnorm, atol).astype(b.dtype)

    def arnoldi_cycle(x):
        r = M(b - op(x))
        beta = jnp.linalg.norm(r)
        V = jnp.zeros((m + 1, n), b.dtype).at[0].set(r / jnp.where(beta == 0, 1, beta))
        H = jnp.zeros((m + 1, m), b.dtype)

        def step(carry, j):
            V, H = carry
            w = M(op(V[j]))
            # modified Gram–Schmidt against all basis vectors (masked > j)
            mask = (jnp.arange(m + 1) <= j).astype(b.dtype)

            def mgs(carry_w, i):
                w = carry_w
                h = jnp.vdot(V[i], w) * mask[i]
                w = w - h * V[i]
                return w, h

            w, hcol = jax.lax.scan(mgs, w, jnp.arange(m + 1))
            hnorm = jnp.linalg.norm(w)
            H = H.at[:, j].set(hcol)
            H = H.at[j + 1, j].set(hnorm)
            V = V.at[j + 1].set(w / jnp.where(hnorm == 0, 1, hnorm))
            return (V, H), None

        (V, H), _ = jax.lax.scan(step, (V, H), jnp.arange(m))
        # solve min ‖beta e1 − H y‖ via normal equations on the small system
        e1 = jnp.zeros(m + 1, b.dtype).at[0].set(beta)
        y = jnp.linalg.lstsq(H, e1)[0]
        x_new = x + _mm(V[:m].T, y)
        return x_new

    def cond(st):
        x, k = st
        r = M(b - op(x))
        return (jnp.linalg.norm(r) > target) & (k < maxiter)

    def body(st):
        x, k = st
        return (arnoldi_cycle(x), k + 1)

    x, k = jax.lax.while_loop(cond, body, (x0, jnp.int32(0)))
    rn = jnp.linalg.norm(b - op(x))
    return SolveResult(x=x, iterations=k, residual_norm=rn, converged=rn <= jnp.maximum(tol * jnp.linalg.norm(b), atol))
