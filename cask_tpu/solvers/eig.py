"""LOBPCG: locally optimal block preconditioned conjugate gradient
eigensolver for SPD operators.

cask analog: none directly (cask's solver path stops at CG, SURVEY.md §2
R7) — but eigenvalue estimates feed the Chebyshev solver/preconditioner
(:func:`cask_tpu.solvers.chebyshev_precond`) and AMG smoother scaling,
and LOBPCG is the standard sparse eigensolver built from exactly the
pieces this framework accelerates: one block SpMM per iteration (k vectors amortizing the matrix stream)
plus small
dense (3k, 3k) Rayleigh–Ritz problems solved on device.

Design notes: the whole iteration is one jitted ``lax.while_loop``
with static (n, 3k) basis buffers; the basis is whitened each step via
an eigendecomposition of the (3k, 3k) overlap matrix with *pseudo-inverse*
handling of degenerate directions (the first iteration's empty P block,
converged ritz vectors), the deflated directions being pushed out of the
Ritz window with a ±LARGE diagonal penalty instead of dynamic shapes.
Only one operator application (width-k SpMM) happens per iteration:
``A·X_new`` and ``A·P_new`` are recovered as linear combinations of the
already-computed ``A·S``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from cask_tpu.ops.spmm import spmm

# f32 products stay f32: the GPU would otherwise run them in TF32
_mm = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)

_PENALTY = 1e30


@dataclasses.dataclass
class EigResult:
    theta: jax.Array  # (k,) Ritz values, ascending
    x: jax.Array  # (n, k) Ritz vectors
    iterations: jax.Array  # int32
    residual_norm: jax.Array  # max_i ‖A xᵢ − θᵢ xᵢ‖₂ at exit
    converged: jax.Array  # bool


jax.tree_util.register_dataclass(
    EigResult,
    data_fields=["theta", "x", "iterations", "residual_norm", "converged"],
    meta_fields=[],
)


def _as_block_operator(a) -> Callable:
    if callable(a) and not hasattr(a, "shape"):
        return a
    return lambda v: spmm(a, v)


def lobpcg(a, x0, *, largest: bool = False, tol: float = 1e-6,
           maxiter: int = 200, M: Optional[Callable] = None) -> EigResult:
    """Compute the ``k`` smallest (or largest) eigenpairs of SPD ``a``.

    ``x0`` is the (n, k) initial block — its column count fixes ``k``
    (static shapes; pass ``np.random.standard_normal((n, k))`` when no
    better guess exists).  ``a`` may be a cask_tpu matrix (SpMM is used)
    or a callable ``V → A @ V`` over (n, k) blocks; ``M`` is an optional
    preconditioner callable ``R → T R`` with ``T ≈ A⁻¹`` (e.g.
    :func:`cask_tpu.solvers.ic0`'s ``.apply`` or an AMG V-cycle) — it
    accelerates the *smallest* eigenpairs, which is the hard direction.

    Convergence: ``‖A xᵢ − θᵢ xᵢ‖ ≤ tol · max(1, |θᵢ|)`` for all i.
    """
    op = _as_block_operator(a)
    M = M or (lambda r: r)
    x0 = jnp.asarray(x0)
    if x0.ndim != 2:
        raise ValueError("lobpcg expects x0 of shape (n, k)")
    n, k = x0.shape
    if 3 * k >= n:
        raise ValueError(f"lobpcg basis 3k={3 * k} must be < n={n}; shrink the block")
    dt = x0.dtype
    eps = jnp.finfo(dt).eps

    x0, _ = jnp.linalg.qr(x0)
    ax0 = op(x0)
    theta0 = jnp.sum(x0 * ax0, axis=0)  # Rayleigh quotients of orthonormal X
    zeros = jnp.zeros_like(x0)

    def _residual(xb, axb, th):
        return axb - xb * th[None, :]

    def _targets(th):
        return tol * jnp.maximum(1.0, jnp.abs(th))

    def cond(st):
        xb, axb, _, _, th, it = st
        r = _residual(xb, axb, th)
        return jnp.any(jnp.linalg.norm(r, axis=0) > _targets(th)) & (it < maxiter)

    def body(st):
        xb, axb, pb, apb, th, it = st
        w = M(_residual(xb, axb, th))
        aw = op(w)
        s = jnp.concatenate([xb, w, pb], axis=1)  # (n, 3k)
        a_s = jnp.concatenate([axb, aw, apb], axis=1)

        o = _mm(s.T, s)
        g = _mm(s.T, a_s)
        g = 0.5 * (g + g.T)

        # pseudo-inverse whitening of the basis: drop degenerate
        # directions (empty P on the first step, converged residuals)
        ow, ov = jnp.linalg.eigh(o)
        keep = ow > (3 * k) * eps * jnp.max(jnp.abs(ow))
        inv_sqrt = jnp.where(keep, 1.0 / jnp.sqrt(jnp.where(keep, ow, 1.0)), 0.0)
        wh = ov * inv_sqrt[None, :]  # columns: whitened basis coords
        g2 = _mm(_mm(wh.T, g), wh)
        # dropped directions get Ritz values at ±∞ so they never enter
        # the selected window
        pen = jnp.where(keep, 0.0, -_PENALTY if largest else _PENALTY)
        g2 = g2 + jnp.diag(pen)

        ritz, y = jnp.linalg.eigh(g2)  # ascending
        sel = jnp.arange(3 * k - k, 3 * k) if largest else jnp.arange(k)
        th_new = ritz[sel]
        if largest:
            th_new = th_new[::-1]
            yk = y[:, sel][:, ::-1]
        else:
            yk = y[:, sel]

        c = _mm(wh, yk)  # coords of new X in the S basis, (3k, k)
        x_new = _mm(s, c)
        ax_new = _mm(a_s, c)
        # conjugate direction: the same Ritz combination minus its
        # X-block component, renormalized
        cp = c.at[:k, :].set(0.0)
        p_new = _mm(s, cp)
        ap_new = _mm(a_s, cp)
        pn = jnp.linalg.norm(p_new, axis=0)
        scale = jnp.where(pn > 0, 1.0 / jnp.where(pn > 0, pn, 1.0), 0.0)
        p_new = p_new * scale[None, :]
        ap_new = ap_new * scale[None, :]
        return (x_new, ax_new, p_new, ap_new, th_new, it + 1)

    st = jax.lax.while_loop(
        cond, body, (x0, ax0, zeros, zeros, theta0, jnp.int32(0)))
    xb, _, _, _, th, it = st
    order = jnp.argsort(th)
    th = th[order]
    xb = xb[:, order]
    # axb inside the loop is reconstructed as linear combinations of A·S
    # and accumulates round-off; reapply the operator once at exit so the
    # reported residual is genuine.
    axb = op(xb)
    rn = jnp.linalg.norm(_residual(xb, axb, th), axis=0)
    return EigResult(theta=th, x=xb, iterations=it,
                     residual_norm=jnp.max(rn),
                     converged=jnp.all(rn <= _targets(th)))
