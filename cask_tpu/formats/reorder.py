"""Bandwidth-reducing reordering (reverse Cuthill–McKee).

cask tuned the *architecture* to the matrix; the analog here also tunes
the *matrix* to the formulation: the DIA formulation wins exactly
when referenced columns cluster near the diagonal, and RCM manufactures
that locality for matrices whose natural ordering lacks it (SURVEY.md
§5 "halo minimization").  Native C++ BFS when available; pure-Python
fallback otherwise.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from cask_tpu.formats.convert import coo_from_arrays, coo_to_csr, csr_to_coo
from cask_tpu.formats.matrix import CSR


def _symmetrize_pattern(a: CSR) -> CSR:
    coo = csr_to_coo(a)
    r = np.concatenate([np.asarray(coo.row), np.asarray(coo.col)])
    c = np.concatenate([np.asarray(coo.col), np.asarray(coo.row)])
    d = np.ones(r.shape[0], dtype=np.float64)
    return coo_to_csr(coo_from_arrays(d, r, c, a.shape))


def _rcm_python(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    from collections import deque

    n = indptr.shape[0] - 1
    deg = np.diff(indptr)
    seen = np.zeros(n, dtype=bool)
    order = []
    remaining = np.argsort(deg, kind="stable")
    ri = 0
    while len(order) < n:
        while ri < len(remaining) and seen[remaining[ri]]:
            ri += 1
        seed = remaining[ri]
        seen[seed] = True
        q = deque([seed])
        while q:
            u = q.popleft()
            order.append(u)
            nbrs = indices[indptr[u] : indptr[u + 1]]
            nbrs = nbrs[~seen[nbrs]]
            seen[nbrs] = True
            for v in nbrs[np.argsort(deg[nbrs], kind="stable")]:
                q.append(int(v))
    return np.asarray(order[::-1], dtype=np.int32)


def rcm_permutation(a: CSR) -> np.ndarray:
    """perm[new] = old, on the symmetrized pattern of ``a`` (square)."""
    if a.shape[0] != a.shape[1]:
        raise ValueError("RCM needs a square matrix")
    sym = _symmetrize_pattern(a)
    indptr = np.asarray(sym.indptr, dtype=np.int32)
    indices = np.asarray(sym.indices, dtype=np.int32)
    try:
        from cask_tpu.native import binding as nat

        return nat.rcm(indptr, indices)
    except Exception:
        return _rcm_python(indptr.astype(np.int64), indices.astype(np.int64))


def permute_symmetric(a: CSR, perm: np.ndarray) -> CSR:
    """Return P A Pᵀ where perm[new] = old (rows and columns relabeled)."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
    coo = csr_to_coo(a)
    r = inv[np.asarray(coo.row)]
    c = inv[np.asarray(coo.col)]
    return coo_to_csr(coo_from_arrays(np.asarray(coo.data), r, c, a.shape))


def reorder_rcm(a: CSR) -> Tuple[CSR, np.ndarray]:
    """RCM-reorder ``a``; returns (P A Pᵀ, perm) with perm[new] = old.

    To use: solve with the reordered matrix and permute vectors with
    ``x_new = x[perm]`` / ``y = y_new[inv]``.
    """
    perm = rcm_permutation(a)
    return permute_symmetric(a, perm), perm


def bandwidth(a: CSR) -> int:
    """Max |i - j| over stored entries (the DIA kernel's span driver)."""
    indptr = np.asarray(a.indptr, dtype=np.int64)
    indices = np.asarray(a.indices, dtype=np.int64)
    rows = np.repeat(np.arange(a.shape[0], dtype=np.int64), np.diff(indptr))
    return int(np.abs(rows - indices).max(initial=0))
