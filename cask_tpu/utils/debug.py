"""Validation & debug checks (SURVEY.md §5 "race detection" analog).

XLA/SPMD programs are data-race-free by construction, so the checks
worth having are *structural*: partition invariants, permutation
validity, index bounds, NaN tripwires.  All are host-side and cheap
relative to plan construction; call them in tests or before long runs.
"""

from __future__ import annotations

import numpy as np


def check_csr(a) -> None:
    """Index bounds + indptr monotonicity (the gather-OOB guard)."""
    indptr = np.asarray(a.indptr)
    indices = np.asarray(a.indices)
    m, n = a.shape
    if indptr.shape[0] != m + 1:
        raise AssertionError(f"indptr length {indptr.shape[0]} != m+1 ({m + 1})")
    if indptr[0] != 0 or indptr[-1] != indices.shape[0]:
        raise AssertionError("indptr endpoints corrupt")
    if np.any(np.diff(indptr) < 0):
        raise AssertionError("indptr not monotone")
    if indices.size and (indices.min() < 0 or indices.max() >= n):
        raise AssertionError("column index out of bounds")


def check_partition(plan) -> None:
    """CooPartition/DiaPartition invariants: every index in range, no
    interior/exterior overlap, structural zeros where claimed."""
    from cask_tpu.parallel.partition import CooPartition, DiaPartition

    if isinstance(plan, DiaPartition):
        vals = np.asarray(plan.vals)
        P, D, mloc = vals.shape
        if P != plan.nshards or mloc != plan.mloc:
            raise AssertionError("DiaPartition shape metadata mismatch")
        for d, off in enumerate(plan.offsets):
            if abs(off) > plan.mloc:
                raise AssertionError(f"offset {off} wider than a shard ({plan.mloc})")
            # entries whose global column falls outside [0, n) must be 0
            rows = np.arange(P * mloc)
            cols = rows + off
            bad = (cols < 0) | (cols >= plan.shape[1]) | (rows >= plan.shape[0])
            v = vals[:, d, :].reshape(-1)
            if np.any(v[bad] != 0):
                raise AssertionError(f"nonzero out-of-range entry on diagonal {off}")
        if plan.remainder is not None:
            check_partition(plan.remainder)
        return
    if isinstance(plan, CooPartition):
        P = plan.nshards
        mloc = plan.mloc
        for nm in ("int_row", "ext_row"):
            r = np.asarray(getattr(plan, nm))
            if r.size and (r.min() < 0 or r.max() >= mloc):
                raise AssertionError(f"{nm} out of local range")
        ic = np.asarray(plan.int_col)
        if ic.size and (ic.min() < 0 or ic.max() >= mloc):
            raise AssertionError("interior column not local")
        ec = np.asarray(plan.ext_col)
        if ec.size and (ec.min() < 0 or ec.max() >= P * mloc):
            raise AssertionError("exterior column out of padded-global range")
        # interior must really be interior: col shard == row shard is
        # guaranteed by construction (cols are remapped); nothing to do.
        return
    raise TypeError(f"not a partition plan: {type(plan)}")


def check_permutation(perm) -> None:
    perm = np.asarray(perm)
    n = perm.shape[0]
    if not np.array_equal(np.sort(perm), np.arange(n)):
        raise AssertionError("not a permutation")


def nan_guard(fn):
    """Wrap an op so outputs are host-checked for NaN/Inf (debug only —
    forces a device sync per call)."""

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        flat = np.asarray(out if not isinstance(out, tuple) else out[0])
        if not np.all(np.isfinite(flat)):
            raise FloatingPointError(f"{fn.__name__}: non-finite output")
        return out

    return wrapped

