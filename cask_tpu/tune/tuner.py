"""Per-matrix autotuner (BASELINE T6) — cask's DSE layer.

cask enumerated FPGA architecture parameters with analytic resource/
performance models, then paid an hours-long bitstream build for the
winner (SURVEY.md §3.2).  Here JIT replaces the bitstream build, so the
loop becomes: analytic *byte-traffic* prefilter → on-device timing of
the few surviving variants → JSON cache keyed on the platform, the
device kind and the sparsity signature, so a winner timed on one device
is never reused on another.

Variant space (each is plain JAX that XLA compiles):
- ``csr_xla``       — gather + segment_sum
- ``bsr_xla:<b>``   — block gather + einsum + segment_sum
- ``dia_xla``       — diagonal-packed shifted FMAs (banded matrices)
- ``bdia:<b>``      — block-diagonal-packed plan (block bands): the banded
  kernel or XLA's fusion, as the platform's route says
- ``rcm:<v>``       — RCM reordering toward a band, then variant ``v``
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Callable, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cask_tpu.formats.convert import csr_to_bsr
from cask_tpu.formats.matrix import CSR
from cask_tpu.formats.signature import Signature, signature as compute_signature
from cask_tpu.ops.spmm import spmm
from cask_tpu.ops.spmv import spmv
from cask_tpu.tune.cache import TunerCache, default_cache
from cask_tpu.tune.timing import measure

log = logging.getLogger("cask_tpu.tune")

_BSR_CANDIDATES = (4, 8, 16, 32)


def _apply(dev, x):
    """The product of any tuned format: the formulation its type selects."""
    return (spmv if x.ndim == 1 else spmm)(dev, x, method="xla")


@dataclasses.dataclass
class Variant:
    name: str  # e.g. "csr_xla", "bsr_xla:8", "dia_xla"
    est_bytes: float  # analytic traffic per op application

    def build(self, a: CSR, k: Optional[int]) -> Tuple[object, Callable]:
        """Return (device_matrix, fn(x)->y) for this variant."""
        dev, fn, _ = self.build_full(a, k)
        return dev, fn

    def _device_matrix(self, a: CSR):
        kind, _, arg = self.name.partition(":")
        if kind == "csr_xla":
            return a.device_put()
        if kind == "bsr_xla":
            return csr_to_bsr(a, (int(arg), int(arg))).device_put()
        if kind == "dia_xla":
            from cask_tpu.ops.dia import dia_plan

            return dia_plan(a).device_put()
        if kind == "bdia":
            from cask_tpu.ops.bdia import bdia_plan

            return bdia_plan(a, (int(arg), int(arg))).device_put()
        raise ValueError(f"unknown variant {self.name!r}")

    def build_full(self, a: CSR, k: Optional[int]) -> Tuple[object, Callable, dict]:
        """Like :meth:`build`, plus an info dict.  For ``rcm:*`` variants
        the dict carries ``perm`` (the RCM row/col permutation) and
        ``inner_fn`` (the kernel in the *reordered* space), so solver
        loops can reorder once and stay reordered instead of paying two
        boundary vector permutes per application."""
        if not self.name.startswith("rcm:"):
            dev = self._device_matrix(a)
            return dev, functools.partial(jax.jit(_apply), dev), {}
        from cask_tpu.formats.reorder import reorder_rcm

        a_r, perm = reorder_rcm(a)
        dev, fn = Variant(self.name[4:], 0.0).build(a_r, k)
        pd = jnp.asarray(perm)
        ipd = jnp.asarray(np.argsort(perm).astype(np.int32))
        info = {"perm": np.asarray(perm), "inner_fn": fn}
        return dev, lambda x: fn(x[pd])[ipd], info


def _dtype_bytes(dt) -> int:
    return jnp.dtype(dt).itemsize


def enumerate_variants(a: CSR, sig: Signature, k: Optional[int]) -> List[Variant]:
    """Analytic device-memory traffic model per variant (the DSE
    performance-model analog, SURVEY.md §3.2) — ranks candidates before
    any compile.

    Per SpMV/SpMM application, modeled bytes:
    - ``csr_xla``:    values+indices, plus the gathered-X and partial
      product arrays XLA materializes (2·nnz·k·db)
    - ``bsr_xla:b``:  same shape but gathers/partials are per *block*
      (÷ b), at the cost of ``stored ≥ nnz`` block fill
    - ``dia_xla`` / ``bdia:b``: the streamed diagonals once
      (k-independent) + X/Y
    """
    m, n = a.shape
    nnz = a.nnz
    db = _dtype_bytes(a.dtype)
    kk = k or 1
    xbytes = (n + m) * db * kk

    out: List[Variant] = [
        Variant("csr_xla", nnz * (db + 4) + 2.0 * nnz * db * kk + xbytes)
    ]

    from cask_tpu.ops.bdia import estimate_bdia_traffic

    for b, fill_pct in zip(Signature.BLOCK_PROBE, sig.block_fill):
        if b not in _BSR_CANDIDATES:
            continue
        fill = max(fill_pct, 1) / 100.0
        stored = nnz / fill  # entries incl. block fill
        if fill >= 0.35:
            est = stored * db + (stored / (b * b)) * 4 + 2.0 * stored * db * kk / b + xbytes
            out.append(Variant(f"bsr_xla:{b}", est))
        if fill >= 0.3:
            bd = estimate_bdia_traffic(a, b)
            if bd is not None:
                out.append(Variant(f"bdia:{b}", bd[0] * db + 2.0 * xbytes))

    # diagonal split: streamed entries are k-independent
    from cask_tpu.ops.dia import estimate_dia_traffic

    est = estimate_dia_traffic(a)
    if est is not None:
        out.append(Variant("dia_xla", est * db + 2.0 * xbytes))

    # RCM reordering toward the banded formulation (cask's DSE explored
    # architecture params; reordering is the analogous *data-layout*
    # dimension).  Only probed when the natural ordering has no usable
    # diagonal split and the matrix is square.
    if est is None and m == n and nnz:
        from cask_tpu.formats.reorder import reorder_rcm

        try:
            a_r, _ = reorder_rcm(a)
            est_r = estimate_dia_traffic(a_r)
        except Exception:
            est_r = None
        if est_r is not None:
            permute = 8.0 * m * db * kk  # boundary vector gathers
            out.append(Variant("rcm:dia_xla",
                               est_r * db + 2.0 * xbytes + permute))
    return out


@dataclasses.dataclass
class TunedSpmv:
    """A matrix bound to its tuned kernel — the user-facing product of
    tuning (cask analog: the per-matrix generated architecture)."""

    variant: str
    matrix: object  # device-side matrix/plan in the winning format
    _fn: Callable
    signature_key: str
    seconds_per_op: Optional[float] = None
    # rcm:* winners only — the permutation and the reordered-space kernel
    perm: Optional[np.ndarray] = None
    _inner_fn: Optional[Callable] = None

    def __call__(self, x):
        return self._fn(jnp.asarray(x))

    @property
    def is_reordered(self) -> bool:
        return self.perm is not None

    def reordered(self) -> Tuple[Callable, np.ndarray]:
        """``(fn, perm)`` for solver loops on ``rcm:*`` winners: ``fn``
        applies the kernel in the *reordered* space (no boundary
        permutes).  Reorder the right-hand side once (``b[perm]``),
        iterate with ``fn``, and un-permute the solution once
        (``x[argsort(perm)]``)."""
        if self.perm is None:
            raise ValueError(
                f"variant {self.variant!r} is not RCM-reordered; "
                "call the TunedSpmv directly")
        return self._inner_fn, self.perm


def cache_key(a: CSR, k: Optional[int], sig: Optional[Signature] = None) -> str:
    """Tuner cache key: platform, device kind, sparsity signature, k."""
    from cask_tpu.utils import platform

    sig = sig or compute_signature(a)
    return (f"{platform.platform()}:{platform.device_kind()}:"
            f"{sig.key()}:k={k or 0}")


def tune(a: CSR, *, k: Optional[int] = None, cache: Optional[TunerCache] = None,
         time_budget: int = 3, force: bool = False) -> TunedSpmv:
    """Pick the fastest kernel variant for matrix ``a`` (SpMV, or SpMM
    with ``k`` dense columns); cache the winner by sparsity signature.

    ``time_budget``: how many top analytic candidates to actually time
    (the best XLA gather variant is always among them).
    """
    if not isinstance(a, CSR):
        from cask_tpu.formats.convert import bsr_to_csr, coo_to_csr
        from cask_tpu.formats.matrix import BSR, COO

        if isinstance(a, COO):
            a = coo_to_csr(a)
        elif isinstance(a, BSR):
            a = bsr_to_csr(a)
        else:
            raise TypeError(f"cannot tune {type(a)}")

    cache = cache or default_cache()
    sig = compute_signature(a)
    key = cache_key(a, k, sig)

    if not force:
        hit = cache.get(key)
        if hit is not None:
            var = Variant(hit["variant"], 0.0)
            dev, fn, info = var.build_full(a, k)
            return TunedSpmv(
                variant=var.name, matrix=dev, _fn=fn, signature_key=key,
                seconds_per_op=hit.get("seconds_per_op"),
                perm=info.get("perm"), _inner_fn=info.get("inner_fn"),
            )

    variants = enumerate_variants(a, sig, k)
    variants.sort(key=lambda v: v.est_bytes)
    candidates = variants[: max(time_budget, 1)]
    # a mis-ranked prefilter must never drop the gather formulation from
    # timing: it always builds, so timing it bounds the damage of any
    # analytic-model error
    if not any(v.name == "csr_xla" for v in candidates):
        candidates.append(next(v for v in variants if v.name == "csr_xla"))

    n = a.shape[1]
    rng = np.random.default_rng(0)
    x0 = jnp.asarray(rng.standard_normal((n, k) if k else n).astype(np.dtype(a.dtype)))

    results = []  # (seconds, var, dev, fn, info)
    timings = {}  # every variant's measurement persists in the cache
    for var in candidates:
        try:
            dev, fn, info = var.build_full(a, k)
            # the matrix rides as a traced argument, not a compile-time
            # constant (rcm variants carry their permutes in a closure)
            meas = (measure(fn, x0) if info else measure(_apply, dev, x0))
        except Exception as e:  # a variant failing to build/compile is data
            log.warning("tune %s: variant %s failed: %s", key, var.name, e)
            continue
        log.info("tune %s: variant=%s t=%.3g s/op", key, var.name,
                 meas.seconds_per_iter)
        timings[var.name] = {"seconds_per_op": meas.seconds_per_iter,
                             "spread": meas.spread}
        if np.isfinite(meas.checksum):
            results.append((meas.seconds_per_iter, var, dev, fn, info))

    if results:
        secs, var, dev, fn, info = min(results, key=lambda r: r[0])
    else:  # always possible: csr_xla
        var = Variant("csr_xla", 0.0)
        dev, fn, info = var.build_full(a, k)
        secs = float("nan")
    cache.put(key, {"variant": var.name, "seconds_per_op": secs,
                    "shape": list(a.shape), "nnz": int(a.nnz),
                    "timings": timings})
    return TunedSpmv(variant=var.name, matrix=dev, _fn=fn,
                     signature_key=key, seconds_per_op=secs,
                     perm=info.get("perm"), _inner_fn=info.get("inner_fn"))
