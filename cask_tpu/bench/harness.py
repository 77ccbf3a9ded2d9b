"""Benchmark harness: structured JSON-lines records over matrix suites.

cask analog: the benchmark scripts (SURVEY.md §2 R8) — fetch matrices,
sweep configurations, emit CSV.  Here: synthetic suites (no network,
SURVEY.md §8.4) or user ``.mtx`` files, tuned-variant sweeps, JSON-lines
records of {matrix, op, variant, nnz/s, GB/s, roofline %} (§5 metrics
plan).
"""

from __future__ import annotations

import json
import sys
import time
from functools import partial
from typing import Iterable, Optional, TextIO

import jax.numpy as jnp
import numpy as np

from cask_tpu.bench.roofline import PEAKS, spmv_traffic
from cask_tpu.formats.matrix import CSR
from cask_tpu.formats.signature import signature
from cask_tpu.tune.timing import measure
from cask_tpu.tune.tuner import Variant, _apply, enumerate_variants
from cask_tpu.utils import platform


def device_record() -> dict:
    """What every record names: the device the numbers come from."""
    import jax

    return {"platform": platform.platform(),
            "device_kind": platform.device_kind(),
            "device_count": len(jax.devices()),
            "card": platform.card()}


def bench_matrix(name: str, a: CSR, *, k: Optional[int] = None,
                 variants: Optional[Iterable[str]] = None,
                 dtype=np.float32, out: TextIO = sys.stdout) -> list:
    """Time variants of SpMV (or SpMM-k) on one matrix; emit JSON lines."""
    a = CSR(
        data=np.asarray(a.data, dtype=dtype),
        indices=a.indices,
        indptr=a.indptr,
        shape=a.shape,
    )
    sig = signature(a)
    if variants is None:
        cand = enumerate_variants(a, sig, k)
        cand.sort(key=lambda v: v.est_bytes)
        cand = cand[:3]
    else:
        cand = [Variant(v, 0.0) for v in variants]

    rng = np.random.default_rng(0)
    x0 = jnp.asarray(
        rng.standard_normal((a.shape[1], k) if k else a.shape[1]).astype(dtype)
    )
    # host scipy baseline (cask analog: the MKL/CPU comparison column)
    scipy_s = None
    try:
        from cask_tpu.formats.convert import to_scipy

        s = to_scipy(a).astype(dtype)
        xh = np.asarray(x0)
        s @ xh  # warm
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            s @ xh
            best = min(best, time.perf_counter() - t0)
        scipy_s = best
    except Exception:
        pass
    records = []
    for var in cand:
        rec = {
            "matrix": name,
            "op": f"spmm_k{k}" if k else "spmv",
            "variant": var.name,
            "rows": a.shape[0],
            "nnz": a.nnz,
            "dtype": str(np.dtype(dtype)),
            "ts": time.time(),
            **device_record(),
        }
        try:
            dev, fn, info = var.build_full(a, k)
            meas = measure(fn, x0) if info else measure(_apply, dev, x0)
            traffic = spmv_traffic(dev, k or 1)
            peak = PEAKS.get(rec["device_kind"])
            if peak is not None:
                rec.update(traffic.record(meas.seconds_per_iter,
                                          bandwidth=peak["hbm_bytes_per_s"]))
            else:
                rec["seconds_per_op"] = meas.seconds_per_iter
            rec["spread"] = meas.spread
            if scipy_s is not None and meas.seconds_per_iter > 0:
                rec["scipy_seconds"] = scipy_s
                rec["speedup_vs_scipy"] = round(scipy_s / meas.seconds_per_iter, 2)
        except Exception as e:  # noqa: BLE001 — failed variants are data
            rec["error"] = f"{type(e).__name__}: {e}"
        records.append(rec)
        print(json.dumps(rec), file=out, flush=True)
    return records


def bench_suite(size: str = "small", *, k: Optional[int] = None,
                dtype=np.float32, out: TextIO = sys.stdout) -> list:
    from cask_tpu.formats.generate import suite

    all_recs = []
    for name, a in suite(size).items():
        all_recs += bench_matrix(name, a, k=k, dtype=dtype, out=out)
    return all_recs


def bench_scaling(side: int = 512, *, nshards_list=(1, 2, 4, 8),
                  out: TextIO = sys.stdout) -> list:
    """Weak-ish scaling of the distributed halo SpMV on the current mesh.

    Fixed problem per shard count would be weak scaling on real pods; on
    a fake CPU mesh this validates program structure and records the
    efficiency metric shape (BASELINE T9).
    """
    import jax

    from cask_tpu.parallel import DistSpmv, row_mesh, stencil_dia_partition

    ndev = len(jax.devices())
    records = []
    base_t = None
    for p in nshards_list:
        if p > ndev:
            continue
        # formulaic partition: no CSR materialization (a minute of numpy
        # at 10M rows); bit-identical to partition_dia(stencil_2d(...))
        plan = stencil_dia_partition(int(side * np.sqrt(p)), nshards=p)
        a = plan
        op = DistSpmv(plan, row_mesh(p))
        xp = op.padded(np.random.default_rng(0).standard_normal(a.shape[0]).astype(np.float32))
        meas = measure(op.padded_op_with, op.operands, xp)
        per_row = meas.seconds_per_iter / a.shape[0]
        rec = {
            "op": "dist_spmv_weak_scaling",
            "nshards": p,
            "rows": a.shape[0],
            "seconds_per_op": meas.seconds_per_iter,
            "ns_per_row": per_row * 1e9,
            "spread": meas.spread,
            **device_record(),
        }
        if base_t is None:
            base_t = per_row
            rec["efficiency"] = 1.0
        else:
            rec["efficiency"] = round(base_t / per_row, 4)
        records.append(rec)
        print(json.dumps(rec), file=out, flush=True)
    return records


def bench_overlap(side: int = 512, *, nshards: Optional[int] = None,
                  out: TextIO = sys.stdout) -> list:
    """A/B: halo exchange overlapped vs serialized (SURVEY §7(d)).

    On a real multi-chip slice the overlapped variant should approach
    max(comm, compute) while the serialized one pays comm + compute; the
    measured gap is the hidden communication time.
    """
    import jax

    from cask_tpu.formats.generate import stencil_2d
    from cask_tpu.parallel import DistSpmv, partition_dia, row_mesh

    p = nshards or len(jax.devices())
    a = stencil_2d(side, dtype=np.float32)
    plan = partition_dia(a, p)
    mesh = row_mesh(p)
    x = np.random.default_rng(0).standard_normal(a.shape[0]).astype(np.float32)
    records = []
    for name, ov in (("overlapped", True), ("serialized", False)):
        op = DistSpmv(plan, mesh, overlap=ov)
        xp = op.padded(x)
        meas = measure(op.padded_op_with, op.operands, xp)
        rec = {"op": "dist_spmv_overlap_ab", "variant": name, "nshards": p,
               "rows": a.shape[0], "seconds_per_op": meas.seconds_per_iter,
               "spread": meas.spread, **device_record()}
        records.append(rec)
        print(json.dumps(rec), file=out, flush=True)
    if len(records) == 2 and all(np.isfinite(r["seconds_per_op"]) for r in records):
        hidden = records[1]["seconds_per_op"] - records[0]["seconds_per_op"]
        rec = {"op": "dist_spmv_overlap_ab", "variant": "hidden_comm_seconds",
               "value": hidden}
        records.append(rec)
        print(json.dumps(rec), file=out, flush=True)
    return records


def bench_solve(side: int = 512, *, dtype=np.float32,
                out: TextIO = sys.stdout) -> "list[dict]":
    """Per-iteration CG cost on a Poisson system (the end-to-end solver
    metric; cask analog: the CG demo's wall numbers): the difference of
    two fixed-iteration solves' median times over their iteration gap."""
    import jax

    from cask_tpu.formats.device_gen import stencil2d_dia_device
    from cask_tpu.solvers import cg, pipelined_cg

    m = side * side
    dia = stencil2d_dia_device(side, dtype=dtype)
    b = jax.jit(lambda: jax.random.normal(jax.random.PRNGKey(0), (m,), dtype))()

    records = []
    for name, solver in (("cg", cg), ("pipelined_cg", pipelined_cg)):
        def run(a, b, iters, solver=solver):
            return solver(a.spmv, b, tol=0.0, maxiter=iters).x

        t_lo = measure(partial(run, iters=100), dia, b, iters=5)
        t_hi = measure(partial(run, iters=300), dia, b, iters=5)
        per_iter = (t_hi.seconds_per_iter - t_lo.seconds_per_iter) / 200
        rec = {
            "op": "pcg_per_iteration",
            "solver": name,
            "matrix": f"stencil5_{side}x{side}",
            "rows": m,
            "us_per_iteration": per_iter * 1e6,
            **device_record(),
        }
        records.append(rec)
        print(json.dumps(rec), file=out, flush=True)
    return records
