"""Multi-card scaling job (BASELINE T7/T9): weak-scaling ladder +
overlap A/B + an optional profiler trace, emitting the
weak-scaling-efficiency JSON lines BASELINE asks for.

Usage (shards default to all visible devices):

    python examples/scaling_job.py --rows-per-shard 2000000 --shards 1,2,4

CPU rehearsal on 8 virtual devices (validates program structure only;
its times are CPU times):

    python examples/scaling_job.py --cpu --rows-per-shard 300000 --shards 1,2,4,8

Expected output: one JSON line per (kind, nshards) with
``ns_per_row``; weak-scaling efficiency = ns_per_row(1) / ns_per_row(P)
(≥0.70 is the BASELINE north-star bar).  Every record names the device
it ran on.  The final line aggregates: {"op": "scaling_summary", ...}.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows-per-shard", type=int, default=2_000_000,
                    help="weak scaling: rows per shard (problem grows with P)")
    ap.add_argument("--shards", default=None,
                    help="comma list, e.g. 1,2,4,8 (default: 1..ndevices pow2)")
    ap.add_argument("--out", default=None, help="append JSON lines to file")
    ap.add_argument("--trace", default=None,
                    help="directory for a jax.profiler trace of one overlapped step")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (8 virtual devices)")
    ap.add_argument("--kind", default="dia", choices=("dia", "bdia"),
                    help="dia: scalar 5-point stencil; bdia: dof-4 FEM "
                         "block matrix on the BDIA path")
    ap.add_argument("--mm", type=int, default=0, metavar="K",
                    help="also ladder the SpMM path with K dense columns")
    args = ap.parse_args(argv)

    from cask_tpu.utils import platform

    platform.start(["--cpu"] if args.cpu else [])
    import jax
    import jax.numpy as jnp

    from cask_tpu.bench.harness import device_record
    from cask_tpu.parallel import (DistSpmv, fem_bdia_partition, row_mesh,
                                   stencil_dia_partition)
    from cask_tpu.tune.timing import measure

    def build_plan(p):
        if args.kind == "bdia":
            # dof-4 FEM blocks: rows = nx²·4 ≈ rows_per_shard·p
            nx = int(math.sqrt(args.rows_per_shard * p / 4))
            return fem_bdia_partition(nx, dof=4, nshards=p)
        side = int(math.sqrt(args.rows_per_shard * p))
        return stencil_dia_partition(side, nshards=p)

    ndev = len(jax.devices())
    shards = ([int(s) for s in args.shards.split(",")] if args.shards
              else [p for p in (1, 2, 4, 8, 16, 32, 64) if p <= ndev])
    out = open(args.out, "a") if args.out else sys.stdout
    records = []

    def emit(rec):
        records.append(rec)
        print(json.dumps(rec), file=out, flush=True)

    # ---- weak-scaling ladder -------------------------------------------
    base_ns = None
    base_ns_mm = None
    for p in shards:
        if p > ndev:
            continue
        plan = build_plan(p)
        op = DistSpmv(plan, row_mesh(p))
        n = plan.shape[0]
        x0 = jax.jit(lambda n=n: 0.1 * jax.random.normal(
            jax.random.PRNGKey(0), (n,), jnp.float32))()
        xp = jax.jit(op.padded)(x0)
        meas = measure(op.padded_op_with, op.operands, xp)
        ns_per_row = meas.seconds_per_iter / n * 1e9
        rec = {"op": "dist_spmv_weak_scaling", "kind": args.kind, "nshards": p, "rows": n,
               "seconds_per_op": meas.seconds_per_iter,
               "ns_per_row": ns_per_row, "spread": meas.spread,
               **device_record()}
        if base_ns is None:
            base_ns = ns_per_row
            rec["efficiency"] = 1.0
        else:
            rec["efficiency"] = base_ns / ns_per_row
        emit(rec)

        if args.mm:
            # SpMM ladder on the same shards; the plan rides as an
            # ARGUMENT, not a compile-time constant
            X0 = jax.jit(lambda n=n, k=args.mm: 0.1 * jax.random.normal(
                jax.random.PRNGKey(2), (n, k), jnp.float32))()
            Xp = jax.jit(op.padded)(X0)
            mm = measure(op.padded_op_with, op.operands, Xp)
            ns_row_mm = mm.seconds_per_iter / n * 1e9
            rec_m = {"op": "dist_spmm_weak_scaling", "kind": args.kind,
                     "k": args.mm, "nshards": p, "rows": n,
                     "seconds_per_op": mm.seconds_per_iter,
                     "ns_per_row": ns_row_mm, "spread": mm.spread,
                     **device_record()}
            if base_ns_mm is None:
                base_ns_mm = ns_row_mm
                rec_m["efficiency"] = 1.0
            else:
                rec_m["efficiency"] = base_ns_mm / ns_row_mm
            emit(rec_m)

    # ---- overlap A/B at the largest shard count ------------------------
    p = max(s for s in shards if s <= ndev)
    plan = build_plan(p)
    mesh = row_mesh(p)
    n = plan.shape[0]
    x0 = jax.jit(lambda n=n: 0.1 * jax.random.normal(
        jax.random.PRNGKey(1), (n,), jnp.float32))()
    times = {}
    for name, ov in (("overlapped", True), ("serialized", False)):
        op = DistSpmv(plan, mesh, overlap=ov)
        xp = jax.jit(op.padded)(x0)
        meas = measure(op.padded_op_with, op.operands, xp)
        times[name] = meas.seconds_per_iter
        emit({"op": "dist_spmv_overlap_ab", "kind": args.kind, "variant": name, "nshards": p,
              "rows": n, "seconds_per_op": meas.seconds_per_iter,
              "spread": meas.spread, **device_record()})
    hidden = times["serialized"] - times["overlapped"]
    emit({"op": "dist_spmv_overlap_ab", "variant": "hidden_comm_seconds",
          "nshards": p, "value": hidden,
          "hidden_frac_of_serialized": hidden / times["serialized"]})

    # ---- optional profiler trace of the overlapped step ----------------
    if args.trace:
        op = DistSpmv(plan, mesh, overlap=True)
        xp = jax.jit(op.padded)(x0)
        f = jax.jit(op.padded_op)
        f(xp).block_until_ready()  # compile outside the trace
        with jax.profiler.trace(args.trace):
            for _ in range(3):
                xp = f(xp) * jnp.float32(0.12)
            jax.block_until_ready(xp)
        emit({"op": "profiler_trace", "dir": args.trace,
              "note": "inspect ppermute vs interior overlap in xprof"})

    effs = [r.get("efficiency") for r in records
            if r.get("op") == "dist_spmv_weak_scaling"]
    emit({"op": "scaling_summary",
          "weak_scaling_efficiency_at_max_shards": effs[-1] if effs else None,
          "target": 0.70, "shards": shards, "ndevices": ndev,
          "wall_s": time.time() - _T0})
    if args.out:
        out.close()
    return 0


_T0 = time.time()

if __name__ == "__main__":
    sys.exit(main())
