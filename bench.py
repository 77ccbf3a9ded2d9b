"""Benchmark on one GPU: SpMV, SpMM and CG through the public routes at
4.2M rows, each beside a plain device copy of the same byte count (the
practical bandwidth ceiling).

Every cell calls a public route — ``spmv``, ``spmm`` or a CG over
``solver_operator`` — on operands built on the device (or copied there
once, as set-up).  Per cell: the host clock around calls that end in
``block_until_ready``, median of 20 after warm-up; with ``--trace`` also
the device busy time per call from a ``jax.profiler`` trace.  Every
record names the platform, the device kind and count, and the card's
name and power limit as nvidia-smi reports them.  One JSON record per
cell; the last line is a compact summary.

    python bench.py                 # on the GPU; exits non-zero without one
    python bench.py --trace         # plus device times from profiler traces
    python bench.py --cpu --small   # rehearsal on the CPU at tiny sizes
"""

import json
import sys
import time

COMPACT_LIMIT = 1850  # the summary line stays short enough to read whole


def compact_record(record, limit=COMPACT_LIMIT):
    """The summary line: headline fields plus per-cell times, trimmed to
    ``limit`` characters."""
    compact = {k: record[k] for k in ("metric", "value", "unit", "device")}
    compact["cells_us"] = record.get("cells_us", {})
    line = json.dumps(compact)
    if len(line) > limit:
        compact.pop("cells_us")
        line = json.dumps(compact)
    return line


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    from cask_tpu.utils import platform

    platform.start(argv)
    if "--cpu" not in argv:
        platform.require("gpu")
    small = "--small" in argv
    trace = "--trace" in argv

    import jax
    import jax.numpy as jnp
    import numpy as np

    jax.config.update("jax_enable_x64", True)

    import cask_tpu
    from cask_tpu.bench.harness import device_record
    from cask_tpu.bench.roofline import spmv_traffic
    from cask_tpu.formats.device_gen import fem_bdia_device, stencil2d_dia_device
    from cask_tpu.formats.generate import power_law, stencil_2d
    from cask_tpu.parallel import fem_formula_bsr
    from cask_tpu.solvers import cg
    from cask_tpu.tune.timing import measure
    from cask_tpu.utils.profiling import device_kernels

    side, nx, n_pl = (64, 32, 5000) if small else (2048, 1024, 1_000_000)
    dev = device_record()
    t_start = time.time()
    cells_us = {}
    records = []

    def key(n, seed=0, k=None, dtype=jnp.float32):
        shape = (n,) if k is None else (n, k)
        return jax.jit(lambda: jax.random.normal(jax.random.PRNGKey(seed), shape, dtype))()

    def device_time(name, fn, *args, calls=5):
        if not trace:
            return None
        f = jax.jit(fn)
        jax.block_until_ready(f(*args))
        d = str(platform.CACHE_DIR.parent / "chiprun_out" / "trace" / name)
        with jax.profiler.trace(d):
            for _ in range(calls):
                jax.block_until_ready(f(*args))
        red = device_kernels(d)
        if red is None:
            return None
        top = sorted(red["kernels"].items(), key=lambda kv: -kv[1])[:4]
        return {"device_us_per_call": red["busy_ns"] / calls / 1e3,
                "idle_share": 1.0 - red["busy_ns"] / max(red["window_ns"], 1.0),
                "top_kernels_us": {k: v / calls / 1e3 for k, v in top}}

    def cell(name, fn, args, bytes_per_call, **meta):
        m = measure(fn, *args)
        rec = {"cell": name, "us": m.seconds_per_iter * 1e6, "spread": m.spread,
               "bytes_per_call": bytes_per_call,
               "GBs": bytes_per_call / m.seconds_per_iter / 1e9, **meta, **dev}
        dt = device_time(name, fn, *args)
        if dt is not None:
            rec.update(dt)
        cells_us[name] = rec["us"]
        records.append(rec)
        print(json.dumps(rec), flush=True)
        return rec

    def copy_cell(name, nbytes, dtype):
        # read n elements, write n elements: the same byte count as the
        # SpMV cell it stands beside
        n = int(nbytes // (2 * jnp.dtype(dtype).itemsize))
        return cell(name, lambda v: v + 1, (key(n, 9, dtype=dtype),), nbytes)

    def spmv_fn(a, x):
        return cask_tpu.spmv(a, x, method="xla")

    def spmm_fn(a, x):
        return cask_tpu.spmm(a, x, method="xla")

    def pair(name, mat, dtype, k=None, fn=None):
        """One SpMV/SpMM cell and its copy of equal bytes."""
        n = mat.shape[1]
        x = key(n, 1, k=k, dtype=dtype)
        traffic = spmv_traffic(mat, k or 1)
        rec = cell(name, fn or (spmm_fn if k else spmv_fn), (mat, x),
                   traffic.bytes_per_op, nnz=traffic.nnz, rows=mat.shape[0],
                   dtype=jnp.dtype(dtype).name, k=k)
        cp = copy_cell(name + "_copy", traffic.bytes_per_op, dtype)
        rec["frac_of_copy"] = cp["us"] / rec["us"]
        print(json.dumps({"cell": name, "frac_of_copy": rec["frac_of_copy"]}),
              flush=True)
        return rec

    stencil = stencil_2d(side, dtype=np.float64)
    fem = fem_formula_bsr(nx, dof=4, dtype=np.float64)
    headline = None
    for dtype in (jnp.float32, jnp.float64):
        tag = "f32" if dtype == jnp.float32 else "f64"
        pair(f"dia_stencil_{tag}", stencil2d_dia_device(side, dtype=dtype), dtype)
        bdia = fem_bdia_device(nx, dof=4, dtype=dtype)
        r = pair(f"bdia_fem_{tag}", bdia, dtype)
        if dtype == jnp.float32:
            headline = r
        # the XLA formulation the banded kernel replaces on the GPU
        pair(f"bdia_fem_xla_{tag}", bdia, dtype, fn=lambda a, v: a._xla(v))
        pair(f"csr_stencil_{tag}", stencil.astype(dtype).device_put(), dtype)
        pair(f"bsr_fem_{tag}", fem.astype(dtype).device_put(), dtype)
    for k in (32,):
        pair(f"dia_stencil_k{k}_f32", stencil2d_dia_device(side), jnp.float32, k)
        pair(f"csr_stencil_k{k}_f32", stencil.astype(np.float32).device_put(),
             jnp.float32, k)
        pair(f"bdia_fem_k{k}_f32", fem_bdia_device(nx, dof=4), jnp.float32, k)
        pair(f"bsr_fem_k{k}_f32", fem.astype(np.float32).device_put(),
             jnp.float32, k)
    pair("csr_powerlaw_f32",
         power_law(n_pl, avg_degree=12, dtype=np.float32, seed=3).device_put(),
         jnp.float32)

    # CG per iteration over the solver operator's DIA plan, f64
    op = cask_tpu.solver_operator(stencil)
    b = key(stencil.shape[0], 2, dtype=jnp.float64)

    def solve(dia, rhs, iters):
        return cg(dia.spmv, rhs, tol=0.0, maxiter=iters).x

    t_lo = measure(lambda d, r: solve(d, r, 100), op.dia, b, iters=5)
    t_hi = measure(lambda d, r: solve(d, r, 300), op.dia, b, iters=5)
    per_iter = (t_hi.seconds_per_iter - t_lo.seconds_per_iter) / 200
    cells_us["cg_dia_stencil_f64_per_iter"] = per_iter * 1e6
    rec = {"cell": "cg_dia_stencil_f64_per_iter", "us": per_iter * 1e6, **dev}
    print(json.dumps(rec), flush=True)

    summary = {
        "metric": "bdia_spmv_frac_of_copy",
        "value": headline["frac_of_copy"],
        "unit": "BDIA f32 SpMV rate / plain copy rate, same bytes",
        "device": {"platform": dev["platform"], "kind": dev["device_kind"],
                   "count": dev["device_count"], "card": dev["card"]},
        "cells_us": cells_us,
        "wall_s": time.time() - t_start,
    }
    print(json.dumps(summary), flush=True)
    print(compact_record(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
