"""Smoke test of cask_tpu on a GPU: the library's main path once, through
the entry points a user calls, at the sizes its users run.

    python chip_smoke.py              # one GPU: every phase below
    python chip_smoke.py --chips 4    # only the four-card distributed path

Phases on one card (each compared with scipy/numpy in float64 on the
host):
  - SpMV, f32 and f64: banded CSR (2048² 5-point stencil, 4.2M rows),
    BSR (FEM dof-4 at nx=1024: 4.2M rows, 84M nnz) and unstructured CSR
    (power law, 4M rows, degree 12); and the BDIA plan's SpMV as the
    route runs it (the banded Pallas kernel on the GPU) against its XLA
    formulation on the same FEM matrix;
  - SpMM, f32, k=32 and k=128: CSR (1024² stencil, 1M rows) and BSR
    (FEM dof-4 at nx=512, 1M rows) — the (nnz, k) gather intermediates of
    the 4.2M-row matrices would not fit the card at k=128;
  - SpGEMM A·A on a 20k-row power-law graph (degree 8: 131M products,
    115M output entries; the host plan takes well under a minute),
    device numeric phase;
  - tune() on the 1M-row FEM matrix: the chosen variant, a cache hit on
    the second call, and the tuned product against scipy;
  - solvers: CG for exactly 100 iterations in f64 against the same
    recurrence in numpy; AMG-preconditioned CG at 4.2M unknowns to a
    relative residual of 1e-6 recomputed by scipy; ILU(0) + trisolve on
    the 512² stencil.

Tolerances (relative L2 error against the reference):
  - f64: 1e-12 — only the summation order differs from the reference;
  - f32: 1e-5 against a float64 reference built from the f32-rounded
    inputs — f32 rounding grows with √(row nnz).

Each phase prints one line with its time, its error and tolerance, and
the card's name and power limit.  A failed phase, or no GPU, makes the
script exit non-zero without the final ``ok`` line.  One process drives
the card(s).
"""

import json
import sys
import time
from pathlib import Path

TOL = {"float64": 1e-12, "float32": 1e-5}
ROOT = Path(__file__).resolve().parent


def rel_err(y, ref):
    import numpy as np

    y = np.asarray(y, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.linalg.norm(y - ref) / max(np.linalg.norm(ref), 1e-300))


def _scipy(a, dtype=None):
    """float64 scipy copy of a cask matrix, values rounded through
    ``dtype`` first (so the reference sees the inputs the device saw)."""
    import numpy as np
    import scipy.sparse as sp

    from cask_tpu.formats.matrix import BSR

    if isinstance(a, BSR):
        s = sp.bsr_matrix((np.asarray(a.data), np.asarray(a.indices),
                           np.asarray(a.indptr)), shape=a.shape).tocsr()
    else:
        s = sp.csr_matrix((np.asarray(a.data), np.asarray(a.indices),
                           np.asarray(a.indptr)), shape=a.shape)
    if dtype is not None:
        s.data = s.data.astype(dtype).astype(np.float64)
    return s.astype(np.float64)


def _vec(shape, dtype, seed):
    import numpy as np

    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


# -- phases: each returns (error, tolerance, note) --------------------------


def phase_spmv(a, dtype):
    """``spmv`` on the device copy of ``a`` (the auto route) vs scipy."""
    import numpy as np

    import cask_tpu

    dev = a.astype(dtype).device_put()
    x = _vec(a.shape[1], dtype, 1)
    y = cask_tpu.spmv(dev, x)
    ref = _scipy(a, dtype) @ x.astype(np.float64)
    return rel_err(y, ref), TOL[np.dtype(dtype).name], ""


def phase_kernel_vs_xla(nx, dtype):
    """BDIA SpMV as the route runs it (the banded kernel on the GPU)
    against the plain XLA formulation of the same plan, on the device-
    built FEM dof-4 matrix."""
    import numpy as np

    from cask_tpu.formats.device_gen import fem_bdia_device

    p = fem_bdia_device(nx, dof=4, dtype=dtype)
    x = _vec(p.shape[1], dtype, 11)
    return (rel_err(p.spmv(x), p._xla(x)), TOL[np.dtype(dtype).name],
            f"rows={p.shape[0]}")


def phase_spmm(a, k, dtype):
    import numpy as np

    import cask_tpu

    dev = a.astype(dtype).device_put()
    x = _vec((a.shape[1], k), dtype, 2)
    y = cask_tpu.spmm(dev, x)
    ref = _scipy(a, dtype) @ x.astype(np.float64)
    return rel_err(y, ref), TOL[np.dtype(dtype).name], f"k={k}"


def phase_spgemm(a):
    """A·A: host symbolic plan + device numeric, f64, vs scipy."""
    import numpy as np

    import cask_tpu
    from cask_tpu.ops.spgemm import spgemm_plan

    t0 = time.time()
    plan = spgemm_plan(a, a)
    t_plan = time.time() - t0
    c = cask_tpu.spgemm(a, plan=plan)
    s = _scipy(a)
    diff = _scipy(c) - s @ s
    ref = s @ s
    err = float(np.sqrt((diff.multiply(diff)).sum()) /
                np.sqrt((ref.multiply(ref)).sum()))
    return err, TOL["float64"], (f"nnz_C={plan.nnz} expansion={plan.expansion} "
                                 f"host_plan_s={t_plan:.1f}")


def phase_tune(a_csr, cache_path):
    """tune() twice: the second call must be a cache hit with the same
    variant; the tuned product must match scipy (f64)."""
    import numpy as np

    import cask_tpu
    from cask_tpu.tune.cache import TunerCache

    cache_path = Path(cache_path)
    if cache_path.exists():
        cache_path.unlink()
    cache = TunerCache(path=str(cache_path))
    t1 = cask_tpu.tune(a_csr, cache=cache)
    entry = cache.get(t1.signature_key)
    t2 = cask_tpu.tune(a_csr, cache=cache)
    hit = (entry is not None and t2.variant == t1.variant
           and t2.seconds_per_op == entry["seconds_per_op"])
    x = _vec(a_csr.shape[1], np.float64, 3)
    err = rel_err(t2(x), _scipy(a_csr) @ x)
    if not hit:
        err = float("inf")
    timed = {k: v["seconds_per_op"] for k, v in entry["timings"].items()}
    return err, TOL["float64"], (f"variant={t1.variant} cache_hit={hit} "
                                 f"timings_s={json.dumps(timed)}")


def numpy_cg(s, b, iters):
    """The library's CG recurrence (x0 = 0, no preconditioner) in numpy."""
    import numpy as np

    x = np.zeros_like(b)
    r = b.copy()
    p = r.copy()
    rz = r @ r
    for _ in range(iters):
        ap = s @ p
        alpha = rz / (p @ ap)
        x = x + alpha * p
        r = r - alpha * ap
        rz_new = r @ r
        p = r + (rz_new / rz) * p
        rz = rz_new
    return x


def phase_cg(a, iters=100):
    import numpy as np

    from cask_tpu.solvers import cg

    b = _vec(a.shape[0], np.float64, 4)
    res = cg(a.device_put(), b, tol=0.0, maxiter=iters)
    assert int(res.iterations) == iters
    ref = numpy_cg(_scipy(a), b, iters)
    return rel_err(res.x, ref), TOL["float64"], f"iterations={iters}"


def phase_amg(a, rtol=1e-6):
    """AMG-preconditioned CG, the hierarchy passed into one jitted solve;
    the relative residual is recomputed by scipy."""
    import jax
    import numpy as np

    from cask_tpu.solvers import cg, smoothed_aggregation_amg

    t0 = time.time()
    M = smoothed_aggregation_amg(a)
    t_setup = time.time() - t0
    dev = a.device_put()
    b = _vec(a.shape[0], np.float64, 5)
    solve = jax.jit(lambda bb, MM: cg(dev, bb, tol=0.1 * rtol, maxiter=500, M=MM))
    res = solve(b, M)
    s = _scipy(a)
    resid = float(np.linalg.norm(b - s @ np.asarray(res.x)) / np.linalg.norm(b))
    return resid, rtol, (f"iterations={int(res.iterations)} levels={M.level_sizes} "
                         f"host_setup_s={t_setup:.1f}")


def phase_ilu(a):
    """ILU(0) factors, then the two triangular solves on the device vs
    scipy's triangular solves (f64)."""
    import numpy as np
    from scipy.sparse.linalg import spsolve_triangular

    import cask_tpu

    f = cask_tpu.ilu0(a)
    low, up = f.split()
    b = _vec(a.shape[0], np.float64, 6)
    y = cask_tpu.trisolve(low, b, lower=True, unit_diag=True)
    x = cask_tpu.trisolve(up, y, lower=False)
    y_ref = spsolve_triangular(_scipy(low), b, lower=True, unit_diagonal=True)
    x_ref = spsolve_triangular(_scipy(up), y_ref, lower=False)
    err = max(rel_err(x, x_ref), rel_err(f.apply(b), x_ref))
    return err, TOL["float64"], ""


# -- the four-card path ------------------------------------------------------


def phase_dist(op, a_ref, mat_dtype, nshards):
    """Distributed SpMV of ``op`` vs scipy; the result must sit on
    ``nshards`` distinct devices."""
    import numpy as np

    x = _vec(a_ref.shape[1], mat_dtype, 7)
    y = op(x)
    devices = {sh.device for sh in op.padded_op(op.padded(x)).addressable_shards}
    if len(devices) != nshards:
        return float("inf"), 0.0, f"shards on {len(devices)} devices"
    return (rel_err(y, a_ref @ x.astype(np.float64)), TOL[np.dtype(mat_dtype).name],
            f"devices={len(devices)}")


def run_chips4(report):
    import jax
    import numpy as np

    from cask_tpu.formats.generate import stencil_2d
    from cask_tpu.parallel import (Dist2DSpmv, DistSpmv, fem_bdia_partition,
                                   fem_formula_bsr, mesh_2d, partition_2d,
                                   partition_coo, partition_dia, row_mesh)
    from cask_tpu.solvers import cg

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--chips 4 needs 4 devices, JAX has {len(jax.devices())}")
    side, nx = (3200, 1600) if not SMALL else (40, 20)  # 10.24M rows each
    a = stencil_2d(side)
    s = _scipy(a)
    mesh = row_mesh(4)

    op_dia = DistSpmv(partition_dia(a, 4), mesh)
    report("dist_spmv_dia_ring_halo", lambda: phase_dist(op_dia, s, np.float64, 4))
    op_coo = DistSpmv(partition_coo(a, 4), mesh)
    report("dist_spmv_coo_all_gather", lambda: phase_dist(op_coo, s, np.float64, 4))
    fem_ref = _scipy(fem_formula_bsr(nx, dof=4))
    op_bdia = DistSpmv(fem_bdia_partition(nx, dof=4, nshards=4, dtype=np.float64), mesh)
    report("dist_spmv_bdia_ring_halo",
           lambda: phase_dist(op_bdia, fem_ref, np.float64, 4))

    op_2d = Dist2DSpmv(partition_2d(a, 2, 2), mesh_2d(2, 2))

    def dist2d():
        x = _vec(a.shape[1], np.float64, 8)
        y = op_2d(x)
        return rel_err(y, s @ x), TOL["float64"], "mesh=2x2"

    report("dist2d_spmv_coo_psum", dist2d)

    def dist_spmm():
        x = _vec((a.shape[1], 32), np.float64, 9)
        return rel_err(op_dia(x), s @ x), TOL["float64"], "k=32"

    report("dist_spmm_dia_ring_halo", dist_spmm)

    def dist_cg(iters=50):
        # the same fixed-iteration CG on one device and on the 4-card
        # padded operator
        b = _vec(a.shape[0], np.float64, 10)
        bp = op_dia.padded(b)
        res = cg(op_dia.padded_op, bp, tol=0.0, maxiter=iters)
        x_dist = np.asarray(res.x)[: a.shape[0]]
        one = cg(a.device_put(), b, tol=0.0, maxiter=iters)
        return (rel_err(x_dist, one.x), 1e-10,
                f"iterations={iters} (tolerance: 50 iterations of the same "
                "recurrence, reduction order differs across shards)")

    report("dist_cg_padded_op", dist_cg)


SMALL = False


def main(argv=None):
    global SMALL
    argv = sys.argv[1:] if argv is None else argv
    SMALL = "--small" in argv  # tiny sizes, for CPU rehearsal with --cpu
    chips = 4 if "--chips" in argv and argv[argv.index("--chips") + 1] == "4" else 1

    from cask_tpu.utils import platform

    platform.start(argv)
    if "--cpu" not in argv:
        platform.require("gpu")
    import jax
    import numpy as np

    jax.config.update("jax_enable_x64", True)
    card = platform.card()
    failed = []

    def report(name, fn):
        t0 = time.time()
        try:
            err, tol, note = fn()
            ok = err <= tol
        except Exception as e:  # a phase that raises is a failed phase
            err, tol, ok, note = float("nan"), float("nan"), False, repr(e)[:300]
        line = (f"PHASE {name} ok={ok} time_s={time.time() - t0:.2f} "
                f"err={err:.3e} tol={tol:.1e} {note} card=[{card}]")
        print(line, flush=True)
        if not ok:
            failed.append(name)

    if chips == 4:
        run_chips4(report)
    else:
        run_one_card(report)

    print(f"nvidia-smi: {card}", flush=True)
    if failed:
        print(f"FAILED phases: {failed}", file=sys.stderr)
        return 1
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {"platform": d[0].platform,
                                             "kind": d[0].device_kind,
                                             "count": len(d)}}), flush=True)
    return 0


def run_one_card(report):
    import numpy as np

    from cask_tpu.formats.convert import bsr_to_csr
    from cask_tpu.formats.generate import power_law, stencil_2d
    from cask_tpu.parallel import fem_formula_bsr

    big, mid, fem_big, fem_mid, n_pl, n_gemm, ilu_side = (
        (40, 24, 12, 8, 3000, 2000, 16) if SMALL
        else (2048, 1024, 1024, 512, 4_000_000, 20_000, 512))

    stencil = stencil_2d(big)
    fem = fem_formula_bsr(fem_big, dof=4)
    for dt in (np.float32, np.float64):
        tag = np.dtype(dt).name
        report(f"spmv_banded_csr_{tag}", lambda dt=dt: phase_spmv(stencil, dt))
        report(f"spmv_fem_bsr_{tag}", lambda dt=dt: phase_spmv(fem, dt))
        report(f"bdia_kernel_vs_xla_{tag}",
               lambda dt=dt: phase_kernel_vs_xla(fem_big, dt))
    del fem
    plaw = power_law(n_pl, avg_degree=12, seed=3)
    for dt in (np.float32, np.float64):
        tag = np.dtype(dt).name
        report(f"spmv_powerlaw_csr_{tag}", lambda dt=dt: phase_spmv(plaw, dt))
    del plaw

    stencil_mid = stencil_2d(mid)
    fem_mid_bsr = fem_formula_bsr(fem_mid, dof=4)
    for k in (32, 128):
        report(f"spmm_csr_k{k}_float32",
               lambda k=k: phase_spmm(stencil_mid, k, np.float32))
        report(f"spmm_bsr_k{k}_float32",
               lambda k=k: phase_spmm(fem_mid_bsr, k, np.float32))

    report("spgemm_powerlaw_aa",
           lambda: phase_spgemm(power_law(n_gemm, avg_degree=8, seed=4)))
    report("tune_fem_bsr", lambda: phase_tune(
        bsr_to_csr(fem_mid_bsr), ROOT / "chiprun_out" / "smoke_tuner.json"))
    report("cg_100_iterations_float64", lambda: phase_cg(stencil))
    report("amg_pcg_float64", lambda: phase_amg(stencil))
    report("ilu0_trisolve_float64", lambda: phase_ilu(stencil_2d(ilu_side)))


if __name__ == "__main__":
    sys.exit(main())
