"""Command-line bench driver:  cask-tpu-bench <subcommand>.

cask analog: the benchmark/CLI layer (SURVEY.md §1).  Subcommands:

  spmv   --mtx FILE | --suite small|medium   [--dtype f32|f64]
  spmm   --k 32|128 ...
  scaling [--side N] [--shards 1,2,4,8]
  tune   --mtx FILE [--k N]      (populate the tuner cache explicitly)

Records are JSON lines on stdout; use --out FILE to append to a file.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _load(args):
    from cask_tpu.formats.generate import suite
    from cask_tpu.formats.mtx import read_mtx

    if args.mtx:
        return {args.mtx: read_mtx(args.mtx)}
    return suite(args.suite)


def _dtype(s):
    return {"f32": np.float32, "f64": np.float64, "bf16": "bfloat16"}[s]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="cask-tpu-bench")
    ap.add_argument("--out", default=None, help="append JSON lines to file")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (8 virtual devices) instead of the "
                         "accelerator")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_spmv = sub.add_parser("spmv")
    p_spmm = sub.add_parser("spmm")
    for p in (p_spmv, p_spmm):
        p.add_argument("--mtx", default=None)
        p.add_argument("--suite", default="small", choices=["small", "medium"])
        p.add_argument("--dtype", default="f32", choices=["f32", "f64"])
        p.add_argument("--variants", default=None,
                       help="comma list, e.g. dia_xla,csr_xla")
    p_spmm.add_argument("--k", type=int, default=32)

    p_sc = sub.add_parser("scaling")
    p_sc.add_argument("--side", type=int, default=512)
    p_sc.add_argument("--shards", default="1,2,4,8")

    p_ov = sub.add_parser("overlap")
    p_ov.add_argument("--side", type=int, default=512)
    p_ov.add_argument("--shards", type=int, default=None)

    p_sv = sub.add_parser("solve")
    p_sv.add_argument("--side", type=int, default=512)

    p_tn = sub.add_parser("tune")
    p_tn.add_argument("--mtx", default=None)
    p_tn.add_argument("--suite", default="small", choices=["small", "medium"])
    p_tn.add_argument("--k", type=int, default=None)

    args = ap.parse_args(argv)

    from cask_tpu.utils import platform

    platform.start(["--cpu"] if args.cpu else [])

    out = open(args.out, "a") if args.out else sys.stdout
    try:
        if args.cmd in ("spmv", "spmm"):
            from cask_tpu.bench.harness import bench_matrix

            variants = args.variants.split(",") if args.variants else None
            k = getattr(args, "k", None)
            for name, a in _load(args).items():
                bench_matrix(name, a, k=k, dtype=_dtype(args.dtype),
                             variants=variants, out=out)
        elif args.cmd == "scaling":
            from cask_tpu.bench.harness import bench_scaling

            bench_scaling(side=args.side,
                          nshards_list=[int(s) for s in args.shards.split(",")],
                          out=out)
        elif args.cmd == "overlap":
            from cask_tpu.bench.harness import bench_overlap

            bench_overlap(side=args.side, nshards=args.shards, out=out)
        elif args.cmd == "solve":
            from cask_tpu.bench.harness import bench_solve

            bench_solve(side=args.side, out=out)
        elif args.cmd == "tune":
            from cask_tpu.tune import tune

            for name, a in _load(args).items():
                t = tune(a, k=args.k, force=True)
                print(f"{name}: {t.variant} ({t.seconds_per_op:.3e} s/op)",
                      file=sys.stderr)
    finally:
        if args.out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
