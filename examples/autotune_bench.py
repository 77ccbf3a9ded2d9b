"""Instance-directed tuning — cask's defining idea, JIT-style.

cask ran a design-space exploration per matrix and compiled a bespoke
FPGA bitstream (hours); here the tuner times JIT-compiled kernel
variants (seconds) and caches the winner by sparsity signature, so a
second run — or a *different matrix with the same structure* — skips
straight to the tuned kernel.

Run on the accelerator JAX finds (add ``--cpu`` to rehearse on the CPU):
    env PYTHONPATH=. python examples/autotune_bench.py
"""

import sys

import jax

from cask_tpu.utils import platform

platform.start(sys.argv)

import numpy as np

import cask_tpu
from cask_tpu.bench.harness import bench_matrix


def main():
    mats = {
        "banded_20k": cask_tpu.generate.banded(20000, 8, seed=0),
        "stencil_158": cask_tpu.generate.stencil_2d(158),
        "fem_dof4": cask_tpu.generate.fem_blocks(60, dof=4),
        "powerlaw_20k": cask_tpu.generate.power_law(20000, avg_degree=8, seed=1),
    }
    for name, a in mats.items():
        t = cask_tpu.tune(a, time_budget=3, force=True)
        print(f"{name:14s} → {t.variant:12s} {t.seconds_per_op:.3e} s/op")

    print("\nbench records (f32 SpMV):")
    for name, a in mats.items():
        bench_matrix(name, a)


if __name__ == "__main__":
    main()
