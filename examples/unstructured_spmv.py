"""Unstructured SpMV: a power-law graph matrix through the gather
formulation and the autotuner.

A scale-free pattern has no band for the DIA plans to pack, so SpMV is
one gather of x per stored entry plus a ``segment_sum`` — work the
GPU's hardware gather serves directly.

Run on the accelerator JAX finds (add ``--cpu`` to rehearse on the CPU):
    env PYTHONPATH=. python examples/unstructured_spmv.py
"""

import sys

import jax

from cask_tpu.utils import platform

platform.start(sys.argv)

import jax.numpy as jnp
import numpy as np

import cask_tpu
from cask_tpu.formats.convert import to_scipy
from cask_tpu.formats.generate import power_law
from cask_tpu.tune import tune


def main():
    a = power_law(20_000, avg_degree=15, dtype=np.float32, seed=1)
    x = np.random.default_rng(0).standard_normal(a.shape[1]).astype(np.float32)

    dev = a.device_put()
    y = jax.jit(cask_tpu.spmv)(dev, jnp.asarray(x))
    ref = to_scipy(a) @ x
    print(f"csr relerr: {np.abs(np.asarray(y) - ref).max() / np.abs(ref).max():.2e}")

    # or let the autotuner pick (it caches the winner by signature)
    t = tune(a, time_budget=2)
    print(f"tuned variant: {t.variant}")


if __name__ == "__main__":
    main()
