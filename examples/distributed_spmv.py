"""Row-partitioned SpMV with overlapped halo exchange on a device mesh.

BASELINE config 5 at demo scale over every visible device: the cards of
one host (NVLink), or 8 virtual CPU devices with ``--cpu``.

Run on the accelerator JAX finds (add ``--cpu`` to rehearse on the CPU):
    env PYTHONPATH=. python examples/distributed_spmv.py
"""

import sys

import jax

from cask_tpu.utils import platform

platform.start(sys.argv)

import numpy as np

import cask_tpu
from cask_tpu.parallel import DistSpmv, partition_dia, row_mesh


def main():
    ndev = len(jax.devices())
    print(f"devices: {ndev}")
    a = cask_tpu.generate.stencil_2d(256, dtype=np.float32)  # 65k rows
    plan = partition_dia(a, ndev)
    print(f"partition: {plan.nshards} shards × {plan.mloc} rows, "
          f"{plan.vals.shape[1]} diagonals, halo ±{plan.halo_lo}/{plan.halo_hi}")

    op = DistSpmv(plan, row_mesh(ndev))
    x = np.random.default_rng(0).standard_normal(a.shape[1]).astype(np.float32)
    y = op(x)
    err = np.abs(np.asarray(y) - cask_tpu.to_scipy(a) @ x).max()
    print(f"‖y − ref‖∞ = {err:.2e}")

    # device-resident distributed CG on the padded sharded vectors
    # (f32 Poisson at 65k unknowns: expect O(500–1500) iterations)
    b = op.padded(x)
    res = cask_tpu.solvers.cg(op.padded_op, b, tol=1e-4, maxiter=2000)
    print(f"distributed CG: {int(res.iterations)} iterations, "
          f"converged={bool(res.converged)}")


if __name__ == "__main__":
    main()
