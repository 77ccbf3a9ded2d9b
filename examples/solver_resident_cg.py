"""CG over a DIA plan built once: ``solver_operator`` packs the banded
matrix's diagonals, so each of the Krylov loop's hundreds of SpMVs is one
fused shifted-FMA pass with no gathers and no index stream.

Run on the accelerator JAX finds (add ``--cpu`` to rehearse on the CPU):
    env PYTHONPATH=. python examples/solver_resident_cg.py
"""

import sys

import jax

from cask_tpu.utils import platform

platform.start(sys.argv)

import numpy as np

import cask_tpu


def main():
    a = cask_tpu.generate.stencil_2d(95)  # SPD Poisson, 9025 unknowns
    op = cask_tpu.solver_operator(a)
    print(f"DIA plan: offsets {op.dia.offsets}")

    rng = np.random.default_rng(0)
    b = rng.standard_normal(a.shape[0])
    res = cask_tpu.solvers.cg(op, op.to_padded(b), tol=1e-8, maxiter=800)
    x = np.asarray(op.from_padded(res.x))
    err = np.abs(cask_tpu.to_scipy(a) @ x - b).max()
    print(f"CG: {int(res.iterations)} iterations, converged={bool(res.converged)}, "
          f"‖Ax−b‖∞ = {err:.2e}")


if __name__ == "__main__":
    main()
