"""ILU(0)-preconditioned CG on a 2-D Poisson problem.

cask analog: the iterative-solver demo (SURVEY.md §2 R7) — but where
cask paid a PCIe round trip per iteration for host-side vector ops
(§3.3), here the whole solve is one jitted device program.

Run on the accelerator JAX finds (add ``--cpu`` to rehearse on the CPU):
    env PYTHONPATH=. python examples/cg_solver.py
"""

import sys

import jax

from cask_tpu.utils import platform

platform.start(sys.argv)
jax.config.update("jax_enable_x64", True)

import numpy as np

import cask_tpu


def main():
    side = 64
    a = cask_tpu.generate.stencil_2d(side)  # SPD Poisson, 4096 unknowns
    rng = np.random.default_rng(0)
    b = rng.standard_normal(a.shape[0])

    plain = cask_tpu.solvers.cg(a, b, tol=1e-10, maxiter=2000)
    print(f"plain CG:  {int(plain.iterations):4d} iterations, "
          f"residual {float(plain.residual_norm):.2e}")

    factors = cask_tpu.ilu0(a)  # native C++ factorization
    pcg = cask_tpu.solvers.cg(a, b, tol=1e-10, maxiter=2000, M=factors.apply)
    print(f"ILU(0)-CG: {int(pcg.iterations):4d} iterations, "
          f"residual {float(pcg.residual_norm):.2e}")

    x = np.asarray(pcg.x)
    err = np.abs(cask_tpu.to_scipy(a) @ x - b).max()
    print(f"‖Ax − b‖∞ = {err:.2e}")


if __name__ == "__main__":
    main()
