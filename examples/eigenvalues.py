"""LOBPCG eigensolver example: extremal eigenpairs of a sparse SPD
operator, then feeding the spectrum bounds into a Chebyshev-
preconditioned CG solve.

Run on the accelerator JAX finds (add ``--cpu`` to rehearse on the CPU):
    env PYTHONPATH=. python examples/eigenvalues.py
"""

import sys

import jax

from cask_tpu.utils import platform

platform.start(sys.argv)
jax.config.update("jax_enable_x64", True)

import numpy as np

import cask_tpu
from cask_tpu.solvers import cg, chebyshev_precond, ic0, lobpcg

# 10k-row 2-D Poisson operator
a = cask_tpu.generate.stencil_2d(100)
n = a.shape[0]
rng = np.random.default_rng(0)

# --- smallest eigenpairs (the hard direction): IC(0)-preconditioned ---
x0 = rng.standard_normal((n, 4))
small = lobpcg(a.device_put(), x0, tol=1e-6, maxiter=500, M=ic0(a).apply)
print(f"smallest 4: {np.asarray(small.theta)}  "
      f"({int(small.iterations)} iters, converged={bool(small.converged)})")

# --- largest eigenpairs: unpreconditioned is fine ---
large = lobpcg(a.device_put(), x0, largest=True, tol=1e-6, maxiter=500)
print(f"largest 4:  {np.asarray(large.theta)}  ({int(large.iterations)} iters)")

# --- use the measured spectrum for a Chebyshev-preconditioned solve ---
lmin, lmax = float(small.theta[0]), float(large.theta[-1])
b = rng.standard_normal(n)
M = chebyshev_precond(a.device_put(), lmin=lmin, lmax=lmax, degree=8)
res = cg(a.device_put(), b, tol=1e-10, maxiter=500, M=M)
plain = cg(a.device_put(), b, tol=1e-10, maxiter=2000)
print(f"chebyshev({lmin:.4f},{lmax:.4f})-PCG: {int(res.iterations)} iters "
      f"vs plain CG {int(plain.iterations)}")
assert bool(res.converged)
