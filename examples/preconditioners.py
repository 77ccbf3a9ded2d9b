"""Preconditioner tour on a 2-D Poisson problem: iteration counts for
plain CG vs Jacobi, block-Jacobi, Chebyshev-polynomial, host ILU(0) and
device (Chow–Patel) ILU(0).

Run on the accelerator JAX finds (add ``--cpu`` to rehearse on the CPU):
    env PYTHONPATH=. python examples/preconditioners.py
"""

import sys

import jax

from cask_tpu.utils import platform

platform.start(sys.argv)
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from cask_tpu.formats.generate import stencil_2d
from cask_tpu.ops.ilu import ilu0, ilu0_device
from cask_tpu.solvers.krylov import cg
from cask_tpu.solvers.precond import (block_jacobi, chebyshev_precond,
                                      estimate_lmax, jacobi)


def main():
    a = stencil_2d(48)  # 2304-unknown Poisson system
    ad = a.device_put()
    b = jnp.asarray(np.random.default_rng(0).standard_normal(a.shape[0]))

    lmax = estimate_lmax(ad, a.shape[0], iters=30)
    precs = {
        "none": None,
        "jacobi": jacobi(a),
        "block_jacobi(64)": block_jacobi(a, 64),
        "chebyshev(deg=8)": chebyshev_precond(
            ad, lmin=lmax / 100, lmax=lmax, degree=8, M=jacobi(a)),
        "ilu0 (host)": ilu0(a).apply,
        "ilu0 (device, Chow-Patel)": ilu0_device(a, sweeps=8).apply,
    }
    for name, M in precs.items():
        res = cg(ad, b, tol=1e-8, maxiter=1000, M=M)
        print(f"{name:28s} iters={int(res.iterations):4d} "
              f"resid={float(res.residual_norm):.2e} "
              f"converged={bool(res.converged)}")


if __name__ == "__main__":
    main()
