"""Sparse least squares: CGLS on a rectangular matrix, with the
transpose built once.

``cgls`` iterates CG on the normal equations AᵀA x = Aᵀb without forming
AᵀA — each iteration is one SpMV and one transposed SpMV.  The transpose
of any cask_tpu format or plan is a one-time host-side re-encode
(``cask_tpu.transposed``), so the loop pays zero per-iteration
transposition (cask lesson §3.3: no boundary crossing per iteration).

Run on the accelerator JAX finds (add ``--cpu`` to rehearse on the CPU):
    env PYTHONPATH=. python examples/least_squares.py
"""

import sys

import jax

from cask_tpu.utils import platform

platform.start(sys.argv)
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

import cask_tpu
from cask_tpu.solvers import cgls


def main():
    m, n = 4000, 1200
    a = cask_tpu.generate.random_uniform(m, n, density=0.01, seed=0)
    rng = np.random.default_rng(1)
    x_true = rng.standard_normal(n)
    noise = 1e-3 * rng.standard_normal(m)
    b = cask_tpu.to_scipy(a) @ x_true + noise

    # the solver builds A^T once internally; for custom loops do it
    # explicitly:  at = cask_tpu.transposed(a);  spmv(at, r)
    res = cgls(a.device_put(), jnp.asarray(b), tol=1e-10, maxiter=5000)
    x = np.asarray(res.x)

    s = cask_tpu.to_scipy(a)
    normal_res = np.linalg.norm(s.T @ (b - s @ x))
    print(f"converged={bool(res.converged)} iters={int(res.iterations)}")
    print(f"‖Aᵀ(b−Ax)‖ = {normal_res:.3e}")
    print(f"‖x − x_true‖/‖x_true‖ = "
          f"{np.linalg.norm(x - x_true) / np.linalg.norm(x_true):.3e}")
    assert normal_res < 1e-6


if __name__ == "__main__":
    main()
