"""Banded SpMV as one Pallas kernel on the GPU's Triton route.

One kernel serves both diagonal-packed plans: a :class:`DiaMatrix` is a
:class:`BdiaMatrix` with 1×1 blocks.  Each program owns a tile of block
rows, loops over the (component, block offset) pairs, loads the shifted
x component with masked loads (the zero padding the XLA formulation
materializes never exists) and keeps one accumulator per block-row
component in registers; y is written once, in natural order.  The COO
remainder is added outside the kernel by the gather formulation.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# block rows per program and warps per program: the fastest of a tile
# sweep on an H100 for dof-4 FEM at 4.2M rows, f32 and f64 (PERF.md)
TILE = 128
NUM_WARPS = 4


def _kernel(vals_ref, x_ref, y_ref, *, pairs, blocksize, shape, tile, acc_dtype):
    br, bc = blocksize
    m, n = shape
    nbr, nbc = -(-m // br), -(-n // bc)
    pid = pl.program_id(0)
    i = pid * tile + jnp.arange(tile)
    rows_ok = i < nbr
    ii = jnp.where(rows_ok, i, 0)  # masked lanes still carry in-bounds indices
    acc = [jnp.zeros((tile,), acc_dtype) for _ in range(br)]
    for j, (c, d) in enumerate(pairs):
        col = (i + d) * bc + c
        ok = rows_ok & (i + d >= 0) & (i + d < nbc) & (col < n)
        xv = plgpu.load(x_ref.at[jnp.where(ok, col, 0)], mask=ok,
                        other=0).astype(acc_dtype)
        for r in range(br):
            v = plgpu.load(vals_ref.at[r, j, ii], mask=rows_ok, other=0)
            acc[r] = acc[r] + v.astype(acc_dtype) * xv
    for r in range(br):
        out = i * br + r
        # masked lanes keep their own (out-of-range) index: the GPU does
        # not touch them, and the interpreter drops them instead of
        # racing a valid lane for the same element
        plgpu.store(y_ref.at[out], acc[r].astype(y_ref.dtype),
                    mask=rows_ok & (out < m))


def banded_spmv(vals, x, *, pairs: Tuple[Tuple[int, int], ...],
                blocksize: Tuple[int, int], shape: Tuple[int, int],
                interpret: bool = False):
    """``y = A x`` for the band held as ``vals[r, j, i]`` (BDIA layout:
    element ``(r, c)`` of the block at block row ``i`` on pair
    ``j = (c, d)``).  ``interpret=True`` runs the kernel on the CPU."""
    br, _ = blocksize
    nbr = -(-shape[0] // br)
    out_dtype = jnp.result_type(vals.dtype, x.dtype)
    acc_dtype = jnp.promote_types(out_dtype, jnp.float32)
    kernel = partial(_kernel, pairs=tuple(pairs), blocksize=tuple(blocksize),
                     shape=tuple(shape), tile=TILE, acc_dtype=acc_dtype)
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((shape[0],), out_dtype),
        grid=(pl.cdiv(nbr, TILE),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="banded_spmv",
    )(vals, x)
