"""Device-side matrix generation (no host→device bulk transfer).

A stencil's diagonals are formulaic, so the packed DIA/BDIA value arrays
can be computed by the XLA program itself: benches build operands of
hundreds of MB on the device in milliseconds instead of generating,
packing and copying them from the host.  Each builder's plan is
identical to the host route it mirrors (see the docstrings).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from cask_tpu.ops.dia import DiaMatrix


def stencil2d_dia_device(nx: int, ny: int | None = None, *, dtype=jnp.float32) -> DiaMatrix:
    """5-point Laplacian on an nx×ny grid as a device-resident DiaMatrix.

    Diagonals (offsets −ny, −1, 0, +1, +ny):
      main = 4; ±1 = −1 unless crossing a grid-row boundary; ±ny = −1
      within bounds.  Matches ``dia_plan(stencil_2d(nx, ny))`` exactly.
    """
    ny = ny or nx
    n = nx * ny
    r = jnp.arange(n)
    col_in_row = r % ny  # position within a grid row

    def diag(off):
        if off == 0:
            v = jnp.full(n, 4.0)
        elif off == 1:
            v = jnp.where((r + 1 < n) & (col_in_row != ny - 1), -1.0, 0.0)
        elif off == -1:
            v = jnp.where((r >= 1) & (col_in_row != 0), -1.0, 0.0)
        elif off == ny:
            v = jnp.where(r + ny < n, -1.0, 0.0)
        elif off == -ny:
            v = jnp.where(r >= ny, -1.0, 0.0)
        else:
            raise ValueError(off)
        return v.astype(dtype)

    offsets = tuple(sorted({-ny, -1, 0, 1, ny}))
    vals = jnp.stack([diag(o) for o in offsets])
    return DiaMatrix(
        vals=vals,
        rem_data=jnp.zeros((0,), dtype),
        rem_row=jnp.zeros((0,), jnp.int32),
        rem_col=jnp.zeros((0,), jnp.int32),
        offsets=offsets,
        shape=(n, n),
    )


@partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _fem_vals(nx: int, ny: int, dof: int, dtype):
    from cask_tpu.parallel.partition import _fem_formula_val, _fem_offset_mask

    nbr = nx * ny
    i = jnp.arange(nbr)
    offsets = sorted({-ny, -1, 0, 1, ny})
    rows = []
    for r in range(dof):
        planes = []
        for dpos, off in enumerate(offsets):
            ok = _fem_offset_mask(i, off, ny, nbr)
            for c in range(dof):
                v = _fem_formula_val(i, dpos, r, c, dof)
                if off == 0 and r == c:
                    v = v + 4.0 * dof
                planes.append(jnp.where(ok, v, 0.0).astype(dtype))
        rows.append(jnp.stack(planes))
    return jnp.stack(rows)  # (dof, npairs, nbr)


def fem_bdia_device(nx: int, ny: int | None = None, *, dof: int = 4,
                    dtype=jnp.float32):
    """Multi-dof FEM-stencil matrix as a device-resident BdiaMatrix.

    The matrix of :func:`cask_tpu.parallel.fem_formula_bsr` (the
    connectivity of ``generate.fem_blocks``: 5 block diagonals −ny, −1,
    0, +1, +ny of dense dof×dof blocks, grid-row wrap blocks structurally
    zero, diagonal blocks shifted by 4·dof), with the same deterministic
    values; equal to ``bdia_plan(fem_formula_bsr(nx, ny, dof=dof))``.
    """
    from cask_tpu.ops.bdia import BdiaMatrix

    ny = ny or nx
    nbr = nx * ny
    return BdiaMatrix(
        vals=_fem_vals(nx, ny, dof, jnp.dtype(dtype)),
        rem_data=jnp.zeros((0,), dtype),
        rem_row=jnp.zeros((0,), jnp.int32),
        rem_col=jnp.zeros((0,), jnp.int32),
        block_offsets=tuple(sorted({-ny, -1, 0, 1, ny})),
        shape=(nbr * dof, nbr * dof),
        blocksize=(dof, dof),
    )

