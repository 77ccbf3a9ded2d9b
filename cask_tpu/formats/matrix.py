"""Sparse matrix containers as JAX pytrees.

cask analog: the ``CsrMatrix`` frontend class and the DFE stream encodings
(SURVEY.md §2 R1/R2).  Here a sparse matrix is a dataclass of arrays
(pytree leaves) plus static metadata (pytree aux data), so matrices flow
through ``jax.jit`` / ``shard_map`` like any other JAX value.

Conventions
-----------
- Indices are ``int32`` (the accelerator's native index width).
- Arrays may be host ``numpy`` arrays or device ``jax.Array``s; host-side
  preprocessing (construction, conversion, reordering) happens in numpy /
  the native C++ core, device placement via :meth:`device_put`.
- ``shape`` is the *logical* shape.  BSR stores rows/cols padded up to the
  block size; padded tail entries are structural zeros, so no runtime
  masking is needed in kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import numpy as np

Array = Any  # np.ndarray | jax.Array


def _nnz_like(x) -> int:
    return int(x.shape[0])


def _is_device(x) -> bool:
    return isinstance(x, jax.Array)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class COO:
    """Coordinate-format sparse matrix.

    ``data[k]`` sits at ``(row[k], col[k])``.  Duplicate coordinates are
    allowed at construction and are summed by :func:`coo_to_csr`.
    """

    data: Array  # (nnz,)
    row: Array  # (nnz,) int32
    col: Array  # (nnz,) int32
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))

    @property
    def nnz(self) -> int:
        return _nnz_like(self.data)

    @property
    def dtype(self):
        return self.data.dtype

    def device_put(self, device=None) -> "COO":
        return COO(
            data=jax.device_put(self.data, device),
            row=jax.device_put(self.row, device),
            col=jax.device_put(self.col, device),
            shape=self.shape,
        )

    def todense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=np.asarray(self.data).dtype)
        np.add.at(out, (np.asarray(self.row), np.asarray(self.col)), np.asarray(self.data))
        return out

    def astype(self, dtype) -> "COO":
        """Copy with values cast to ``dtype`` (indices unchanged)."""
        return dataclasses.replace(self, data=self.data.astype(dtype))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed-sparse-row matrix.

    Row ``i`` owns ``data[indptr[i]:indptr[i+1]]`` with column indices
    ``indices[indptr[i]:indptr[i+1]]``.  Column indices within a row are
    kept sorted by the constructors in :mod:`cask_tpu.formats.convert`.
    """

    data: Array  # (nnz,)
    indices: Array  # (nnz,) int32 column indices
    indptr: Array  # (nrows + 1,) int32
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))

    @property
    def nnz(self) -> int:
        return _nnz_like(self.data)

    @property
    def dtype(self):
        return self.data.dtype

    def device_put(self, device=None) -> "CSR":
        return CSR(
            data=jax.device_put(self.data, device),
            indices=jax.device_put(self.indices, device),
            indptr=jax.device_put(self.indptr, device),
            shape=self.shape,
        )

    def todense(self) -> np.ndarray:
        indptr = np.asarray(self.indptr)
        indices = np.asarray(self.indices)
        data = np.asarray(self.data)
        out = np.zeros(self.shape, dtype=data.dtype)
        rows = np.repeat(np.arange(self.shape[0]), np.diff(indptr))
        out[rows, indices] = out[rows, indices] + data
        return out

    def row_lengths(self) -> np.ndarray:
        return np.diff(np.asarray(self.indptr))

    def astype(self, dtype) -> "CSR":
        """Copy with values cast to ``dtype`` (indices unchanged)."""
        return dataclasses.replace(self, data=self.data.astype(dtype))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BSR:
    """Block-sparse-row matrix with dense ``(br, bc)`` blocks.

    The performance format for block-structured matrices: a block
    multiply is a small dense matmul, which turns CSR's scalar x-gather into
    contiguous vector loads (SURVEY.md §7 hard-part (b)).  Logical shape
    may not divide the block size; rows/cols are zero-padded up to
    ``padded_shape`` and padding entries are structural zeros.

    ``data`` has shape ``(n_blocks, br, bc)``; block-row ``i`` owns blocks
    ``indptr[i]:indptr[i+1]`` with block-column indices from ``indices``.
    """

    data: Array  # (n_blocks, br, bc)
    indices: Array  # (n_blocks,) int32 block-column indices
    indptr: Array  # (n_block_rows + 1,) int32
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    blocksize: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))

    @property
    def n_blocks(self) -> int:
        return int(self.data.shape[0])

    @property
    def nnz(self) -> int:
        """Stored entries (block area × block count), counting block fill."""
        br, bc = self.blocksize
        return self.n_blocks * br * bc

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def padded_shape(self) -> Tuple[int, int]:
        br, bc = self.blocksize
        m, n = self.shape
        return (-(-m // br) * br, -(-n // bc) * bc)

    @property
    def n_block_rows(self) -> int:
        return self.padded_shape[0] // self.blocksize[0]

    @property
    def n_block_cols(self) -> int:
        return self.padded_shape[1] // self.blocksize[1]

    def device_put(self, device=None) -> "BSR":
        return BSR(
            data=jax.device_put(self.data, device),
            indices=jax.device_put(self.indices, device),
            indptr=jax.device_put(self.indptr, device),
            shape=self.shape,
            blocksize=self.blocksize,
        )

    def todense(self) -> np.ndarray:
        br, bc = self.blocksize
        pm, pn = self.padded_shape
        data = np.asarray(self.data)
        indices = np.asarray(self.indices)
        indptr = np.asarray(self.indptr)
        out = np.zeros((pm, pn), dtype=data.dtype)
        for bi in range(self.n_block_rows):
            for k in range(int(indptr[bi]), int(indptr[bi + 1])):
                bj = int(indices[k])
                out[bi * br : (bi + 1) * br, bj * bc : (bj + 1) * bc] += data[k]
        return out[: self.shape[0], : self.shape[1]]

    def fill_ratio(self) -> float:
        """Stored entries / true nonzeros.  1.0 = no block fill."""
        data = np.asarray(self.data)
        true_nnz = int(np.count_nonzero(data))
        return float(self.nnz) / max(true_nnz, 1)

    def astype(self, dtype) -> "BSR":
        """Copy with values cast to ``dtype`` (indices unchanged)."""
        return dataclasses.replace(self, data=self.data.astype(dtype))
