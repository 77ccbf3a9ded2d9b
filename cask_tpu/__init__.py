"""cask_tpu — a sparse linear-algebra framework in JAX.

A from-scratch reimplementation of the capability surface of caskorg/cask
(an FPGA/Maxeler sparse-kernel library with instance-directed tuning),
redesigned for accelerators that XLA compiles for (an NVIDIA H100 is the
measured target):

- Sparse formats (CSR / COO / BSR) as JAX pytrees with host-side
  preprocessing (cask analog: ``CsrMatrix`` + DFE stream encoding).
- SpMV / SpMM / SpGEMM / sparse triangular solve / ILU(0) as jittable ops
  in plain JAX, with diagonal-packed (DIA/BDIA) plans on the banded hot
  paths (cask analog: MaxJ dataflow kernels + host runtime).
- A per-matrix autotuner searching block size / layout / kernel variant,
  cached by sparsity signature (cask analog: the DSE + codegen layer —
  JIT compilation replaces bitstream builds).
- Multi-chip scaling via ``jax.sharding.Mesh`` + ``shard_map`` with
  row-partitioned matrices and halo exchange overlapped with local
  compute (no cask analog — it was single-DFE).

The reference mount for caskorg/cask was empty during both the survey and
build sessions (see SURVEY.md "PROVENANCE NOTICE"); capability parity is
built against the driver's BASELINE.json specification.
"""

__version__ = "0.1.0"

from cask_tpu.formats import COO, CSR, BSR  # noqa: F401
from cask_tpu.formats.convert import (  # noqa: F401
    from_scipy,
    to_scipy,
    coo_to_csr,
    csr_to_coo,
    csr_to_bsr,
    bsr_to_csr,
    transpose,
)
from cask_tpu.formats.mtx import read_mtx, write_mtx  # noqa: F401
from cask_tpu.formats import generate  # noqa: F401
from cask_tpu.formats.reorder import reorder_rcm, bandwidth  # noqa: F401
from cask_tpu.ops import spmv, spmm, spgemm, trisolve, ilu0, sp_add, shift_identity  # noqa: F401
from cask_tpu.ops.spmv import transposed  # noqa: F401
from cask_tpu.ops.dia import DiaMatrix, DiaOperator, dia_plan, solver_operator  # noqa: F401
from cask_tpu.ops.bdia import BdiaMatrix, BdiaOperator, bdia_plan  # noqa: F401
from cask_tpu.tune import tune, TunedSpmv  # noqa: F401
from cask_tpu import solvers  # noqa: F401
from cask_tpu import parallel  # noqa: F401
from cask_tpu import utils  # noqa: F401
