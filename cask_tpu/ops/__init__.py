"""Sparse ops: SpMV, SpMM, SpGEMM, triangular solve, ILU(0).

Each op is plain JAX that XLA compiles for the device; where the
structure allows, diagonal-packed plans (DIA/BDIA) replace the gather
formulation, chosen per platform or by the autotuner.  cask analog: the
kernel layer R5 + host runtime R6 (SURVEY.md §2).
"""

from cask_tpu.ops.spmv import spmv  # noqa: F401
from cask_tpu.ops.bdia import BdiaMatrix, bdia_plan  # noqa: F401
from cask_tpu.ops.spmm import spmm  # noqa: F401
from cask_tpu.ops.spgemm import spgemm, SpGEMMPlan  # noqa: F401
from cask_tpu.ops.trisolve import trisolve, TriSolvePlan  # noqa: F401
from cask_tpu.ops.ilu import ilu0, ILU0Factors  # noqa: F401
from cask_tpu.ops.add import sp_add, add_plan, shift_identity, AddPlan  # noqa: F401
