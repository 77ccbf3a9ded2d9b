"""Multi-chip distribution: partitioning, halo exchange, mesh executors."""

from cask_tpu.parallel.dist import (  # noqa: F401
    AXIS,
    Dist2DSpmv,
    DistSpmv,
    mesh_2d,
    row_mesh,
)
from cask_tpu.parallel.partition import (  # noqa: F401
    BdiaPartition,
    Coo2DPartition,
    CooPartition,
    DiaPartition,
    fem_bdia_partition,
    fem_formula_bsr,
    partition_2d,
    partition_bdia,
    partition_coo,
    partition_dia,
    stencil_dia_partition,
)
