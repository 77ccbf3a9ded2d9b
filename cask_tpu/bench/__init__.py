"""Benchmark harness + CLI (cask analog: R8 benchmark layer)."""

from cask_tpu.bench.harness import bench_matrix, bench_scaling, bench_suite  # noqa: F401
from cask_tpu.bench.roofline import PEAKS, OpTraffic, peaks, spmv_traffic  # noqa: F401
