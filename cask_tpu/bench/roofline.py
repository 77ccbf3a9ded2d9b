"""Roofline accounting: bytes-per-op models and the device peak table.

cask's DSE carried an analytic performance model (cycles/nnz) against
the DFE's streaming rate; here it is a bytes model against the memory
bandwidth of the card the bench runs on (SURVEY.md §6).  SpMV and SpMM
at the widths this library serves sit far below the tensor cores'
ridge point, so memory bandwidth is the bound that matters.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Published device-memory bandwidth by ``device_kind`` (NVIDIA H100 data
# sheet, at the full power limit).  A device not listed is an error, not a
# default: a roofline share against a guessed peak is no measurement.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {  # H100 SXM5
        "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 Tensor Core GPU data sheet, SXM5 column",
    },
    "NVIDIA H100 PCIe": {
        "hbm_bytes_per_s": 2.0e12,
        "source": "NVIDIA H100 Tensor Core GPU data sheet, PCIe column",
    },
}


def peaks(device_kind: str) -> dict:
    """Published peaks of ``device_kind``; raises ``KeyError`` if unknown."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind {device_kind!r}; "
                       f"known: {sorted(PEAKS)}") from None


@dataclasses.dataclass
class OpTraffic:
    """Minimal device-memory bytes one application of the op must move."""

    bytes_per_op: int
    flops_per_op: int
    nnz: int

    def record(self, seconds: float, *, bandwidth: float) -> dict:
        achieved = self.bytes_per_op / seconds
        return {
            "seconds_per_op": seconds,
            "achieved_GBs": achieved / 1e9,
            "roofline_frac": achieved / bandwidth,
            "gnnz_per_s": self.nnz / seconds / 1e9,
            "gflops": self.flops_per_op / seconds / 1e9,
        }


def spmv_traffic(matrix, k: int = 1) -> OpTraffic:
    """Bytes/flops for one SpMV/SpMM with the given materialized format."""
    from cask_tpu.formats.matrix import BSR, COO, CSR
    from cask_tpu.ops.bdia import BdiaMatrix
    from cask_tpu.ops.dia import DiaMatrix

    db = np.dtype(matrix.dtype).itemsize if hasattr(matrix, "dtype") else 4
    m, n = matrix.shape
    if isinstance(matrix, (DiaMatrix, BdiaMatrix)):
        true_nnz = int(np.count_nonzero(np.asarray(matrix.vals))) + int(
            matrix.rem_data.shape[0])
        bytes_ = matrix.traffic_bytes + (n + m) * db * k
        return OpTraffic(bytes_, 2 * true_nnz * k, true_nnz)
    if isinstance(matrix, BSR):
        stored = matrix.nnz
        true_nnz = int(np.count_nonzero(np.asarray(matrix.data)))
        bytes_ = stored * db + matrix.n_blocks * 4 + (n + m) * db * k
        return OpTraffic(bytes_, 2 * true_nnz * k, true_nnz)
    if isinstance(matrix, (CSR, COO)):
        nnz = matrix.nnz
        bytes_ = nnz * (db + 4) + (n + m) * db * k
        return OpTraffic(bytes_, 2 * nnz * k, nnz)
    raise TypeError(f"no traffic model for {type(matrix)}")
