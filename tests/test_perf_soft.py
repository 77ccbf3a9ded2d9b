"""Structural performance checks that hold on any platform (SURVEY.md
§4 item 5): counts of bytes and traces, never CPU times — a time taken
here says nothing about the accelerator.
"""

import jax
import numpy as np

from cask_tpu.bench.roofline import spmv_traffic
from cask_tpu.formats.generate import banded, stencil_2d
from cask_tpu.ops.dia import dia_plan


class TestRelativePerf:
    def test_dia_beats_csr_gather_on_band(self):
        # the DIA plan streams no index array: fewer bytes per SpMV than
        # the CSR gather formulation on a full band
        a = banded(20000, 8, seed=0, dtype=np.float32)
        d = dia_plan(a)
        assert d.rem_data.shape[0] == 0
        t_dia = spmv_traffic(d)
        t_csr = spmv_traffic(a)
        assert t_dia.nnz == t_csr.nnz == a.nnz
        assert t_dia.bytes_per_op < 0.75 * t_csr.bytes_per_op

    def test_plan_reuse_beats_replan(self):
        # the held SpGEMM plan's numeric phase traces once and re-runs
        # on new values without re-planning or re-tracing
        from cask_tpu.ops.spgemm import spgemm_plan

        a = stencil_2d(40)
        plan = spgemm_plan(a, a)
        traces = []

        def numeric(ad, bd):
            traces.append(1)
            return plan.numeric(ad, bd).data

        f = jax.jit(numeric)
        c1 = np.asarray(f(a.data, a.data))
        c2 = np.asarray(f(2.0 * np.asarray(a.data), np.asarray(a.data)))
        assert len(traces) == 1
        np.testing.assert_allclose(c2, 2.0 * c1, rtol=1e-13)
