"""Aux subsystems: checkpoint/resume, debug validation, DIA transpose, bench."""

import io
import json

import numpy as np
import pytest

from cask_tpu.formats.convert import to_scipy
from cask_tpu.formats.generate import banded, stencil_2d
from cask_tpu.ops.dia import dia_plan, transpose_plan
from cask_tpu.ops.ilu import ilu0
from cask_tpu.utils import checkpoint, debug


class TestCheckpoint:
    def test_csr_roundtrip(self, tmp_path):
        a = stencil_2d(10)
        p = str(tmp_path / "a.npz")
        checkpoint.save_csr(p, a, note="test")
        b, meta = checkpoint.load_csr(p)
        assert meta["note"] == "test"
        np.testing.assert_allclose(b.todense(), a.todense())

    def test_ilu0_resume(self, tmp_path):
        a = stencil_2d(9)
        f = ilu0(a, use_native=False)
        p = str(tmp_path / "ilu.npz")
        checkpoint.save_ilu0(p, f)
        g = checkpoint.load_ilu0(p)
        rng = np.random.default_rng(0)
        b = rng.standard_normal(a.shape[0])
        np.testing.assert_allclose(np.asarray(g.apply(b)), np.asarray(f.apply(b)), rtol=1e-12)

    def test_dia_roundtrip(self, tmp_path):
        a = banded(300, 4, seed=1)
        d = dia_plan(a)
        p = str(tmp_path / "dia.npz")
        checkpoint.save_dia(p, d)
        d2 = checkpoint.load_dia(p)
        assert d2.offsets == d.offsets
        rng = np.random.default_rng(1)
        x = rng.standard_normal(300)
        np.testing.assert_allclose(
            np.asarray(d2.spmv(x)), np.asarray(d.spmv(x)), rtol=1e-13
        )


class TestDiaTranspose:
    @pytest.mark.parametrize("name", ["banded", "stencil"])
    def test_transpose_spmv(self, name):
        a = banded(300, 3, seed=2) if name == "banded" else stencil_2d(17)
        d = dia_plan(a)
        dt = transpose_plan(d)
        rng = np.random.default_rng(2)
        x = rng.standard_normal(a.shape[0])
        y = dt.spmv(x)
        np.testing.assert_allclose(np.asarray(y), to_scipy(a).T @ x, rtol=1e-12, atol=1e-12)

    def test_spmv_dispatch_transpose(self):
        from cask_tpu import spmv

        a = banded(300, 3, seed=3)
        rng = np.random.default_rng(3)
        x = rng.standard_normal(300)
        y = spmv(a, x, transpose=True, method="dia")
        np.testing.assert_allclose(np.asarray(y), to_scipy(a).T @ x, rtol=1e-12, atol=1e-12)


class TestDebug:
    def test_check_csr_passes(self):
        debug.check_csr(stencil_2d(8))

    def test_check_csr_catches_oob(self):
        a = stencil_2d(8)
        bad = type(a)(
            data=np.asarray(a.data),
            indices=np.asarray(a.indices).copy(),
            indptr=a.indptr,
            shape=a.shape,
        )
        np.asarray(bad.indices)[0] = 64  # out of bounds
        with pytest.raises(AssertionError):
            debug.check_csr(bad)

    def test_check_partition(self):
        from cask_tpu.parallel import partition_coo, partition_dia

        a = stencil_2d(16)
        debug.check_partition(partition_coo(a, 4))
        debug.check_partition(partition_dia(a, 4))

    def test_check_permutation(self):
        from cask_tpu.formats.reorder import rcm_permutation

        debug.check_permutation(rcm_permutation(stencil_2d(9)))
        with pytest.raises(AssertionError):
            debug.check_permutation(np.array([0, 0, 2]))


class TestBenchHarness:
    def test_records_schema(self):
        from cask_tpu.bench.harness import bench_matrix

        buf = io.StringIO()
        recs = bench_matrix("t", stencil_2d(16), variants=["csr_xla"], out=buf)
        assert len(recs) == 1
        line = json.loads(buf.getvalue().strip())
        for key in ("matrix", "op", "variant", "seconds_per_op", "platform",
                    "device_kind", "device_count"):
            assert key in line
        # a CPU time is never reported as a share of a device's peak
        assert line["platform"] == "cpu" and "roofline_frac" not in line

    def test_scaling_records(self):
        from cask_tpu.bench.harness import bench_scaling

        buf = io.StringIO()
        recs = bench_scaling(side=32, nshards_list=(1, 2), out=buf)
        assert len(recs) == 2
        assert recs[0]["efficiency"] == 1.0


class TestProfiling:
    def test_trace_writes_files(self, tmp_path):
        import jax.numpy as jnp

        from cask_tpu.utils.profiling import annotate, trace

        d = str(tmp_path / "trace")
        with trace(d):
            with annotate("spmv-ish"):
                (jnp.ones((64, 64)) @ jnp.ones((64, 64))).block_until_ready()
        import os

        found = any(files for _, _, files in os.walk(d))
        assert found


_SYNTHETIC_TRACE = """
planes {
  id: 1
  name: "/device:GPU:0"
  lines {
    id: 1
    name: "Stream #13(Compute)"
    timestamp_ns: 1000
    events { metadata_id: 1 offset_ps: 0 duration_ps: 5000000 }
    events { metadata_id: 2 offset_ps: 3000000 duration_ps: 4000000 }
    events { metadata_id: 1 offset_ps: 20000000 duration_ps: 5000000 }
  }
  lines {
    id: 2
    name: "XLA Ops"
    timestamp_ns: 1000
    events { metadata_id: 1 offset_ps: 0 duration_ps: 99000000 }
  }
  event_metadata { key: 1 value { id: 1 name: "loop_fusion" } }
  event_metadata { key: 2 value { id: 2 name: "copy" } }
}
planes { id: 2 name: "/host:CPU" }
"""


class TestDeviceKernels:
    """The trace → device metrics reduction the bench uses."""

    def _profile(self, text):
        from jax.profiler import ProfileData

        return ProfileData.from_serialized_xspace(
            ProfileData.text_proto_to_serialized_xspace(text))

    def test_busy_window_and_kernels(self):
        from cask_tpu.utils.profiling import reduce_device_planes

        red = reduce_device_planes(self._profile(_SYNTHETIC_TRACE))
        # stream events only (the derived "XLA Ops" line is ignored);
        # overlapping intervals count once
        assert red == {"busy_ns": 12000.0, "window_ns": 25000.0,
                       "kernels": {"loop_fusion": 10000.0, "copy": 4000.0}}

    def test_cpu_trace_has_no_device_plane(self, tmp_path):
        import jax.numpy as jnp

        from cask_tpu.utils.profiling import device_kernels, trace

        with trace(str(tmp_path)):
            (jnp.ones(64) * 2).block_until_ready()
        assert device_kernels(str(tmp_path)) is None
        assert device_kernels(str(tmp_path / "empty")) is None


class TestSolverOperator:
    def test_uniform_interface(self):
        import cask_tpu

        a = cask_tpu.generate.stencil_2d(95)
        op = cask_tpu.solver_operator(a)
        b = np.random.default_rng(0).standard_normal(a.shape[0])
        res = cask_tpu.solvers.cg(op, op.to_padded(b), tol=1e-8, maxiter=600)
        x = np.asarray(op.from_padded(res.x))
        np.testing.assert_allclose(to_scipy(a) @ x, b, rtol=1e-5, atol=1e-6)
