"""The route module: which formulation each public entry point takes on a
platform, the compile-cache helper, and the absence of any Pallas kernel
on the routes a GPU runs."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cask_tpu
from cask_tpu.formats.convert import csr_to_bsr, to_scipy
from cask_tpu.formats.generate import banded, fem_blocks, power_law, stencil_2d
from cask_tpu.utils import platform

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _primitives(jaxpr):
    """Every primitive name in a (closed) jaxpr, sub-jaxprs included."""
    jaxpr = getattr(jaxpr, "jaxpr", jaxpr)
    names = set()
    for eqn in jaxpr.eqns:
        names.add(eqn.primitive.name)
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if hasattr(sub, "eqns") or hasattr(sub, "jaxpr"):
                    names |= _primitives(sub)
    return names


class TestRoutes:
    def test_cpu_builds_no_plans(self):
        assert platform.platform() == "cpu"
        assert not platform.auto_plan("dia") and not platform.auto_plan("bdia")

    @pytest.mark.parametrize("plan", ["dia", "bdia"])
    def test_gpu_table_is_consulted(self, as_gpu, plan):
        assert platform.auto_plan(plan) == (plan in platform.AUTO_PLANS["gpu"])

    def test_require_refuses_another_platform(self):
        with pytest.raises(RuntimeError, match="needs a gpu device"):
            platform.require("gpu")
        assert platform.require("cpu")[0].platform == "cpu"

    @pytest.mark.parametrize("kind", ["csr", "bsr"])
    def test_gpu_auto_route_matches_scipy(self, as_gpu, kind):
        # the SpMM route runs here (the BDIA SpMV kernel compiles only
        # for the card); its plan is the one SpMV uses too
        a = banded(600, 4, seed=3) if kind == "csr" else fem_blocks(10, dof=4)
        m = a if kind == "csr" else csr_to_bsr(a, (4, 4))
        x = np.random.default_rng(0).standard_normal((a.shape[1], 3))
        np.testing.assert_allclose(np.asarray(cask_tpu.spmm(m, x)),
                                   to_scipy(a) @ x, rtol=1e-12, atol=1e-12)
        plan = getattr(m, f"_{'dia' if kind == 'csr' else 'bdia'}_auto_plan", None)
        assert (plan is not None) == platform.auto_plan(
            "dia" if kind == "csr" else "bdia")


class TestNoPallasOnGpu:
    """With the platform reported as ``gpu``, the only ``pallas_call`` any
    entry point traces is the banded kernel, and only on the route the
    table gives it (BDIA SpMV); everything else is plain JAX."""

    def test_spmv_spmm(self, as_gpu):
        bsr = csr_to_bsr(fem_blocks(8, dof=4), (4, 4))
        for a in (stencil_2d(20), bsr, power_law(300, seed=1)):
            x = jnp.ones(a.shape[1])
            X = jnp.ones((a.shape[1], 8))
            for f, v in ((cask_tpu.spmv, x), (cask_tpu.spmm, X)):
                jaxpr = jax.make_jaxpr(lambda v, f=f, a=a: f(a, v))(v)
                prims = _primitives(jaxpr)
                if a is bsr and f is cask_tpu.spmv:
                    assert "banded_spmv" in str(jaxpr)
                    assert str(jaxpr).count("pallas_call") == 1
                else:
                    assert "pallas_call" not in prims and prims

    def test_solver_operator_and_amg(self, as_gpu):
        from cask_tpu.solvers import cg, smoothed_aggregation_amg

        a = stencil_2d(48)
        op = cask_tpu.solver_operator(a)
        M = smoothed_aggregation_amg(a)
        b = jnp.ones(a.shape[0])
        prims = _primitives(jax.make_jaxpr(
            lambda bb, MM: cg(op, bb, maxiter=3, M=MM).x)(b, M))
        assert "pallas_call" not in prims and "while" in prims

    def test_dist_spmv(self, as_gpu):
        from cask_tpu.parallel import (DistSpmv, fem_bdia_partition,
                                       partition_coo, partition_dia, row_mesh)

        a = stencil_2d(16)
        for plan in (partition_dia(a, 4), partition_coo(a, 4),
                     fem_bdia_partition(8, dof=4, nshards=4)):
            op = DistSpmv(plan, row_mesh(4))
            xp = op.padded(jnp.ones(plan.shape[1]))
            prims = _primitives(jax.make_jaxpr(op.padded_op_with)(op.operands, xp))
            assert "pallas_call" not in prims and "shard_map" in prims

    def test_tune(self, as_gpu, tmp_tuner_cache):
        # SpMM tuning: every variant is an XLA formulation
        a = fem_blocks(8, dof=4)
        t = cask_tpu.tune(a, k=8, cache=tmp_tuner_cache, time_budget=4)
        assert t.signature_key.startswith("gpu:NVIDIA H100")
        from cask_tpu.tune.tuner import _apply

        X = jnp.ones((a.shape[1], 8))
        prims = _primitives(jax.make_jaxpr(_apply)(t.matrix, X))
        assert "pallas_call" not in prims
        np.testing.assert_allclose(np.asarray(t(X)), to_scipy(a) @ np.ones((a.shape[1], 8)),
                                   rtol=1e-12, atol=1e-12)

    def test_no_pallas_module_imported(self):
        code = ("import sys, cask_tpu, cask_tpu.bench, cask_tpu.parallel; "
                "print([m for m in sys.modules if 'pallas' in m])")
        out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                             text=True, timeout=300,
                             env={**os.environ, "JAX_PLATFORMS": "cpu",
                                  "PYTHONPATH": _REPO})
        assert out.returncode == 0, out.stderr[-1000:]
        assert out.stdout.strip() == "[]"


class TestCompileCache:
    def test_env_var_wins_and_nothing_is_set(self, monkeypatch):
        calls = []
        monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
        assert platform.setup_compile_cache() == "/elsewhere/cache"
        assert calls == []

    def test_unset_uses_checkout_cache(self, monkeypatch):
        calls = []
        monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        d = platform.setup_compile_cache()
        assert d == os.path.join(_REPO, ".jax_cache")
        assert calls == [("jax_compilation_cache_dir", d)]

    def test_cache_dir_is_gitignored(self):
        with open(os.path.join(_REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()

    def test_start_without_cpu_flag_keeps_platform(self, monkeypatch):
        calls = []
        monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        platform.start(["--small"])
        assert [c[0] for c in calls] == ["jax_compilation_cache_dir"]


class TestCard:
    def test_card_without_nvidia_smi(self, monkeypatch):
        monkeypatch.setenv("PATH", "/nonexistent")
        assert platform.card() == "not available"

    def test_device_record_names_the_device(self):
        from cask_tpu.bench.harness import device_record

        rec = device_record()
        assert rec["platform"] == "cpu" and rec["device_count"] == 8
        assert set(rec) == {"platform", "device_kind", "device_count", "card"}


class TestDeviceGen:
    """The natural BDIA layout built on the device equals the host plan
    of the same matrix, whose pattern is ``generate.fem_blocks``'."""

    @pytest.mark.parametrize("nx,ny,dof", [(12, None, 4), (9, 5, 3), (16, None, 2)])
    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_fem_bdia_device_equals_host(self, nx, ny, dof, dtype):
        from cask_tpu.formats.device_gen import fem_bdia_device
        from cask_tpu.ops.bdia import bdia_plan
        from cask_tpu.parallel import fem_formula_bsr

        host = fem_formula_bsr(nx, ny, dof=dof, dtype=dtype)
        dev = fem_bdia_device(nx, ny, dof=dof, dtype=dtype)
        ref = bdia_plan(host, (dof, dof))
        assert dev.block_offsets == ref.block_offsets
        np.testing.assert_array_equal(np.asarray(dev.vals), np.asarray(ref.vals))
        # the block pattern is fem_blocks' own
        blocks = csr_to_bsr(fem_blocks(nx, ny, dof=dof), (dof, dof))
        np.testing.assert_array_equal(np.asarray(host.indptr),
                                      np.asarray(blocks.indptr))
        np.testing.assert_array_equal(np.asarray(host.indices),
                                      np.asarray(blocks.indices))
