"""Autotuner (cask DSE analog): variant search, timing, cache."""

import numpy as np
import pytest

from cask_tpu import tune
from cask_tpu.formats.convert import to_scipy
from cask_tpu.formats.generate import banded, fem_blocks, power_law, stencil_2d
from cask_tpu.formats.signature import signature
from cask_tpu.tune.timing import measure
from cask_tpu.tune.tuner import enumerate_variants


class TestEnumerate:
    def test_always_has_fallback(self):
        for mat in (stencil_2d(10), power_law(300, seed=1)):
            vs = enumerate_variants(mat, signature(mat), None)
            assert any(v.name == "csr_xla" for v in vs)

    def test_banded_proposes_dia(self):
        a = banded(500, 3, seed=2)
        vs = enumerate_variants(a, signature(a), None)
        assert any(v.name == "dia_xla" for v in vs)
        # dia should be predicted cheapest for a pure band
        best = min(vs, key=lambda v: v.est_bytes)
        assert best.name == "dia_xla"

    def test_powerlaw_skips_dia(self):
        a = power_law(500, avg_degree=5, seed=3)
        vs = enumerate_variants(a, signature(a), None)
        assert not any(v.name == "dia_xla" for v in vs)

    def test_blocky_proposes_bsr(self):
        a = fem_blocks(10, dof=4)
        vs = enumerate_variants(a, signature(a), 32)
        assert any(v.name.startswith("bsr") for v in vs)

    def test_fem_spmv_ranks_bdia_first(self):
        # the north-star class: tuned BSR SpMV beats scalar DIA's
        # block→scalar fill on dof-block matrices (VERDICT r1 item 1)
        a = fem_blocks(23, dof=4)
        vs = enumerate_variants(a, signature(a), None)
        best = min(vs, key=lambda v: v.est_bytes)
        assert best.name == "bdia:4"

    def test_bsr_pallas_spmv_variant_correct(self):
        from cask_tpu.tune.tuner import Variant

        a = fem_blocks(9, dof=4)
        dev, fn = Variant("bdia:4", 0.0).build(a, None)
        rng = np.random.default_rng(0)
        x = rng.standard_normal(a.shape[1])
        np.testing.assert_allclose(
            np.asarray(fn(x)), to_scipy(a) @ x, rtol=1e-10, atol=1e-10
        )


class TestTune:
    def test_result_correct_and_cached(self, tmp_tuner_cache):
        a = stencil_2d(16)
        t1 = tune(a, cache=tmp_tuner_cache, time_budget=2)
        rng = np.random.default_rng(0)
        x = rng.standard_normal(a.shape[1])
        y = t1(x)
        np.testing.assert_allclose(np.asarray(y), to_scipy(a) @ x, rtol=1e-10, atol=1e-10)
        # second call: cache hit (same variant, no re-timing)
        t2 = tune(a, cache=tmp_tuner_cache)
        assert t2.variant == t1.variant
        assert tmp_tuner_cache.get(t1.signature_key) is not None

    def test_spmm_mode(self, tmp_tuner_cache):
        a = fem_blocks(8, dof=4)
        t = tune(a, k=32, cache=tmp_tuner_cache, time_budget=2)
        rng = np.random.default_rng(1)
        x = rng.standard_normal((a.shape[1], 32))
        y = t(x)
        np.testing.assert_allclose(np.asarray(y), to_scipy(a) @ x, rtol=1e-10, atol=1e-9)

    def test_cache_distinguishes_k(self, tmp_tuner_cache):
        a = stencil_2d(12)
        t1 = tune(a, cache=tmp_tuner_cache, time_budget=1)
        t2 = tune(a, k=32, cache=tmp_tuner_cache, time_budget=1)
        assert t1.signature_key != t2.signature_key

    def test_diversity_rule_times_best_xla(self, tmp_tuner_cache):
        # time_budget=1 on a matrix whose top analytic candidate is a
        # plan variant: the gather formulation must STILL be timed (a
        # mis-ranked prefilter must not silently exclude the fallback),
        # and every timed variant's measurement must persist in the
        # cache entry.
        a = fem_blocks(8, dof=4)
        t = tune(a, cache=tmp_tuner_cache, time_budget=1)
        entry = tmp_tuner_cache.get(t.signature_key)
        timings = entry["timings"]
        assert "csr_xla" in timings
        assert len(timings) >= 2
        for rec in timings.values():
            assert rec["seconds_per_op"] > 0 and "spread" in rec


class TestMeasure:
    def test_linear_and_reliable_on_cpu(self):
        import jax.numpy as jnp

        a = stencil_2d(40)
        from cask_tpu import spmv

        dev = a.device_put()
        x0 = jnp.asarray(np.random.default_rng(2).standard_normal(a.shape[1]))
        m = measure(spmv, dev, x0, iters=5)
        assert m.seconds_per_iter > 0
        assert len(m.samples) == 5
        assert min(m.samples) <= m.seconds_per_iter <= max(m.samples)
        assert np.isfinite(m.checksum)

    def test_distinct_inputs_prevent_cse(self):
        # the traced body runs once per compile; every timed call runs it
        import jax.numpy as jnp

        traces = []

        def step(v):
            traces.append(1)
            return v * 2.0

        x0 = jnp.ones(256)
        m = measure(step, x0, iters=7, warmup=3)
        assert len(traces) == 1 and len(m.samples) == 7
        assert m.checksum == 512.0


class TestLellVariant:
    """Removed kernel families are not variants any more."""

    @pytest.mark.parametrize("name", ["lell:8", "poh", "poh_fast:2048",
                                      "poh_mm", "dia_pallas", "bsr_pallas:4"])
    def test_not_enumerated(self, name):
        from cask_tpu.tune.tuner import Variant

        for a in (power_law(500, avg_degree=5, seed=3).astype(np.float32),
                  fem_blocks(8, dof=4), banded(500, 3, seed=2)):
            vs = enumerate_variants(a, signature(a), None)
            assert name not in {v.name for v in vs}
        with pytest.raises(ValueError, match="unknown variant"):
            Variant(name, 0.0).build(banded(50, 1), None)

    @pytest.mark.parametrize("name", ["csr_xla", "bsr_xla:4", "dia_xla",
                                      "bdia:4", "rcm:dia_xla"])
    @pytest.mark.parametrize("k", [None, 8])
    def test_builds_and_correct(self, name, k):
        import jax.numpy as jnp

        from cask_tpu.tune.tuner import Variant

        a = fem_blocks(6, dof=4)
        dev, fn = Variant(name, 0.0).build(a, k)
        rng = np.random.default_rng(0)
        x = rng.standard_normal((a.shape[1], k) if k else a.shape[1])
        np.testing.assert_allclose(
            np.asarray(fn(jnp.asarray(x))), to_scipy(a) @ x, rtol=1e-10, atol=1e-10
        )


class TestReorderVariants:
    """RCM-reordered variants: the data-layout dimension of the DSE."""

    def _shuffled_banded(self, n=1500, bw=4, seed=2):
        import numpy as np

        from cask_tpu.formats.convert import from_scipy, to_scipy
        from cask_tpu.formats.generate import banded

        a0 = banded(n, bw, seed=seed)
        p = np.random.default_rng(0).permutation(n)
        s = to_scipy(a0).tocsr()[p][:, p].tocsr()
        return from_scipy(s, format="csr"), s

    def test_enumerated_when_band_recoverable(self):
        from cask_tpu.formats.signature import signature
        from cask_tpu.tune.tuner import enumerate_variants

        a, _ = self._shuffled_banded()
        names = {v.name for v in enumerate_variants(a, signature(a), None)}
        assert "rcm:dia_xla" in names

    def test_wrapped_fn_matches_scipy(self):
        import jax.numpy as jnp
        import numpy as np

        from cask_tpu.tune.tuner import Variant

        a, s = self._shuffled_banded()
        x = np.random.default_rng(1).standard_normal(a.shape[0])
        for name in ("rcm:dia_xla", "rcm:bdia:1"):
            _, fn = Variant(name, 0.0).build(a, None)
            np.testing.assert_allclose(np.asarray(fn(jnp.asarray(x))), s @ x,
                                       rtol=1e-12, atol=1e-12)

    def test_spmm_wrapped(self):
        import jax.numpy as jnp
        import numpy as np

        from cask_tpu.tune.tuner import Variant

        a, s = self._shuffled_banded()
        X = np.random.default_rng(3).standard_normal((a.shape[0], 8))
        _, fn = Variant("rcm:dia_xla", 0.0).build(a, 8)
        np.testing.assert_allclose(np.asarray(fn(jnp.asarray(X))), s @ X,
                                   rtol=1e-12, atol=1e-12)

    def test_not_enumerated_for_native_banded(self):
        # a matrix already banded gets the direct dia variants, not rcm:
        from cask_tpu.formats.generate import banded
        from cask_tpu.formats.signature import signature
        from cask_tpu.tune.tuner import enumerate_variants

        a = banded(1000, 3, seed=1)
        names = {v.name for v in enumerate_variants(a, signature(a), None)}
        assert "dia_xla" in names
        assert not any(n.startswith("rcm:") for n in names)


class TestCacheKey:
    """The cache key names the platform and device kind: a winner timed
    on one device is never reused on another."""

    def test_key_names_platform_and_device(self, tmp_tuner_cache):
        a = stencil_2d(12)
        t = tune(a, cache=tmp_tuner_cache, time_budget=1)
        assert t.signature_key.startswith("cpu:cpu:")

    def test_gpu_key_differs_and_misses(self, tmp_tuner_cache, monkeypatch):
        from cask_tpu.utils import platform

        a = stencil_2d(12)
        t_cpu = tune(a, cache=tmp_tuner_cache, time_budget=1)
        monkeypatch.setattr(platform, "platform", lambda: "gpu")
        monkeypatch.setattr(platform, "device_kind",
                            lambda: "NVIDIA H100 80GB HBM3")
        from cask_tpu.tune.tuner import cache_key

        key = cache_key(a, None)
        assert key.startswith("gpu:NVIDIA H100 80GB HBM3:")
        assert key != t_cpu.signature_key
        assert tmp_tuner_cache.get(key) is None  # the CPU winner is not reused

    @pytest.mark.parametrize("k", [None, 32])
    def test_key_distinguishes_k(self, k):
        from cask_tpu.tune.tuner import cache_key

        assert cache_key(stencil_2d(8), k).endswith(f":k={k or 0}")


class TestPeaks:
    @pytest.mark.parametrize("kind,bw", [("NVIDIA H100 80GB HBM3", 3.35e12),
                                         ("NVIDIA H100 PCIe", 2.0e12)])
    def test_h100_kinds(self, kind, bw):
        from cask_tpu.bench.roofline import peaks

        p = peaks(kind)
        assert p["hbm_bytes_per_s"] == bw
        assert "data sheet" in p["source"]

    @pytest.mark.parametrize("kind", ["cpu", "AMD Instinct MI300X", "NVIDIA A100-SXM4-80GB"])
    def test_unknown_kind_raises(self, kind):
        from cask_tpu.bench.roofline import peaks

        with pytest.raises(KeyError, match="no published peaks"):
            peaks(kind)


class TestReorderedApi:
    def test_build_full_exposes_reordered_kernel(self):
        import jax.numpy as jnp
        import numpy as np

        from cask_tpu.tune.tuner import TunedSpmv, Variant

        from cask_tpu.formats.convert import to_scipy
        from cask_tpu.formats.generate import banded

        rng = np.random.default_rng(7)
        a0 = banded(120, 3, seed=5)
        p = rng.permutation(120)
        s = to_scipy(a0).toarray()[np.ix_(p, p)]
        import scipy.sparse as sp

        from cask_tpu.formats.convert import from_scipy

        a = from_scipy(sp.csr_matrix(s))
        dev, fn, info = Variant("rcm:dia_xla", 0.0).build_full(a, None)
        assert "perm" in info and "inner_fn" in info
        perm, inner = info["perm"], info["inner_fn"]
        x = rng.standard_normal(120)
        # convenience fn matches A @ x with boundary permutes
        np.testing.assert_allclose(np.asarray(fn(jnp.asarray(x))), s @ x, rtol=1e-12)
        # stay-reordered discipline: permute once, iterate, unpermute once
        xr = jnp.asarray(x[perm])
        for _ in range(3):
            xr = inner(xr)
        ref = x.copy()
        for _ in range(3):
            ref = s @ ref
        assert sorted(perm) == list(range(len(x)))  # perm is a true permutation
        np.testing.assert_allclose(np.asarray(xr)[np.argsort(perm)], ref, rtol=1e-12, atol=1e-10)

        tuned = TunedSpmv(variant="rcm:dia_xla", matrix=dev, _fn=fn,
                          signature_key="t", perm=perm, _inner_fn=inner)
        assert tuned.is_reordered
        rfn, rperm = tuned.reordered()
        np.testing.assert_allclose(
            np.asarray(rfn(jnp.asarray(x[rperm])))[np.argsort(rperm)], s @ x,
            rtol=1e-12, atol=1e-10)

    def test_reordered_raises_on_plain_variant(self):
        import pytest as _pytest

        from cask_tpu.tune.tuner import TunedSpmv

        t = TunedSpmv(variant="csr_xla", matrix=None, _fn=lambda x: x,
                      signature_key="t")
        assert not t.is_reordered
        with _pytest.raises(ValueError):
            t.reordered()


class TestPickFastest:
    """The tuner keeps the variant with the smallest median time."""

    def test_fastest_scripted_variant_wins(self, tmp_tuner_cache, monkeypatch):
        from cask_tpu.tune import tuner as tuner_mod
        from cask_tpu.tune.timing import Measurement

        times = iter([3e-4, 1e-4, 2e-4, 5e-4])
        order = []

        def fake_measure(fn, *args, **kw):
            t = next(times)
            order.append(t)
            return Measurement(seconds_per_iter=t, samples=(t,), checksum=1.0)

        monkeypatch.setattr(tuner_mod, "measure", fake_measure)
        a = fem_blocks(8, dof=4)
        t = tune(a, cache=tmp_tuner_cache, time_budget=3)
        assert t.seconds_per_op == 1e-4
        entry = tmp_tuner_cache.get(t.signature_key)
        assert entry["timings"][t.variant]["seconds_per_op"] == 1e-4

    def test_non_finite_output_never_wins(self, tmp_tuner_cache, monkeypatch):
        from cask_tpu.tune import tuner as tuner_mod
        from cask_tpu.tune.timing import Measurement

        calls = {"n": 0}

        def fake_measure(fn, *args, **kw):
            calls["n"] += 1
            bad = calls["n"] == 1  # the fastest reading has a NaN output
            return Measurement(seconds_per_iter=1e-6 if bad else 1e-3,
                               samples=(1e-3,),
                               checksum=float("nan") if bad else 1.0)

        monkeypatch.setattr(tuner_mod, "measure", fake_measure)
        t = tune(stencil_2d(16), cache=tmp_tuner_cache, time_budget=2)
        assert t.seconds_per_op == 1e-3
