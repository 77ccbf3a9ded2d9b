"""Test harness: the CPU backend with 8 virtual devices and exact f64.

This is the Maxeler-simulation-mode analog (SURVEY.md §4): all kernel
logic and all multi-device sharding logic run on the CPU without an
accelerator.  The platform is set through jax.config before the first
backend use, so the tests run on the CPU whatever JAX_PLATFORMS says.

Tests marked ``gpu`` need an NVIDIA GPU; the ``_gpu_only`` fixture skips
them elsewhere (decided per test, never at import, so every worker
collects the same tests).  Run them on a GPU machine with
``python -m pytest -m gpu tests/ -p no:cacheprovider -o addopts=""``
after removing the CPU override (``CASK_TESTS_ON_DEVICE=1``).
"""

import os

ON_DEVICE = os.environ.get("CASK_TESTS_ON_DEVICE") == "1"

if not ON_DEVICE:
    # Must precede first backend initialization (not merely jax import).
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    )

import jax  # noqa: E402

if not ON_DEVICE:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _gpu_only(request):
    if request.node.get_closest_marker("gpu") is None:
        return
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX found "
                    f"{jax.devices()[0].platform})")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(12345)


@pytest.fixture()
def tmp_tuner_cache(tmp_path):
    from cask_tpu.tune.cache import TunerCache

    return TunerCache(path=str(tmp_path / "tuner.json"))


@pytest.fixture()
def auto_plans(monkeypatch):
    """Let the auto routes build DIA/BDIA plans on the test platform."""
    from cask_tpu.utils import platform

    monkeypatch.setitem(platform.AUTO_PLANS, platform.platform(),
                        frozenset({"dia", "bdia"}))


@pytest.fixture()
def as_gpu(monkeypatch):
    """Report the platform as ``gpu``: the routes then choose what they
    choose on the card, while the arithmetic still runs on the CPU."""
    from cask_tpu.utils import platform

    monkeypatch.setattr(platform, "platform", lambda: "gpu")
    monkeypatch.setattr(platform, "device_kind", lambda: "NVIDIA H100 80GB HBM3")
