"""The platform this process runs on, and the routes it takes there.

Every operation in the library has a plain-JAX formulation that XLA
compiles for whatever device JAX was given.  What depends on the
platform is which one runs: whether the ``method='auto'`` routes repack
a banded CSR matrix into a DIA plan and a BSR matrix into a BDIA plan
(:data:`AUTO_PLANS`), and whether a plan's SpMV runs the hand-written
banded kernel (:data:`KERNELS`).  Both tables hold what was measured on
each platform (PERF.md).

Nothing here falls back to another platform.  JAX raises at start-up
when it was asked for a GPU and finds none, and :func:`require` raises
when a caller that needs an accelerator finds itself on another one.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

import jax

# platform -> the plans the auto routes build there ("dia": banded CSR
# through a DIA plan; "bdia": BSR through a BDIA plan).  A platform not
# listed builds none.
AUTO_PLANS = {
    "gpu": frozenset({"dia", "bdia"}),
}

# platform -> the plans whose SpMV runs the hand-written banded kernel
# (ops/banded_kernel.py) instead of their XLA formulation.  On the GPU
# the BDIA kernel beats XLA's fusion end to end; the DIA fusion already
# streams at the copy rate, so DIA keeps it.
KERNELS = {
    "gpu": frozenset({"bdia"}),
}

# the checkout's own compile cache, used when JAX_COMPILATION_CACHE_DIR
# is unset (a fixed path: the path is part of the cache's key)
CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def platform() -> str:
    """Platform of the default device (``'gpu'``, ``'cpu'``, ...)."""
    return jax.default_backend()


def device_kind() -> str:
    """``device_kind`` of the default device, as JAX reports it."""
    return jax.devices()[0].device_kind


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them
    (one line per card), or ``"not available"`` without nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return "not available"
    return "; ".join(ln.strip() for ln in out.stdout.splitlines() if ln.strip())


def auto_plan(plan: str) -> bool:
    """Whether ``method='auto'`` repacks into ``plan`` on this platform."""
    return plan in AUTO_PLANS.get(platform(), frozenset())


def kernel(plan: str) -> bool:
    """Whether ``plan``'s SpMV runs the banded kernel on this platform."""
    return plan in KERNELS.get(platform(), frozenset())


def require(name: str = "gpu"):
    """The devices of platform ``name``; raises if JAX has another."""
    devices = jax.devices()
    if devices[0].platform != name:
        raise RuntimeError(
            f"needs a {name} device, but JAX runs on "
            f"{devices[0].platform} ({devices[0].device_kind})")
    return devices


def setup_compile_cache() -> str:
    """Point JAX's persistent compile cache at one fixed directory.

    ``JAX_COMPILATION_CACHE_DIR``, where set, wins and nothing is
    changed; otherwise the cache is the checkout's ``.jax_cache/``.
    Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)


def start(argv=()) -> None:
    """Set-up for scripts and examples: ``--cpu`` in ``argv`` runs the
    process on the CPU with 8 virtual devices (for rehearsals); without
    it JAX keeps the platform it was given.  Either way the compile
    cache goes where :func:`setup_compile_cache` says.  Call before the
    first computation."""
    if "--cpu" in argv:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=8")
        jax.config.update("jax_platforms", "cpu")
    setup_compile_cache()
