"""Kernel timing for the autotuner and benches: the host clock around
calls that end in ``block_until_ready``.

``fn`` is jitted once; every argument is traced, so matrices passed as
arguments are device buffers and not compile-time constants.  After
warm-up calls (compilation included), ``iters`` calls are timed one by
one and the median is reported.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Tuple

import jax
import jax.numpy as jnp


@dataclasses.dataclass
class Measurement:
    seconds_per_iter: float  # median over the timed calls
    samples: Tuple[float, ...]
    checksum: float  # finite iff the output was finite

    @property
    def spread(self) -> float:
        """Interquartile range of the samples over their median."""
        if len(self.samples) < 4:
            return 0.0
        q = statistics.quantiles(self.samples, n=4)
        return (q[2] - q[0]) / self.seconds_per_iter


def measure(fn: Callable, *args, iters: int = 20, warmup: int = 2) -> Measurement:
    """Seconds per call of ``fn(*args)`` on the device ``args`` live on."""
    f = jax.jit(fn)
    for _ in range(max(warmup, 1)):
        y = jax.block_until_ready(f(*args))
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        samples.append(time.perf_counter() - t0)
    leaf = jax.tree.leaves(y)[0]
    checksum = float(jnp.sum(jnp.abs(leaf)).astype(jnp.float32))
    return Measurement(seconds_per_iter=statistics.median(samples),
                       samples=tuple(samples), checksum=checksum)
