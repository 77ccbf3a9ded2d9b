"""Tracing/profiling helpers (SURVEY.md §5).

cask analog: Maxeler build reports + perf-model cycle counts.  Here:
``jax.profiler`` traces viewable in XProf/Perfetto (kernel times, device
busy/idle), plus the timing harness in :mod:`cask_tpu.tune.timing` for
host-clock wall numbers.
"""

from __future__ import annotations

import contextlib
import os
from pathlib import Path
from typing import Optional


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Profile a block: ``with trace('/tmp/tb'): y = op(x).block_until_ready()``.

    View with xprof/tensorboard, or read with
    ``jax.profiler.ProfileData.from_file``.  The default directory is
    ``$CASK_TPU_TRACE_DIR``, else ``chiprun_out/trace`` in the checkout.
    """
    import jax

    logdir = logdir or os.environ.get(
        "CASK_TPU_TRACE_DIR",
        str(Path(__file__).resolve().parents[2] / "chiprun_out" / "trace"))
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named-scope annotation for profile timelines."""
    import jax

    return jax.profiler.TraceAnnotation(name)


def device_kernels(trace_dir: str) -> Optional[dict]:
    """Reduce the newest trace under ``trace_dir`` to device metrics.

    Reads the GPU device planes' stream lines (the kernels as they ran)
    and returns ``{"busy_ns", "window_ns", "kernels": {name: total_ns}}``:
    ``busy_ns`` is the union of the kernel intervals, ``window_ns`` the
    span from the first kernel start to the last kernel end, and each
    kernel name's summed duration.  ``None`` when the trace holds no
    device plane (a CPU run)."""
    import glob

    from jax.profiler import ProfileData

    files = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not files:
        return None
    return reduce_device_planes(ProfileData.from_file(files[-1]))


def reduce_device_planes(profile) -> Optional[dict]:
    """:func:`device_kernels` on an already-loaded ``ProfileData``."""
    spans, kernels = [], {}
    for plane in profile.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                kernels[ev.name] = kernels.get(ev.name, 0.0) + ev.duration_ns
    if not spans:
        return None
    spans.sort()
    busy, (cur_lo, cur_hi) = 0.0, spans[0]
    for lo, hi in spans[1:]:
        if lo > cur_hi:
            busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    busy += cur_hi - cur_lo
    window = max(hi for _, hi in spans) - spans[0][0]
    return {"busy_ns": busy, "window_ns": window, "kernels": kernels}
