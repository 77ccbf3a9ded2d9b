"""bench.py: one record per cell naming the device, a compact summary as
the last line, and no run at all without a GPU unless --cpu says so."""

import json
import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": _REPO}
    return subprocess.run([sys.executable, os.path.join(_REPO, "bench.py"), *args],
                          capture_output=True, text=True, timeout=900, env=env)


def _load_bench():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "bench_mod", os.path.join(_REPO, "bench.py"))
    bench_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench_mod)
    return bench_mod


def test_cpu_rehearsal_emits_records():
    out = _run(["--cpu", "--small"])
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [ln for ln in out.stdout.strip().splitlines() if ln.startswith("{")]
    last = json.loads(lines[-1])
    assert len(lines[-1]) < 1900
    assert last["metric"] == "bdia_spmv_frac_of_copy" and last["value"] > 0
    assert last["device"]["platform"] == "cpu" and last["device"]["count"] == 8
    cells = [json.loads(ln) for ln in lines if '"bytes_per_call"' in ln]
    assert {"dia_stencil_f32", "bdia_fem_f64", "csr_powerlaw_f32"} <= {
        c["cell"] for c in cells}
    for c in cells:
        assert c["platform"] == "cpu" and c["device_count"] == 8
        assert "card" in c and "roofline_frac" not in c


def test_refuses_without_gpu():
    # no accelerator and no --cpu: the bench refuses to measure anything
    out = _run([])
    assert out.returncode != 0
    assert "needs a gpu device" in out.stderr
    assert not out.stdout.strip()


def test_compact_record_stays_short():
    bench_mod = _load_bench()
    record = {
        "metric": "bdia_spmv_frac_of_copy", "value": 0.9, "unit": "ratio",
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1, "card": "NVIDIA H100 80GB HBM3, 700.00 W"},
        "cells_us": {f"cell_with_a_long_name_{i:03d}": 123.456789 for i in range(60)},
        "wall_s": 60.0,
    }
    assert len(json.dumps(record)) > 2000
    line = bench_mod.compact_record(record)
    assert len(line) < 1900
    rec = json.loads(line)
    assert rec["value"] == 0.9 and rec["device"]["count"] == 1
    assert "cells_us" not in rec
    small = dict(record, cells_us={"a": 1.0})
    assert json.loads(bench_mod.compact_record(small))["cells_us"] == {"a": 1.0}
