"""chip_smoke.py: its phases at tiny sizes on the CPU, and its refusal to
report anything without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import chip_smoke as cs  # noqa: E402
from cask_tpu.formats.convert import bsr_to_csr  # noqa: E402
from cask_tpu.formats.generate import power_law, stencil_2d  # noqa: E402
from cask_tpu.parallel import fem_formula_bsr  # noqa: E402


def _ok(result):
    err, tol, _ = result
    assert err <= tol, result


MATS = {
    "banded_csr": lambda: stencil_2d(20),
    "fem_bsr": lambda: fem_formula_bsr(6, dof=4),
    "powerlaw_csr": lambda: power_law(500, avg_degree=12, seed=3),
}


@pytest.mark.parametrize("name", list(MATS))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_phase_spmv(name, dtype):
    _ok(cs.phase_spmv(MATS[name](), dtype))


@pytest.mark.parametrize("name", ["banded_csr", "fem_bsr"])
@pytest.mark.parametrize("k", [32, 128])
def test_phase_spmm(name, k):
    _ok(cs.phase_spmm(MATS[name](), k, np.float32))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_phase_kernel_vs_xla(dtype):
    _ok(cs.phase_kernel_vs_xla(8, dtype))


def test_phase_spgemm():
    _ok(cs.phase_spgemm(power_law(400, avg_degree=8, seed=4)))


def test_phase_tune(tmp_path):
    err, tol, note = cs.phase_tune(bsr_to_csr(fem_formula_bsr(6, dof=4)),
                                   tmp_path / "tuner.json")
    assert err <= tol and "cache_hit=True" in note


def test_phase_cg_matches_numpy_recurrence():
    _ok(cs.phase_cg(stencil_2d(24), iters=100))


def test_phase_amg():
    _ok(cs.phase_amg(stencil_2d(48)))


def test_phase_ilu():
    _ok(cs.phase_ilu(stencil_2d(16)))


def test_phase_dist_on_four_devices():
    from cask_tpu.parallel import DistSpmv, partition_dia, row_mesh

    a = stencil_2d(20)
    op = DistSpmv(partition_dia(a, 4), row_mesh(4))
    err, tol, note = cs.phase_dist(op, cs._scipy(a), np.float64, 4)
    assert err <= tol and note == "devices=4"


def test_rel_err():
    assert cs.rel_err([1.0, 2.0], [1.0, 2.0]) == 0.0
    assert abs(cs.rel_err([1.0, 0.0], [0.0, 1.0]) - np.sqrt(2)) < 1e-12


def _run(args, cwd=_REPO):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": _REPO}
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=900, cwd=cwd, env=env)


@pytest.mark.parametrize("chips", [[], ["--chips", "4"]])
def test_rehearsal_prints_ok_last(chips):
    out = _run(["chip_smoke.py", "--cpu", "--small", *chips])
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    last = json.loads(lines[-1])
    assert last == {"ok": True, "device": {"platform": "cpu", "kind": "cpu",
                                           "count": 8}}
    assert lines[-2].startswith("nvidia-smi: ")
    phases = [ln for ln in lines if ln.startswith("PHASE ")]
    assert phases and all(" ok=True " in ln for ln in phases)
    assert len(phases) == (6 if chips else 17)


def test_exits_nonzero_without_gpu():
    out = _run(["chip_smoke.py"])
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_exits_nonzero_alone(tmp_path):
    shutil.copy(os.path.join(_REPO, "chip_smoke.py"), tmp_path)
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path, env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
