"""Checkpoint/resume for expensive preprocessing (SURVEY.md §5).

cask had none (offline single-FPGA jobs); this framework's restart
story is: the tuner cache persists tuned variants (cask_tpu.tune.cache),
and this module persists *factorizations and plans* (ILU(0), level
schedules, partitions) as .npz so multi-host jobs resume without
re-running host preprocessing.
"""

from __future__ import annotations

import json
from typing import Tuple

import numpy as np

from cask_tpu.formats.matrix import CSR


def save_csr(path: str, a: CSR, **extra_meta) -> None:
    np.savez_compressed(
        path,
        data=np.asarray(a.data),
        indices=np.asarray(a.indices),
        indptr=np.asarray(a.indptr),
        meta=json.dumps({"shape": list(a.shape), **extra_meta}),
    )


def load_csr(path: str) -> Tuple[CSR, dict]:
    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    a = CSR(
        data=z["data"],
        indices=z["indices"],
        indptr=z["indptr"],
        shape=tuple(meta.pop("shape")),
    )
    return a, meta


def save_ilu0(path: str, factors) -> None:
    """Persist an ILU(0) factorization (pattern + values)."""
    save_csr(path, factors.lu, kind="ilu0")


def load_ilu0(path: str):
    """Rebuild :class:`~cask_tpu.ops.ilu.ILU0Factors` from disk: values
    load directly, solve plans recompute from the pattern (fast, native)."""
    from cask_tpu.ops.ilu import ILU0Factors, _split_lu
    from cask_tpu.ops.trisolve import trisolve_plan

    lu, meta = load_csr(path)
    if meta.get("kind") != "ilu0":
        raise ValueError(f"{path} is not an ilu0 checkpoint")
    low, up = _split_lu(lu)
    return ILU0Factors(
        lu=lu,
        _lower_plan=trisolve_plan(low, lower=True, unit_diag=True),
        _upper_plan=trisolve_plan(up, lower=False, unit_diag=False),
        _lower_data=np.asarray(low.data),
        _upper_data=np.asarray(up.data),
    )


def save_dia(path: str, dia) -> None:
    np.savez_compressed(
        path,
        vals=np.asarray(dia.vals),
        rem_data=np.asarray(dia.rem_data),
        rem_row=np.asarray(dia.rem_row),
        rem_col=np.asarray(dia.rem_col),
        meta=json.dumps({
            "shape": list(dia.shape), "offsets": list(dia.offsets), "kind": "dia",
        }),
    )


def load_dia(path: str):
    from cask_tpu.ops.dia import DiaMatrix

    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    if meta.get("kind") != "dia":
        raise ValueError(f"{path} is not a dia checkpoint")
    import jax.numpy as jnp

    vals = jnp.asarray(z["vals"])
    return DiaMatrix(
        vals=vals,
        rem_data=jnp.asarray(z["rem_data"]),
        rem_row=jnp.asarray(z["rem_row"]),
        rem_col=jnp.asarray(z["rem_col"]),
        offsets=tuple(meta["offsets"]),
        shape=tuple(meta["shape"]),
    )
