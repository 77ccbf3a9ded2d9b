"""Persistent autotuner cache, keyed on sparsity signature.

cask analog: the DSE's selected-architecture output (SURVEY.md §3.2) —
there it parameterized a bitstream build; here it records the winning
kernel variant + parameters as JSON so later sessions (and restarted
multi-host jobs, §5 checkpoint/resume) skip both search and re-compile.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from pathlib import Path
from typing import Any, Dict, Optional

# $CASK_TPU_TUNER_CACHE, else a file in the checkout (listed in .gitignore)
_DEFAULT_PATH = os.environ.get(
    "CASK_TPU_TUNER_CACHE",
    str(Path(__file__).resolve().parents[2] / ".tuner_cache" / "tuner.json"))


class TunerCache:
    def __init__(self, path: Optional[str] = None):
        self.path = path or _DEFAULT_PATH
        self._lock = threading.Lock()
        self._mem: Dict[str, Any] = {}
        self._loaded = False

    def _load(self):
        if self._loaded:
            return
        self._loaded = True
        try:
            with open(self.path) as f:
                self._mem.update(json.load(f))
        except (OSError, ValueError):
            pass

    def get(self, key: str) -> Optional[dict]:
        with self._lock:
            self._load()
            return self._mem.get(key)

    def put(self, key: str, value: dict) -> None:
        with self._lock:
            self._load()
            self._mem[key] = value
            d = os.path.dirname(self.path)
            try:
                if d:
                    os.makedirs(d, exist_ok=True)
                fd, tmp = tempfile.mkstemp(dir=d or ".", suffix=".tmp")
                with os.fdopen(fd, "w") as f:
                    json.dump(self._mem, f, indent=1, sort_keys=True)
                os.replace(tmp, self.path)
            except OSError:
                pass  # cache is best-effort; in-memory copy still works


_global_cache: Optional[TunerCache] = None


def default_cache() -> TunerCache:
    global _global_cache
    if _global_cache is None:
        _global_cache = TunerCache()
    return _global_cache
