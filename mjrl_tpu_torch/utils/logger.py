"""DataLog: append-only metric store with CSV + JSONL persistence.

Twin of ``mjrl_tpu/utils/logger.py``: ``log_kv``, ``log_dict``,
``save_log`` writing a union-of-keys ``log.csv`` beside an append-only
``log.jsonl``, ``read_log`` and ``shrink_to`` for resume. The two packages'
logs have the same columns, so ``tools/compare_curves.py`` reads both.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Any, Dict, List, Optional


class DataLog:
    def __init__(self, log_dir: Optional[str] = None):
        self.log: Dict[str, List[Any]] = {}
        self.max_len = 0
        self.log_dir = log_dir
        self._jsonl = None
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "log.jsonl"), "a")

    def log_kv(self, key: str, value: Any) -> None:
        self.log.setdefault(key, []).append(_to_python(value))
        self.max_len = max(self.max_len, len(self.log[key]))

    def log_dict(self, metrics: Dict[str, Any]) -> None:
        row = {k: _to_python(v) for k, v in metrics.items()}
        for k, v in row.items():
            self.log_kv(k, v)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(row) + "\n")
            self._jsonl.flush()

    def save_log(self, save_path: Optional[str] = None) -> None:
        """Write ``log.csv`` with a union-of-keys header; a series shorter
        than the longest is aligned to the end (leading blanks)."""
        path = save_path or self.log_dir
        if path is None:
            raise ValueError("no log dir configured")
        os.makedirs(path, exist_ok=True)
        keys = sorted(self.log)
        with open(os.path.join(path, "log.csv"), "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=keys)
            writer.writeheader()
            for i in range(self.max_len):
                row = {}
                for k in keys:
                    series = self.log[k]
                    j = i - (self.max_len - len(series))
                    if j >= 0:
                        row[k] = series[j]
                writer.writerow(row)

    def read_log(self, log_path: str) -> None:
        """Load a saved ``log.csv``."""
        self.log = {}
        with open(log_path, newline="") as f:
            for row in csv.DictReader(f):
                for k, v in row.items():
                    self.log.setdefault(k, [])
                    if v not in (None, ""):
                        try:
                            v = float(v)
                        except ValueError:
                            pass
                        self.log[k].append(v)
        self.max_len = max((len(v) for v in self.log.values()), default=0)

    def shrink_to(self, n: int) -> None:
        """Truncate every series to its first n entries (resume)."""
        for k in self.log:
            self.log[k] = self.log[k][:n]
        self.max_len = min(self.max_len, n)

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None


def _to_python(v: Any) -> Any:
    """Tensor and numpy scalars -> python numbers."""
    return v.item() if hasattr(v, "item") else v
