"""Persisted scalar training metrics: ``metrics.jsonl`` in the run dir.

A copy of the JAX package's ``utils/metrics.py``: one JSON object per line
(step, kind, wall time and the scalars), mirrored as TensorBoard events when
``tb_logdir`` is given.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional


class MetricsLogger:
    """Append-only JSONL scalar log.  One ``write()`` per interval; with
    ``tb_logdir`` the same scalars also go to TensorBoard events (tags
    ``<kind>/<key>``, ``utils/tb_events.py``)."""

    def __init__(self, path: str, tb_logdir: Optional[str] = None):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._file = open(path, "a", encoding="utf-8")
        self._tb = None
        if tb_logdir is not None:
            from .tb_events import TBEventWriter
            self._tb = TBEventWriter(tb_logdir)

    def write(self, step: int, scalars: Dict[str, float],
              kind: str = "train") -> None:
        now = time.time()
        record = {"step": int(step), "kind": kind, "wall_time": now}
        for key, value in scalars.items():
            try:
                record[key] = float(value)
            except (TypeError, ValueError):
                record[key] = value
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()
        if self._tb is not None:
            self._tb.scalars(step, {f"{kind}/{k}": v
                                    for k, v in scalars.items()},
                             wall_time=now)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_metrics(path: str, kind: Optional[str] = None) -> List[dict]:
    """Load a metrics.jsonl; optionally only the records of one kind
    ("train"/"eval")."""
    records = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if kind is None or rec.get("kind") == kind:
                records.append(rec)
    return records
