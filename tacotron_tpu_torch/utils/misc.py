"""Misc helpers: moving-average window, run-dir naming, git provenance.
A copy of the parts of the JAX package's ``utils/misc.py`` that training
uses."""

from __future__ import annotations

import os
import subprocess
from datetime import datetime
from typing import List, Optional, Sequence


class ValueWindow:
    """Moving average over the last ``window_size`` values."""

    def __init__(self, window_size: int = 100):
        self._window_size = window_size
        self._values: List[float] = []

    def append(self, x: float) -> None:
        self._values = self._values[-(self._window_size - 1):] + [float(x)]

    @property
    def sum(self) -> float:
        return sum(self._values)

    @property
    def count(self) -> int:
        return len(self._values)

    @property
    def average(self) -> float:
        return self.sum / max(1, self.count)

    def reset(self) -> None:
        self._values = []


def prepare_dirs(log_root: str, data_paths: Sequence[str],
                 run_prefix: Optional[str] = None) -> str:
    """Create and return ``{log_root}/{datasets}_{timestamp}``."""
    names = "+".join(
        os.path.basename(os.path.dirname(os.path.join(p, "")))
        or os.path.basename(p) for p in data_paths) or "run"
    if run_prefix:
        names = f"{run_prefix}_{names}"
    stamp = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    run_dir = os.path.join(log_root, f"{names}_{stamp}")
    os.makedirs(run_dir, exist_ok=True)
    return run_dir


def get_git_revision_hash() -> str:
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "HEAD"],
            stderr=subprocess.DEVNULL).decode().strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def get_git_diff() -> str:
    try:
        return subprocess.check_output(
            ["git", "diff"], stderr=subprocess.DEVNULL).decode()
    except (OSError, subprocess.CalledProcessError):
        return ""
