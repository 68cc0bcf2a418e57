"""Misc helpers: moving-average window, run-dir naming, parallel map,
boolean flags, git provenance: a copy of the JAX package's
``utils/misc.py``; and the card's name and power limit (:func:`card_line`,
:func:`device_line`), which the port writes beside every number it
measures on a card."""

from __future__ import annotations

import os
import subprocess
from datetime import datetime
from multiprocessing import Pool, cpu_count
from typing import Any, Callable, Iterable, List, Optional, Sequence


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


def parallel_run(fn: Callable, items: Iterable[Any],
                 parallel: bool = True,
                 workers: Optional[int] = None) -> List[Any]:
    """``[fn(x) for x in items]``, over a process pool of ``workers``
    (default: the CPU count, at most 8) when ``parallel`` and there are
    two items or more; ``fn`` must be picklable."""
    items = list(items)
    if not parallel or len(items) < 2:
        return [fn(x) for x in items]
    with Pool(workers or min(cpu_count(), 8)) as pool:
        return pool.map(fn, items)


def str2bool(v) -> bool:
    """``argparse`` type of a boolean flag: yes/true/t/1 or no/false/f/0,
    any case; a bool passes through."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "1"):
        return True
    if v.lower() in ("no", "false", "f", "0"):
        return False
    raise ValueError(f"boolean value expected, got {v!r}")


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


def card_line(index: int = 0) -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (e.g.
    ``NVIDIA H100 80GB HBM3, 700.00 W``), for card ``index``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout
    return out.strip().splitlines()[index]


def device_line(device) -> str:
    """The device a study reports: :func:`card_line` of the card for a CUDA
    device, else the device's name (``cpu``)."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return str(device)
    return card_line(device.index if device.index is not None
                     else torch.cuda.current_device())
