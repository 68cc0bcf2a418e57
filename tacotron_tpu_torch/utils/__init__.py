"""Training utilities: logging, metrics (JSONL and TensorBoard events),
moving averages, run-dir naming, a parallel map, boolean flags and git
provenance."""

from .infolog import init as init_log, log
from .metrics import MetricsLogger, read_metrics
from .misc import (ValueWindow, card_line, device_line, get_git_diff,
                   get_git_revision_hash, parallel_run, prepare_dirs,
                   str2bool)
from .tb_events import TBEventWriter, read_tb_scalars

__all__ = [
    "MetricsLogger", "TBEventWriter", "ValueWindow", "card_line",
    "device_line", "get_git_diff",
    "get_git_revision_hash", "init_log", "log", "parallel_run",
    "prepare_dirs", "read_metrics", "read_tb_scalars", "str2bool",
]
