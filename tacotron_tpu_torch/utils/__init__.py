"""Training utilities: logging, metrics (JSONL and TensorBoard events),
moving averages, run-dir naming and git provenance."""

from .infolog import init as init_log, log
from .metrics import MetricsLogger, read_metrics
from .misc import (ValueWindow, get_git_diff, get_git_revision_hash,
                   prepare_dirs)
from .tb_events import TBEventWriter, read_tb_scalars

__all__ = [
    "MetricsLogger", "TBEventWriter", "ValueWindow", "get_git_diff",
    "get_git_revision_hash", "init_log", "log", "prepare_dirs",
    "read_metrics", "read_tb_scalars",
]
