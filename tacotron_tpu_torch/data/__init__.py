"""Data layer: the offline ``.npz`` corpus builder, the bucketed corpus
feeder and its device-resident variant."""

from .builder import (BuildStats, build_from_path, process_utterance,
                      read_metadata, resolve_loss_coeffs)
from .feeder import CorpusFormatError, DataFeeder, Example, scan_data_dirs

__all__ = [
    "BuildStats", "CorpusFormatError", "DataFeeder", "Example",
    "build_from_path", "process_utterance", "read_metadata",
    "resolve_loss_coeffs", "scan_data_dirs",
]
