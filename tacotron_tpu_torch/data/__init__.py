"""Training input pipeline: the bucketed corpus feeder and its
device-resident variant."""

from .feeder import CorpusFormatError, DataFeeder, Example, scan_data_dirs

__all__ = ["CorpusFormatError", "DataFeeder", "Example", "scan_data_dirs"]
