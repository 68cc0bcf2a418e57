"""Interchange with the reference's TF1 checkpoint format (a copy of the
JAX package's numpy-only ``compat/``, with its own CLI)."""

from .bundle import read_checkpoint, write_checkpoint
from .names import export_tf1, import_tf1, tf1_rules, tf1_variable_inventory
from .tf1 import (export_tf1_checkpoint, import_report,
                  import_tf1_checkpoint, map_tf1_variables)

__all__ = ["export_tf1", "export_tf1_checkpoint", "import_report",
           "import_tf1", "import_tf1_checkpoint", "map_tf1_variables",
           "read_checkpoint", "tf1_rules", "tf1_variable_inventory",
           "write_checkpoint"]
