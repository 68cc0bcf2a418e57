"""Tacotron and Deep Voice 2 (arXiv:1703.10135, arXiv:1705.08947): the
model family of every configuration file that names none.

A model family is what the offline path asks of the model a cell runs
(``core.family``); a second architecture is a second file beside this one
and a ``family`` key in its configuration file.  This one hands over the
benchmark's own pieces unchanged: the variables of ``reference/weights.py``,
the graph of ``reference/tacotron.py``, ``check.decode_budget`` over
``check.STEP_LADDER`` at r frames a step, and ``flops.forward_flops``.
``check.train_numbers`` follows this family's training step.
"""

from perfbench import flops
from perfbench.check import decode_budget
from perfbench.reference.tacotron import Reference
from perfbench.reference.weights import make_variables

__all__ = ["TRAIN_REFERENCE", "decode_budget", "forward_flops",
           "frames_per_step", "make_variables", "reference"]

#: ``check.train_numbers`` holds this family's training step
TRAIN_REFERENCE = True


def reference(variables, model: dict, precision: str) -> Reference:
    """The plain graph over ``variables`` at ``precision`` (``float32`` or
    ``tf32``); its ``infer`` gives ``alignments`` and ``linear_outputs``."""
    return Reference(variables, model, precision)


def frames_per_step(model: dict) -> int:
    return model["reduction_factor"]


def forward_flops(model: dict, batch: int, t_in: int, t_out: int) -> float:
    """Matrix-product FLOPs of one forward over ``t_in`` tokens and
    ``t_out`` frames."""
    return flops.forward_flops(model, batch, t_in, t_out)["total"]
