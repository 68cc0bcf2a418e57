"""Train state: the step, the model (parameters and BatchNorm running
statistics) and the optimizer state (``m``, ``v``, ``count``).

Counterpart of ``tacotron_tpu/train/state.py``.  The step is a host
integer (the driver's own count, so reading it costs no device sync); the
optimizer's count is a device tensor of its own, so a warm start with fresh
optimizer state restarts the learning-rate warmup as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch

from ..models.tacotron import Tacotron
from ..params import init_random_
from ..text.symbols import vocab_size_for
from .optim import AdamState


@dataclass
class TrainState:
    step: int
    model: Tacotron
    opt: AdamState

    def parameters(self) -> List[torch.Tensor]:
        return list(self.model.parameters())


def create_model(config) -> Tacotron:
    """The model for ``config``; the embedding size follows the symbol
    set."""
    return Tacotron(config.model,
                    vocab_size=vocab_size_for(config.data.symbol_set))


def create_train_state(config, seed: int = 0,
                       device=None) -> TrainState:
    """Random weights from ``seed`` (``params.init_random_``: the same
    weights on every device), fresh optimizer state, step 0.  ``device``
    None means the card."""
    from ..synth.synthesizer import resolve_device
    device = resolve_device(device)
    model = init_random_(create_model(config), seed).to(device).train()
    return TrainState(step=0, model=model,
                      opt=AdamState.zeros(list(model.parameters())))
