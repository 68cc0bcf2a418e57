"""Checkpoints of a run directory: counterpart of
``tacotron_tpu/train/checkpoint.py`` without orbax.

A run directory holds ``config.json`` and ``checkpoints/<step>/``, each
with

- ``variables.npz``: parameters and BatchNorm statistics as the flat
  ``/``-joined flax-path npz of ``params.save_npz`` (what ``--load_npz`` and
  ``Synthesizer.load`` read);
- ``optimizer.pt``: the Adam moments keyed by parameter name, ``count`` and
  ``step`` (``torch.save`` of tensors and ints; loaded with
  ``weights_only=True``).

A checkpoint is written into a temporary directory and renamed into place,
so a crash mid-write leaves no partial checkpoint; one that replaces a
checkpoint of the same step first moves the old one aside, and deletes it
only once the new one is in place.  The newest
``max_checkpoints_to_keep`` are kept.  Two restore modes, as in JAX:
**resume** brings everything back, step included; **warm start** takes the
weights and BatchNorm statistics only, with step 0 and fresh optimizer
state (the caller's optimizer then uses the long fine-tune warmup).
"""

from __future__ import annotations

import os
import shutil
from typing import List, Optional

import torch

from ..config import Config, load_config, save_config
from ..params import from_flax, load_npz, save_npz
from .optim import AdamState
from .state import TrainState

CONFIG_FILENAME = "config.json"
VARIABLES = "variables.npz"
OPTIMIZER = "optimizer.pt"


class CheckpointManager:
    """Saves and restores the :class:`TrainState` of one run directory."""

    def __init__(self, run_dir: str, config: Config,
                 max_to_keep: Optional[int] = None):
        self.run_dir = os.path.abspath(run_dir)
        self.ckpt_dir = os.path.join(self.run_dir, "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        cfg_path = os.path.join(self.run_dir, CONFIG_FILENAME)
        if not os.path.exists(cfg_path):
            save_config(config, cfg_path)
        self.max_to_keep = max_to_keep or config.train.max_checkpoints_to_keep

    def steps(self) -> List[int]:
        """The steps of the complete checkpoints, ascending."""
        return checkpoint_steps(self.run_dir)

    @property
    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, str(step))

    def save(self, state: TrainState) -> str:
        """Write ``state`` at ``checkpoints/<state.step>`` (replacing one of
        the same step) and drop the oldest beyond ``max_to_keep``."""
        final = self.path(state.step)
        tmp = os.path.join(self.ckpt_dir, f".tmp-{state.step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        save_npz(os.path.join(tmp, VARIABLES), state.model.state_dict())
        names = [n for n, _ in state.model.named_parameters()]
        torch.save({
            "step": int(state.step),
            "count": int(state.opt.count),
            "m": {n: t.detach().cpu() for n, t in zip(names, state.opt.m)},
            "v": {n: t.detach().cpu() for n, t in zip(names, state.opt.v)},
        }, os.path.join(tmp, OPTIMIZER))
        aside = None
        if os.path.exists(final):
            aside = os.path.join(self.ckpt_dir, f".old-{state.step}")
            shutil.rmtree(aside, ignore_errors=True)
            os.replace(final, aside)
        os.replace(tmp, final)
        if aside is not None:
            shutil.rmtree(aside)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(self.path(old), ignore_errors=True)
        return final

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Resume mode: weights, BatchNorm statistics, optimizer state and
        step from the checkpoint at ``step`` (default the latest), into
        ``state``'s model on its device."""
        step = self.latest_step if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.run_dir}")
        path = self.path(step)
        load_weights(state.model, os.path.join(path, VARIABLES))
        dev = next(state.model.parameters()).device
        saved = torch.load(os.path.join(path, OPTIMIZER), map_location=dev,
                           weights_only=True)
        names = [n for n, _ in state.model.named_parameters()]
        state.opt = AdamState(
            m=[saved["m"][n].to(dev) for n in names],
            v=[saved["v"][n].to(dev) for n in names],
            count=torch.tensor(saved["count"], dtype=torch.int32,
                               device=dev))
        state.step = int(saved["step"])
        return state


def checkpoint_steps(run_dir: str) -> List[int]:
    """The steps of ``run_dir``'s complete checkpoints, ascending (an
    unfinished write has a name that is not a number)."""
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(name) for name in os.listdir(ckpt_dir)
                  if name.isdigit())


def checkpoint_path(run_dir: str, step: Optional[int] = None) -> str:
    """The ``variables.npz`` of ``run_dir``'s checkpoint at ``step``
    (default the newest)."""
    steps = checkpoint_steps(run_dir)
    if step is None and steps:
        step = steps[-1]
    if step is None or step not in steps:
        raise FileNotFoundError(
            f"no checkpoint {'' if step is None else step} in {run_dir}")
    return os.path.join(run_dir, "checkpoints", str(step), VARIABLES)


def load_weights(model: torch.nn.Module, npz_path: str) -> None:
    """Parameters and BatchNorm statistics from a flat flax-path npz into
    ``model`` (on its device); every key must match."""
    model.load_state_dict(from_flax(load_npz(npz_path)))


def load_run_config(run_dir: str) -> Config:
    """The config a run was trained with."""
    return load_config(os.path.join(run_dir, CONFIG_FILENAME))


def warm_start(state: TrainState, source_run_dir: str) -> TrainState:
    """Initialize mode: the weights and BatchNorm statistics of
    ``source_run_dir``'s newest checkpoint, step 0, fresh optimizer state."""
    load_weights(state.model, checkpoint_path(source_run_dir))
    state.opt = AdamState.zeros(state.parameters())
    state.step = 0
    return state
