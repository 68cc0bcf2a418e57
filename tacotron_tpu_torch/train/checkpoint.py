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

Saves are asynchronous by default, as JAX's orbax manager's
(``async_save=True``): :meth:`CheckpointManager.save` blocks only until the
parameters, BatchNorm statistics and Adam moments are copies on the host
(a device-to-host copy from the card; a clone on the CPU, where ``cpu()``
would return the live storage that the next step updates in place), and
one background thread writes the files.  :meth:`~CheckpointManager.wait`
blocks until every pending write is durable; ``steps``, ``latest_step``,
``restore`` and ``close`` wait first.  A write that failed on the thread
raises from the next ``save``, ``wait`` or ``close``.  ``async_save=False``
writes inside ``save``, the same files as before the thread existed.
"""

from __future__ import annotations

import os
import shutil
from concurrent.futures import ThreadPoolExecutor, wait as wait_futures
from typing import Dict, List, Optional

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
                 max_to_keep: Optional[int] = None,
                 async_save: bool = True):
        self.run_dir = os.path.abspath(run_dir)
        self.ckpt_dir = os.path.join(self.run_dir, "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        cfg_path = os.path.join(self.run_dir, CONFIG_FILENAME)
        if not os.path.exists(cfg_path):
            save_config(config, cfg_path)
        self.max_to_keep = max_to_keep or config.train.max_checkpoints_to_keep
        self.async_save = async_save
        self._writer: Optional[ThreadPoolExecutor] = None
        self._pending: list = []

    def steps(self) -> List[int]:
        """The steps of the complete checkpoints, ascending (after the
        pending writes)."""
        self.wait()
        return checkpoint_steps(self.run_dir)

    @property
    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, str(step))

    def save(self, state: TrainState) -> str:
        """Save ``state`` at ``checkpoints/<state.step>`` (replacing one of
        the same step) and drop the oldest beyond ``max_to_keep``; returns
        that path.  With ``async_save`` it returns once the state is copied
        to the host, and the files are written on the manager's thread."""
        self._raise_failed()
        names = [n for n, _ in state.model.named_parameters()]
        copy = self.async_save
        snapshot = dict(
            step=int(state.step),
            variables={k: _host(t, copy)
                       for k, t in state.model.state_dict().items()},
            optimizer={
                "step": int(state.step),
                "count": int(state.opt.count),
                "m": {n: _host(t, copy) for n, t in zip(names, state.opt.m)},
                "v": {n: _host(t, copy) for n, t in zip(names, state.opt.v)},
            })
        if not copy:
            return self._write(**snapshot)
        if self._writer is None:
            self._writer = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="checkpoint-writer")
        self._pending.append(self._writer.submit(self._write, **snapshot))
        return self.path(snapshot["step"])

    def _write(self, step: int, variables: Dict[str, torch.Tensor],
               optimizer: dict) -> str:
        """Write one host snapshot: into a temporary directory, renamed
        into place, an old checkpoint of the same step moved aside first
        and deleted after; then prune to ``max_to_keep``."""
        final = self.path(step)
        tmp = os.path.join(self.ckpt_dir, f".tmp-{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        save_npz(os.path.join(tmp, VARIABLES), variables)
        torch.save(optimizer, os.path.join(tmp, OPTIMIZER))
        aside = None
        if os.path.exists(final):
            aside = os.path.join(self.ckpt_dir, f".old-{step}")
            shutil.rmtree(aside, ignore_errors=True)
            os.replace(final, aside)
        os.replace(tmp, final)
        if aside is not None:
            shutil.rmtree(aside)
        for old in checkpoint_steps(self.run_dir)[:-self.max_to_keep]:
            shutil.rmtree(self.path(old), ignore_errors=True)
        return final

    def _raise_failed(self) -> None:
        """Raise the error of a finished write that failed (once)."""
        done = [f for f in self._pending if f.done()]
        self._pending = [f for f in self._pending if not f.done()]
        for f in done:
            f.result()

    def wait(self) -> None:
        """Block until every pending write is durable on disk; raise the
        first error a write met."""
        pending, self._pending = self._pending, []
        wait_futures(pending)
        for f in pending:
            f.result()

    def close(self) -> None:
        """Wait for the pending writes and stop the writer thread (a later
        ``save`` starts a new one)."""
        try:
            self.wait()
        finally:
            if self._writer is not None:
                self._writer.shutdown(wait=True)
                self._writer = None

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Resume mode: weights, BatchNorm statistics, optimizer state and
        step from the checkpoint at ``step`` (default the latest), into
        ``state``'s model on its device."""
        self.wait()
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


def _host(t: torch.Tensor, copy: bool) -> torch.Tensor:
    """``t`` on the host: a copy of its own when ``copy`` (a card tensor's
    device-to-host copy, which has finished when this returns; a CPU
    tensor's clone), else ``cpu()`` (the live storage on the CPU)."""
    t = t.detach()
    return t.to("cpu", copy=True) if copy else t.cpu()


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
