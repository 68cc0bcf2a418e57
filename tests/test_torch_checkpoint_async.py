"""Asynchronous checkpoint saves of the port (``train/checkpoint.py``), the
contract of the JAX package's orbax manager (``async_save=True``), on the
CPU at small widths.

- ``save`` returns before the write is durable: the write is held on the
  writer thread, ``save`` has returned, and no checkpoint exists until the
  write is released; ``wait`` then finds it in place.
- A checkpoint equals the state at its step although the parameters,
  BatchNorm statistics and Adam moments are updated in place right after
  ``save`` returns (the host copy is a clone: ``cpu()`` of a CPU tensor is
  the live storage).
- ``steps``, ``latest_step``, ``restore`` and ``close`` wait for a pending
  write.
- A write that fails on the thread raises from the next ``save``, ``wait``
  or ``close``.
- ``async_save=False`` writes the files the synchronous manager wrote
  (byte for byte against that code, kept here), and an asynchronous save
  the same bytes.
- The driver closes its manager on a normal end, on ``DivergenceError`` and
  on an interruption, and no write is pending after ``train`` returns or
  raises; a run resumed from an asynchronous checkpoint ends where an
  uninterrupted run ends (``tests/test_torch_train_driver.py``).
"""

import os
import threading

import numpy as np
import pytest
import torch

from tacotron_tpu_torch.config import Config, ModelConfig
from tacotron_tpu_torch.params import save_npz
from tacotron_tpu_torch.train import checkpoint as ckpt
from tacotron_tpu_torch.train.checkpoint import CheckpointManager
from tacotron_tpu_torch.train.driver import DivergenceError, train
from tacotron_tpu_torch.train.state import create_train_state
from test_torch_train_driver import SMALL, _config, corpus  # noqa: F401


def _cfg():
    return Config().replace(model=ModelConfig(
        model_type="deepvoice", num_speakers=2, **SMALL))


def _state(cfg, seed=0, step=3):
    state = create_train_state(cfg, seed=seed, device="cpu")
    state.step = step
    with torch.no_grad():   # non-zero moments and statistics
        for i, (m, v) in enumerate(zip(state.opt.m, state.opt.v)):
            m.fill_(0.01 * (i + 1))
            v.fill_(0.002 * (i + 1))
        for b in state.model.buffers():
            if b.is_floating_point():
                b.add_(0.5)
    state.opt.count.fill_(step)
    return state


def _snapshot(state):
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            [m.clone() for m in state.opt.m], [v.clone() for v in state.opt.v])


def _assert_state_equal(state, snap):
    sd, m, v = snap
    for k, t in state.model.state_dict().items():
        assert torch.equal(t, sd[k]), k
    for a, b in zip(state.opt.m + state.opt.v, m + v):
        assert torch.equal(a, b)


class _HeldWrites:
    """Holds the writer thread at ``torch.save`` until released."""

    def __init__(self, monkeypatch):
        self.entered, self.release = threading.Event(), threading.Event()
        save = torch.save

        def held(*args, **kwargs):
            self.entered.set()
            assert self.release.wait(60)
            return save(*args, **kwargs)

        monkeypatch.setattr(ckpt.torch, "save", held)


def test_save_returns_before_the_write_is_durable(tmp_path, monkeypatch):
    cfg = _cfg()
    held = _HeldWrites(monkeypatch)
    mgr = CheckpointManager(str(tmp_path), cfg)
    path = mgr.save(_state(cfg))
    assert path == mgr.path(3)
    assert held.entered.wait(60)
    assert not os.path.exists(path)
    assert ckpt.checkpoint_steps(str(tmp_path)) == []
    held.release.set()
    mgr.wait()
    assert sorted(os.listdir(path)) == ["optimizer.pt", "variables.npz"]
    assert ckpt.checkpoint_steps(str(tmp_path)) == [3]
    mgr.close()


def test_checkpoint_is_the_state_at_its_step(tmp_path, monkeypatch):
    """The state is updated in place after ``save`` returns, while its
    write is held: the checkpoint is still the state at its step."""
    cfg = _cfg()
    held = _HeldWrites(monkeypatch)
    mgr = CheckpointManager(str(tmp_path), cfg)
    state = _state(cfg)
    want = _snapshot(state)
    mgr.save(state)
    with torch.no_grad():
        for t in (state.parameters() + list(state.model.buffers())
                  + state.opt.m + state.opt.v):
            t.add_(1)
        state.opt.count.add_(1)
    state.step = 4
    assert held.entered.wait(60)
    held.release.set()
    fresh = create_train_state(cfg, seed=9, device="cpu")
    fresh = mgr.restore(fresh)
    assert fresh.step == 3 and int(fresh.opt.count) == 3
    _assert_state_equal(fresh, want)
    mgr.close()


@pytest.mark.parametrize("reader", ["steps", "latest_step", "restore",
                                    "close"])
def test_readers_wait_for_pending_writes(reader, tmp_path, monkeypatch):
    cfg = _cfg()
    held = _HeldWrites(monkeypatch)
    mgr = CheckpointManager(str(tmp_path), cfg)
    state = _state(cfg)
    want = _snapshot(state)
    mgr.save(state)
    assert held.entered.wait(60)
    result = {}

    def read():
        if reader == "restore":
            result["got"] = mgr.restore(create_train_state(cfg, seed=9,
                                                           device="cpu"))
        elif reader == "close":
            result["got"] = mgr.close()
        else:
            result["got"] = getattr(mgr, reader)
            if callable(result["got"]):
                result["got"] = result["got"]()
        result["steps_then"] = ckpt.checkpoint_steps(str(tmp_path))

    t = threading.Thread(target=read)
    t.start()
    t.join(0.5)
    assert t.is_alive(), f"{reader} returned with a write pending"
    held.release.set()
    t.join(60)
    assert not t.is_alive()
    assert result["steps_then"] == [3]
    if reader == "steps":
        assert result["got"] == [3]
    elif reader == "latest_step":
        assert result["got"] == 3
    elif reader == "restore":
        _assert_state_equal(result["got"], want)
    mgr.close()


@pytest.mark.parametrize("raiser", ["save", "wait", "close"])
def test_a_failed_write_raises(raiser, tmp_path, monkeypatch):
    cfg = _cfg()

    def broken(path, state_dict):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "save_npz", broken)
    mgr = CheckpointManager(str(tmp_path), cfg)
    mgr.save(_state(cfg))          # returns: the write fails on the thread
    assert isinstance(mgr._pending[0].exception(60), OSError)
    monkeypatch.setattr(ckpt, "save_npz", save_npz)
    with pytest.raises(OSError, match="disk full"):
        if raiser == "save":
            mgr.save(_state(cfg, step=4))
        else:
            getattr(mgr, raiser)()
    # raised once; the manager goes on
    mgr.save(_state(cfg, step=5))
    mgr.close()
    assert ckpt.checkpoint_steps(str(tmp_path)) == [5]
    assert not [n for n in os.listdir(mgr.ckpt_dir) if not n.isdigit()
                and not n.startswith(".tmp-")]


def _old_save(run_dir, state):
    """The synchronous manager's write, as it was."""
    final = os.path.join(run_dir, "checkpoints", str(state.step))
    os.makedirs(final)
    save_npz(os.path.join(final, ckpt.VARIABLES), state.model.state_dict())
    names = [n for n, _ in state.model.named_parameters()]
    torch.save({
        "step": int(state.step),
        "count": int(state.opt.count),
        "m": {n: t.detach().cpu() for n, t in zip(names, state.opt.m)},
        "v": {n: t.detach().cpu() for n, t in zip(names, state.opt.v)},
    }, os.path.join(final, ckpt.OPTIMIZER))
    return final


def test_sync_and_async_files_are_the_old_bytes(tmp_path):
    cfg = _cfg()
    state = _state(cfg)
    want = _old_save(str(tmp_path / "old"), state)
    for async_save in (False, True):
        mgr = CheckpointManager(str(tmp_path / str(async_save)), cfg,
                                async_save=async_save)
        got = mgr.save(state)
        if not async_save:   # written inside save
            assert sorted(os.listdir(got)) == sorted(os.listdir(want))
        mgr.close()
        for name in (ckpt.VARIABLES, ckpt.OPTIMIZER):
            with open(os.path.join(got, name), "rb") as a, \
                    open(os.path.join(want, name), "rb") as b:
                assert a.read() == b.read(), (async_save, name)
    assert mgr._writer is None and mgr._pending == []


def test_pruning_keeps_the_newest(tmp_path):
    cfg = _cfg()
    mgr = CheckpointManager(str(tmp_path), cfg, max_to_keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(_state(cfg, step=step))
    assert mgr.steps() == [3, 4]
    mgr.close()


@pytest.mark.parametrize("end", ["normal", "divergence", "interrupted"])
def test_driver_closes_its_manager(end, corpus, tmp_path,  # noqa: F811
                                   monkeypatch):
    """Whatever ends the run, the manager is closed after its last save
    and no write is pending when ``train`` returns or raises: a normal end
    (a checkpoint every step), the divergence guard (an absurd learning
    rate) and an exception between steps (the feeder fails at the third
    batch; the last complete step is saved)."""
    from tacotron_tpu_torch.data.feeder import DataFeeder

    events, managers = [], []
    base_save, base_close = CheckpointManager.save, CheckpointManager.close

    def save(self, state):
        events.append(("save", state.step))
        managers.append(self)
        return base_save(self, state)

    def close(self):
        events.append(("close", None))
        return base_close(self)

    monkeypatch.setattr(CheckpointManager, "save", save)
    monkeypatch.setattr(CheckpointManager, "close", close)
    run = str(tmp_path / "run")
    if end == "normal":
        _, cfg = _config(checkpoint_interval=1)
        train(run, corpus, cfg, num_steps=3, device="cpu")
        want = [1, 2, 3]
    elif end == "divergence":
        _, cfg = _config(initial_learning_rate=1e6, checkpoint_interval=1)
        with pytest.raises(DivergenceError):
            train(run, corpus, cfg, num_steps=10, device="cpu")
        want = [s for e, s in events if e == "save"]
        assert len(want) <= 1      # the diverged steps are never saved
    else:
        _, cfg = _config()
        get, calls = DataFeeder.get, []

        def failing_get(self, *args, **kwargs):
            calls.append(1)
            if len(calls) == 3:
                raise KeyError("feeder broke")
            return get(self, *args, **kwargs)

        monkeypatch.setattr(DataFeeder, "get", failing_get)
        with pytest.raises(KeyError):
            train(run, corpus, cfg, num_steps=10, prefetch_depth=0,
                  device="cpu")
        want = [2]
    assert [s for e, s in events if e == "save"] == want
    assert events[-1] == ("close", None)
    assert all(m._pending == [] for m in managers)
    assert ckpt.checkpoint_steps(run) == want


def test_host_copy_is_a_clone_on_the_cpu():
    t = torch.arange(4.0)
    assert ckpt._host(t, copy=False).data_ptr() == t.data_ptr()
    c = ckpt._host(t, copy=True)
    assert c.data_ptr() != t.data_ptr() and torch.equal(c, t)
    np.testing.assert_array_equal(c.numpy(), t.numpy())
