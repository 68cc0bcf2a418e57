"""What decides ``correct``, on the CPU at small widths: a sound run of
the program passes the cell's limits, and a run whose timed path is
broken underneath, or the control (the reference one precision below the
configuration's in the program's place), does not."""

import numpy as np
import pytest

from perfbench import check
from perfbench.tests import small


def correct(run):
    return bool(run.checks) and all(c["ok"] for c in run.checks)


# ----------------------------------------------------------------- offline

@pytest.fixture(scope="module")
def offline_sound(tmp_path_factory):
    cell = small.cell("single_offline_long")
    return small.run(cell, small.args(control=True),
                     tmp_path_factory.mktemp("o"))


def test_offline_sound_run_is_correct(offline_sound):
    assert correct(offline_sound), offline_sound.checks


def test_offline_control_is_not_correct(offline_sound):
    from perfbench import core
    limits = core.find_cell("single_offline_long").limits["limits"]
    numbers = offline_sound.control[check.CONTROL["offline"]]
    checks = core.judge(numbers, limits)
    assert not all(c["ok"] for c in checks), offline_sound.control


def _broken_synthesize(monkeypatch, fault):
    from tacotron_tpu_torch.synth.synthesizer import Synthesizer
    real = Synthesizer.synthesize

    def synthesize(self, texts=None, **kw):
        if fault == "half_batch":
            half = len(texts) // 2
            out = real(self, texts[:half], **kw)
            for key in ("wavs", "alignments"):
                out[key] = out[key] + out[key][:len(texts) - half]
            out["ends"] = out["ends"] + out["ends"][:len(texts) - half]
            return out
        # a token altered where the frontend produces it: each text's
        # first syllable read as another
        altered = [chr(0xAC00 + (ord(t[0]) - 0xAC00 + 1) % 11172) + t[1:]
                   for t in texts]
        return real(self, altered, **kw)

    monkeypatch.setattr(Synthesizer, "synthesize", synthesize)


@pytest.mark.parametrize("fault", ["half_batch", "token_altered"])
def test_offline_fault_is_not_correct(monkeypatch, tmp_path, fault):
    _broken_synthesize(monkeypatch, fault)
    cell = small.cell("single_offline_long", check_sample=4)
    run = small.run(cell, small.args(), tmp_path)
    assert not correct(run), run.checks


# ---------------------------------------------------------------- training

@pytest.fixture(scope="module")
def train_sound(tmp_path_factory):
    cell = small.cell("dv2_train_b16")
    return small.run(cell, small.args(control=True),
                     tmp_path_factory.mktemp("t"))


def test_train_sound_run_is_correct(train_sound):
    """At these widths a parameter change of a few rounding steps is a
    larger share of a leaf's change than at the cell's: ``update_gap`` is
    held to a third of the control's reading instead of the cell's
    limit."""
    for c in train_sound.checks:
        if c["name"] == "update_gap":
            control = train_sound.control[check.CONTROL["train"]]
            assert c["value"] < control["update_gap"] / 3
        else:
            assert c["ok"], c


def test_train_control_is_not_correct(train_sound):
    from perfbench import core
    limits = core.find_cell("dv2_train_b16").limits["limits"]
    checks = core.judge(train_sound.control[check.CONTROL["train"]],
                        limits)
    assert not all(c["ok"] for c in checks), train_sound.control


def _broken_train(monkeypatch, fault):
    import tacotron_tpu_torch.train.step as step_mod
    from tacotron_tpu_torch.data.feeder import DataFeeder
    from tacotron_tpu_torch.train.optim import Optimizer
    if fault == "state_unchanged":
        def update(self, params, grads, state):
            return step_mod.global_norm(grads)
        monkeypatch.setattr(Optimizer, "update", update)
    elif fault == "half_batch":
        real = step_mod.forward_loss

        def forward_loss(model, config, batch, *a, **kw):
            half = batch.inputs.shape[0] // 2
            batch = step_mod.Batch(*(None if x is None else x[:half]
                                     for x in batch))
            return real(model, config, batch, *a, **kw)
        monkeypatch.setattr(step_mod, "forward_loss", forward_loss)
    elif fault == "token_altered":
        real = DataFeeder._prepare_batch

        def prepare(self, examples):
            batch = real(self, examples)
            batch.inputs[0, 0] = (batch.inputs[0, 0] + 1) % 80 or 2
            return batch
        monkeypatch.setattr(DataFeeder, "_prepare_batch", prepare)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered"])
def test_train_fault_is_not_correct(monkeypatch, tmp_path, fault):
    _broken_train(monkeypatch, fault)
    run = small.run(small.cell("dv2_train_b16"), small.args(), tmp_path)
    assert not correct(run), run.checks


def test_reservoir_sample_is_seeded(tmp_path):
    cell = small.cell("single_offline_short", check_sample=2)
    a = small.run(cell, small.args(seed=9), tmp_path)
    b = small.run(cell, small.args(seed=9), tmp_path)
    assert a.numbers == b.numbers
    assert np.isfinite(list(a.numbers.values())).all()
