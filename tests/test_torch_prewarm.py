"""Prewarm as CUDA graphs, held on the CPU at small widths: the static-buffer
bookkeeping of ``utils/graphs.py`` (on the CPU a "replay" calls the function
on the static buffers and copies its results into static outputs, which the
next call overwrites as a replay does), ``Synthesizer.prewarm`` against the
JAX package's, and the train step's capturable form.

- ``prewarm_step_rungs`` equals JAX's for the default config,
  ``steps_per_token=8.0`` and a pinned ``max_steps``, over two bucket sets.
- ``Synthesizer.prewarm`` returns JAX's count for the same arguments, at
  ``max_iters=4`` (``tests/test_synth.py::test_prewarm_compiles_serving_
  programs``).
- ``synthesize`` after ``prewarm`` goes through the prewarmed programs and
  is bit-equal to ``synthesize`` without them; 32 texts at chunks of 16
  are two calls of one program in one ``synthesize``, also bit-equal;
  ``prewarm_args`` captures every chunk of a call; two threads replaying
  one program each get their own audio.
- The step form (the step a device scalar filled before each call, one
  dropout generator re-seeded per step) gives today's step's masks, metrics
  and state bit for bit over 3 steps, dropout on.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron_tpu.config import Config
from tacotron_tpu.synth import synthesizer as jsynth
from tacotron_tpu_torch.config import Config as TorchConfig
from tacotron_tpu_torch.synth import synthesizer as tsynth
from tacotron_tpu_torch.utils import graphs
from test_torch_params import SMALL, random_variables

AUDIO = dict(num_freq=129, sample_rate=16000, frame_shift_ms=8,
             frame_length_ms=16, griffin_lim_iters=3)
MODEL = dict(SMALL, num_mels=10, num_freq=129, reduction_factor=4,
             model_type="deepvoice", num_speakers=2, max_iters=4)
TEXTS = ["안녕하세요.", "반갑습니다 여러분", "음성 합성"]


def _configs():
    cfg = Config.from_dict({"audio": AUDIO, "model": MODEL})
    return cfg, TorchConfig.from_json(cfg.to_json())


@pytest.fixture(scope="module")
def variables():
    cfg, _ = _configs()
    return random_variables(cfg.model, 5)


def _port(variables) -> tsynth.Synthesizer:
    _, tcfg = _configs()
    return tsynth.Synthesizer(device="cpu").load_variables(variables, tcfg)


# ------------------------------------------------------------ utils/graphs

def test_graphed_outputs_are_static_and_shapes_checked():
    set_ = graphs.GraphSet("cpu")
    seen = []

    def fn(x, y):
        seen.append(1)
        return {"sum": x + y, "both": (x * 2, y)}

    g = set_.capture(fn, torch.zeros(3), torch.ones(3))
    assert len(seen) == 1                      # the warm-up
    first = g(torch.arange(3.0), torch.full((3,), 2.0))
    assert torch.equal(first["sum"], torch.tensor([2.0, 3.0, 4.0]))
    second = g(torch.ones(3), torch.ones(3))
    # the same static tensors, overwritten by the second call
    assert second["sum"] is first["sum"]
    assert torch.equal(first["sum"], torch.full((3,), 2.0))
    assert torch.equal(first["both"][0], torch.full((3,), 2.0))
    with pytest.raises(ValueError, match="do not match"):
        g(torch.ones(4), torch.ones(4))
    with pytest.raises(ValueError, match="do not match"):
        g(torch.ones(3, dtype=torch.float64), torch.ones(3))


# -------------------------------------------------------------- serving

_STEPS8 = dict(steps_per_token=8.0)


@pytest.mark.parametrize("buckets", [(32, 64), (32, 64, 96, 128)],
                         ids=["2-buckets", "4-buckets"])
@pytest.mark.parametrize("model_kw,max_steps", [
    ({}, None), (_STEPS8, None), (_STEPS8, 100)],
    ids=["default", "steps-per-token-8", "pinned-max-steps"])
def test_prewarm_step_rungs_match_jax(buckets, model_kw, max_steps):
    cfg = Config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, **model_kw))
    tcfg = TorchConfig.from_json(cfg.to_json())
    want = jsynth.prewarm_step_rungs(cfg, buckets, max_steps)
    got = tsynth.prewarm_step_rungs(tcfg, buckets, max_steps)
    assert got == want


@pytest.mark.parametrize("buckets,batch_sizes", [((32,), (1,)),
                                                 ((32, 64), (1, 2))],
                         ids=["one", "two-by-two"])
def test_prewarm_count_matches_jax(variables, buckets, batch_sizes):
    cfg, _ = _configs()
    js = jsynth.Synthesizer()
    js.config, js.model = cfg, jsynth._model_for(cfg)
    js.variables = jax.tree.map(jnp.asarray, variables)
    want = js.prewarm(token_buckets=buckets, batch_sizes=batch_sizes,
                      fast_vocoder=False)
    ts = _port(variables)
    got = ts.prewarm(token_buckets=buckets, batch_sizes=batch_sizes,
                     fast_vocoder=False)
    assert got == want == len(buckets) * len(batch_sizes)
    assert len(ts._graphs) == got
    # a second prewarm captures nothing new and counts the same programs
    assert ts.prewarm(token_buckets=buckets, batch_sizes=batch_sizes,
                      fast_vocoder=False) == got
    assert len(ts._graphs) == got


def _replays(ts) -> list:
    return [g.replays for g in ts._graphs.values()]


def _assert_same(a, b):
    assert a["ends"] == b["ends"]
    for x, y in zip(a["wavs"], b["wavs"]):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a["alignments"], b["alignments"]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("wire", ["int16", "mulaw8"])
def test_synthesize_after_prewarm_is_bit_equal(variables, wire):
    kw = dict(texts=TEXTS, speaker_ids=[0, 1, 1], max_steps=4,
              fast_vocoder=True, librosa_trim=False, wire_format=wire)
    ts = _port(variables)
    eager = ts.synthesize(**kw)
    assert ts.prewarm(token_buckets=(32,), batch_sizes=(4,), max_steps=4,
                      wire_format=wire) == 1
    replayed = ts.synthesize(**kw)
    assert _replays(ts) == [1]
    _assert_same(replayed, eager)
    # another key (the classic vocoder) runs eagerly
    ts.synthesize(**dict(kw, fast_vocoder=False))
    assert _replays(ts) == [1]


def test_two_chunks_of_one_program(variables):
    """32 texts at chunks of 16: both chunks replay the one program in one
    call, so the first chunk's outputs must be copied out before the
    second's replay overwrites them."""
    texts = [TEXTS[i % len(TEXTS)] for i in range(32)]
    kw = dict(texts=texts, speaker_ids=[i // 16 for i in range(32)],
              max_steps=4, fast_vocoder=True, librosa_trim=False)
    ts = _port(variables)
    eager = ts.synthesize(**kw)
    ts.prewarm(token_buckets=(32,), batch_sizes=(16,), max_steps=4)
    replayed = ts.synthesize(**kw)
    assert _replays(ts) == [2]
    _assert_same(replayed, eager)
    # the two chunks differ (other texts, the other speaker): a lost copy
    # would show
    assert not np.array_equal(eager["wavs"][0], eager["wavs"][16])


@pytest.mark.parametrize("n_texts,max_steps,sizes", [
    (3, 4, (4,)), (20, None, (4, 16))], ids=["one-chunk", "two-sizes"])
def test_prewarm_args_capture_what_synthesize_replays(variables, n_texts,
                                                      max_steps, sizes):
    """``prewarm_args`` names the token bucket, decode steps and chunk
    sizes of a call: after ``prewarm`` with them every chunk replays."""
    texts = [TEXTS[i % len(TEXTS)] for i in range(n_texts)]
    kw = dict(texts=texts, speaker_ids=[i % 2 for i in range(n_texts)],
              max_steps=max_steps, fast_vocoder=True, librosa_trim=False)
    ts = _port(variables)
    eager = ts.synthesize(**kw)
    args = ts.prewarm_args(texts, max_steps=max_steps, fast_vocoder=True)
    assert args["token_buckets"] == (32,) and args["batch_sizes"] == sizes
    assert args["max_steps"] == 4           # max_iters caps the budget
    assert ts.prewarm(**args) == len(sizes)
    replayed = ts.synthesize(**kw)
    assert sorted(_replays(ts)) == [1] * len(sizes)
    _assert_same(replayed, eager)


def test_concurrent_calls_take_turns_on_the_graphs(variables):
    """Two threads replaying one program: each gets its own texts' audio,
    though a call pauses between its copy-in and its replay (the other
    thread's copy-in would land there without the synthesizer's lock)."""
    import threading
    import time
    ts = _port(variables)
    kws = [dict(texts=[TEXTS[i]], speaker_ids=[i % 2], max_steps=4,
                fast_vocoder=True, librosa_trim=False) for i in (0, 2)]
    want = [ts.synthesize(**kw) for kw in kws]
    ts.prewarm(token_buckets=(32,), max_steps=4)
    [graphed] = ts._graphs.values()
    replay = graphed.fn

    def paused(*args):
        time.sleep(0.02)
        return replay(*args)

    graphed.fn = paused
    got, errors = [[], []], []

    def run(i):
        try:
            for _ in range(4):
                got[i].append(ts.synthesize(**kws[i]))
        except Exception as exc:  # surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert _replays(ts) == [8]
    for i in (0, 1):
        for res in got[i]:
            _assert_same(res, want[i])


def test_prewarm_is_dropped_with_the_weights(variables):
    ts = _port(variables)
    ts.prewarm(token_buckets=(32,), max_steps=4)
    assert ts._graphs
    _, tcfg = _configs()
    ts.init_random(tcfg, seed=9)
    assert not ts._graphs


# ------------------------------------------------------------- training

def _old_step(config, optimizer, state, batch, seed):
    """The train step as it was before it became capturable: the step a
    fresh ``torch.full`` scalar and a fresh generator per step."""
    from tacotron_tpu_torch.train.optim import global_norm
    from tacotron_tpu_torch.train.step import (dropout_seed, forward_loss,
                                               guided_weight_at)
    model = state.model
    params = state.parameters()
    model.train()
    step_t = torch.full((), state.step, dtype=torch.int32)
    generator = torch.Generator()
    generator.manual_seed(dropout_seed(seed, state.step))
    gw = guided_weight_at(config, step_t)
    losses, _ = forward_loss(model, config, batch, generator, gw)
    for p in params:
        p.grad = None
    losses["loss"].backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    grad_norm = optimizer.update(params, grads, state.opt)
    for p in params:
        p.grad = None
    loss = losses["loss"].detach()
    metrics = {
        "param_norm": global_norm([p.detach() for p in params]),
        "loss": loss, "mel_loss": losses["mel_loss"].detach(),
        "linear_loss": losses["linear_loss"].detach(),
        "loss_without_coeff": losses["loss_without_coeff"].detach(),
        "learning_rate": optimizer.schedule(step_t),
        "grad_norm": grad_norm,
        "diverged": torch.logical_or(loss > 100.0, torch.isnan(loss)),
        "attention_mass": losses["attention_mass"],
        "attention_loss": losses["attention_loss"].detach(),
        "guided_weight": gw}
    state.step += 1
    return metrics


def _train_setup():
    from tacotron_tpu_torch.train import step as port_step
    from tacotron_tpu_torch.train.state import create_train_state
    from test_torch_train_step import _batch
    cfg, _ = _configs()
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, dropout_prob=0.5),
        train=dataclasses.replace(cfg.train, guided_attention_weight=0.5,
                                  guided_attention_decay_steps=10))
    cfg = cfg.replace(audio=dataclasses.replace(
        cfg.audio, num_freq=MODEL["num_freq"], num_mels=MODEL["num_mels"]))
    tcfg = TorchConfig.from_json(cfg.to_json())
    batch = _batch(cfg, 4)._replace(
        speaker_id=np.asarray([0, 1, 1], np.int32))
    batch = port_step.batch_to_device(port_step.Batch(*batch), "cpu")
    return tcfg, batch, lambda: create_train_state(tcfg, seed=3,
                                                   device="cpu")


def _state_tensors(state):
    return (list(state.model.state_dict().values()) + state.opt.m
            + state.opt.v + [state.opt.count])


@pytest.mark.parametrize("prewarmed", [False, True],
                         ids=["eager", "prewarmed"])
def test_step_form_equals_the_old_step(prewarmed):
    from tacotron_tpu_torch.train.optim import Optimizer
    from tacotron_tpu_torch.train.step import make_train_step
    tcfg, batch, new_state = _train_setup()
    old, new = new_state(), new_state()
    optimizer = Optimizer(tcfg.train)
    step_fn = make_train_step(tcfg)
    if prewarmed:
        before = [t.clone() for t in _state_tensors(new)]
        assert step_fn.prewarm(new, [batch]) == 1
        for a, b in zip(_state_tensors(new), before):
            assert torch.equal(a, b)
    for _ in range(3):
        want = _old_step(tcfg, optimizer, old, batch, 7)
        new, got = step_fn(new, batch, 7)
        assert new.step == old.step
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert float(want["loss"]) > 0.0
    for a, b in zip(_state_tensors(new), _state_tensors(old)):
        assert torch.equal(a, b)


def test_prewarmed_step_refuses_another_state():
    from tacotron_tpu_torch.train.step import make_train_step
    tcfg, batch, new_state = _train_setup()
    step_fn = make_train_step(tcfg)
    step_fn.prewarm(new_state(), [batch])
    with pytest.raises(ValueError, match="another TrainState"):
        step_fn(new_state(), batch, 0)
