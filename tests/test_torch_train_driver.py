"""The port's train driver on the CPU at small widths, on corpora written by
``tests/test_data.py::_make_corpus`` + ``build_from_path``.

- ``metrics.jsonl`` carries the JAX driver's keys (train and eval), and
  the run dir its layout (config, provenance, checkpoints, sample dumps).
- A run resumed after 2 steps ends with the parameters, statistics and
  optimizer state of an uninterrupted 4-step run (within 1e-6), dropout on:
  the masks are a function of (seed, step).  Every utterance of that
  corpus is the same, so every batch is too: the feeder restarts its
  stream on resume, as the JAX feeder does.
- Prefetch depth 2 trains on the batch sequence of depth 0 (equal
  parameters); the prefetcher keeps order and passes errors on.
- ``warm_start`` takes the weights only: step 0, fresh optimizer state, the
  fine-tune warmup.
- The divergence guard raises ``DivergenceError`` and writes no
  checkpoint of the diverged state; an exception inside a step writes no
  checkpoint of its half-applied update; a step is checkpointed once;
  ``max_seconds`` stops the loop.
- ``Synthesizer.load(run_dir)`` serves the trained weights.
- ``prewarm=True`` logs the JAX driver's two lines, takes one program per
  bucket shape, runs every step of those shapes through them, and ends
  with the state of a run without it, bit for bit.
- The CLI trains on the CPU when asked (also with ``--prewarm``), raises
  without a card otherwise, and refuses the XLA flags and
  ``--distributed``.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron_tpu.config import ModelConfig
from tacotron_tpu.data import build_from_path
from tacotron_tpu_torch.config import Config as TorchConfig
from tacotron_tpu_torch.parallel.prefetch import DevicePrefetcher
from tacotron_tpu_torch.synth import Synthesizer
from tacotron_tpu_torch.train.checkpoint import checkpoint_steps
from tacotron_tpu_torch.train.driver import DivergenceError, train
from tacotron_tpu_torch.train.optim import noam_schedule
from tacotron_tpu_torch.utils import read_metrics
from test_data import _make_corpus, _tiny_config

SMALL = dict(
    embedding_size=32, enc_prenet_sizes=(32, 16), enc_bank_size=4,
    enc_bank_channel_size=16, enc_highway_depth=2, enc_rnn_size=16,
    enc_proj_sizes=(16, 16), attention_size=16, attention_state_size=16,
    dec_layer_num=2, dec_rnn_size=16, dec_prenet_sizes=(16, 8),
    post_bank_size=2, post_bank_channel_size=16, post_highway_depth=2,
    post_rnn_size=16, post_proj_sizes=(16, 80), dropout_prob=0.5)


def _config(n_speakers=2, **train_kw):
    base = _tiny_config()
    model = ModelConfig(model_type="deepvoice" if n_speakers > 1
                        else "single", num_speakers=n_speakers, **SMALL)
    train_kw = dict(dict(test_interval=100, checkpoint_interval=100,
                         decay_learning_rate_mode=1), **train_kw)
    cfg = base.replace(model=model, train=dataclasses.replace(
        base.train, **train_kw))
    return cfg, TorchConfig.from_json(cfg.to_json())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("driver_corpus")
    cfg = _tiny_config()
    dirs = []
    for spk in range(2):
        meta = _make_corpus(str(root / f"spk{spk}"), seed=spk)
        build_from_path(meta, cfg, num_workers=1)
        dirs.append(str(root / f"spk{spk}" / "data"))
    return dirs


@pytest.fixture(scope="module")
def same_corpus(tmp_path_factory):
    """One speaker, four copies of one utterance: every batch is equal."""
    root = tmp_path_factory.mktemp("same_corpus")
    meta = _make_corpus(str(root), n=1)
    line = open(meta).read().strip()
    with open(meta, "w") as fh:
        fh.write("\n".join([line] * 4))
    build_from_path(meta, _tiny_config(), num_workers=1)
    data = root / "data"
    [name] = os.listdir(data)
    for i in range(1, 4):
        (data / f"copy{i}_{name}").write_bytes((data / name).read_bytes())
    return [str(data)]


def _jax_metric_keys(cfg):
    """The JAX train step's metric keys, from its traced output shapes."""
    from tacotron_tpu.train.optim import make_optimizer
    from tacotron_tpu.train.state import abstract_train_state
    from tacotron_tpu.train.step import Batch, make_train_step

    N, T_in, T_out = 2, 16, 32
    i32 = jnp.int32
    batch = Batch(
        inputs=jax.ShapeDtypeStruct((N, T_in), i32),
        input_lengths=jax.ShapeDtypeStruct((N,), i32),
        loss_coeff=jax.ShapeDtypeStruct((N,), jnp.float32),
        mel_targets=jax.ShapeDtypeStruct((N, T_out, 80), jnp.float32),
        linear_targets=jax.ShapeDtypeStruct((N, T_out, 1025), jnp.float32),
        speaker_id=jax.ShapeDtypeStruct((N,), i32),
        target_lengths=jax.ShapeDtypeStruct((N,), i32))
    state = abstract_train_state(cfg, make_optimizer(cfg.train))
    _, metrics = jax.eval_shape(make_train_step(cfg), state, batch,
                                jax.random.PRNGKey(0))
    return set(metrics)


@pytest.mark.parametrize("guided", [False, True],
                         ids=["plain", "guided-annealed"])
def test_metrics_keys_and_run_dir(corpus, tmp_path, guided):
    kw = dict(test_interval=2, checkpoint_interval=2)
    if guided:
        kw.update(guided_attention_weight=0.5,
                  guided_attention_decay_steps=100)
    cfg, tcfg = _config(**kw)
    run = str(tmp_path / "run")
    state = train(run, corpus, tcfg, num_steps=3, device="cpu",
                  test_dump_dir=os.path.join(run, "samples"), sync_every=2)
    assert state.step == 3

    want = (_jax_metric_keys(cfg) - {"diverged"}) | {
        "sec_per_step", "step", "kind", "wall_time"}
    trains = read_metrics(os.path.join(run, "metrics.jsonl"), kind="train")
    assert [r["step"] for r in trains] == [1, 2, 3]
    for rec in trains:
        assert set(rec) == want
        assert all(np.isfinite(rec[k]) for k in want - {"kind"})
    evals = read_metrics(os.path.join(run, "metrics.jsonl"), kind="eval")
    assert [r["step"] for r in evals] == [2]
    assert set(evals[0]) == {"step", "kind", "wall_time", "loss", "mel_loss",
                             "linear_loss", "loss_without_coeff",
                             "train_test_gap"}
    assert checkpoint_steps(run) == [2, 3]
    for name in ("config.json", "git_info.txt", "train.log"):
        assert os.path.isfile(os.path.join(run, name)), name
    assert any(n.startswith("events.out.tfevents") for n in os.listdir(run))
    samples = sorted(os.listdir(os.path.join(run, "samples")))
    assert samples == ["step000000002.wav", "step000000002_alignment.npy"]


def _final_state(run):
    ckpt = os.path.join(run, "checkpoints", str(checkpoint_steps(run)[-1]))
    weights = dict(np.load(os.path.join(ckpt, "variables.npz")))
    opt = torch.load(os.path.join(ckpt, "optimizer.pt"), weights_only=True)
    return weights, opt


def test_resume_equals_uninterrupted(same_corpus, tmp_path):
    _, cfg = _config(n_speakers=1, checkpoint_interval=2)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert train(a, same_corpus, cfg, num_steps=4, device="cpu").step == 4
    assert train(b, same_corpus, cfg, num_steps=2, device="cpu").step == 2
    assert train(b, same_corpus, cfg, num_steps=4, device="cpu").step == 4
    assert "resumed from" in open(os.path.join(b, "train.log")).read()
    (wa, oa), (wb, ob) = _final_state(a), _final_state(b)
    assert set(wa) == set(wb)
    for key in wa:
        np.testing.assert_allclose(wb[key], wa[key], rtol=0, atol=1e-6,
                                   err_msg=key)
    assert oa["step"] == ob["step"] == 4 and oa["count"] == ob["count"] == 4
    for moment in ("m", "v"):
        for name in oa[moment]:
            torch.testing.assert_close(ob[moment][name], oa[moment][name],
                                       rtol=0, atol=1e-6)
    # dropout is on: another seed trains other weights
    c = str(tmp_path / "c")
    train(c, same_corpus, cfg, num_steps=4, seed=7, device="cpu")
    wc, _ = _final_state(c)
    assert any(not np.array_equal(wc[k], wa[k]) for k in wa)


def test_prefetch_depth_keeps_batch_order(corpus, tmp_path):
    _, cfg = _config()
    runs = {}
    for depth in (0, 2):
        run = str(tmp_path / f"d{depth}")
        train(run, corpus, cfg, num_steps=3, prefetch_depth=depth,
              device="cpu")
        runs[depth] = _final_state(run)[0]
    for key in runs[0]:
        np.testing.assert_array_equal(runs[2][key], runs[0][key],
                                      err_msg=key)


def test_prefetcher_order_and_errors():
    from tacotron_tpu_torch.train.step import Batch

    items = iter(range(7))

    def source():
        i = next(items)
        if i == 5:
            raise KeyError("feeder broke")
        return Batch(*([np.full((2,), i, np.int32)] * 6))

    pf = DevicePrefetcher(source, "cpu", depth=2)
    try:
        got = [int(pf.get(timeout=10).inputs[0]) for _ in range(5)]
        with pytest.raises(KeyError, match="feeder broke"):
            pf.get(timeout=10)
    finally:
        pf.stop()
    assert got == [0, 1, 2, 3, 4]
    with pytest.raises(ValueError):
        DevicePrefetcher(source, "cpu", depth=0)


def test_warm_start_resets_step_and_optimizer(corpus, tmp_path):
    _, cfg = _config(decay_learning_rate_mode=0)
    src = str(tmp_path / "src")
    train(src, corpus, cfg, num_steps=2, device="cpu")
    src_weights, _ = _final_state(src)

    dst = str(tmp_path / "dst")
    state = train(dst, corpus, cfg, num_steps=0, initialize_path=src,
                  device="cpu")
    assert state.step == 0 and int(state.opt.count) == 0
    assert all(float(m.abs().max()) == 0.0 for m in state.opt.m)
    weights, opt = _final_state(dst)
    assert opt["step"] == 0
    for key in src_weights:
        np.testing.assert_array_equal(weights[key], src_weights[key])

    train(dst, corpus, cfg, num_steps=1, initialize_path=src, device="cpu")
    [rec] = read_metrics(os.path.join(dst, "metrics.jsonl"), kind="train")
    fine_tune = noam_schedule(cfg.train.initial_learning_rate,
                              cfg.train.warmup_steps_finetune)
    assert rec["step"] == 1
    np.testing.assert_allclose(rec["learning_rate"],
                               float(fine_tune(torch.tensor(0))), rtol=1e-6)


@pytest.mark.parametrize("interrupted", [False, True],
                         ids=["flush", "interrupted"])
def test_divergence_guard(corpus, tmp_path, monkeypatch, interrupted):
    """An absurd learning rate diverges by step 2.  The guard raises at a
    flush; a run interrupted before its next flush (the feeder fails at
    the third batch) still checks its pending steps and saves nothing."""
    from tacotron_tpu_torch.data.feeder import DataFeeder

    _, cfg = _config(initial_learning_rate=1e6, checkpoint_interval=2)
    run = str(tmp_path / "div")
    expected = DivergenceError
    if interrupted:
        _, cfg = _config(initial_learning_rate=1e6)
        get, calls = DataFeeder.get, []

        def failing_get(self, *args, **kwargs):
            calls.append(1)
            if len(calls) == 3:
                raise KeyError("feeder broke")
            return get(self, *args, **kwargs)

        monkeypatch.setattr(DataFeeder, "get", failing_get)
        expected = KeyError
    with pytest.raises(expected):
        train(run, corpus, cfg, num_steps=10, prefetch_depth=0,
              device="cpu")
    assert "Loss exploded" in open(os.path.join(run, "train.log")).read()
    assert checkpoint_steps(run) == []


def test_interrupted_step_is_not_checkpointed(corpus, tmp_path,
                                              monkeypatch):
    """An exception inside the third step's ``Optimizer.update``, after the
    update was applied, leaves a state whose moments, parameters and
    statistics belong to step 3 while its step still reads 2: the driver
    must not save it, so checkpoint 2 stays the one written after step 2."""
    from tacotron_tpu_torch.train.optim import Optimizer

    _, cfg = _config(checkpoint_interval=2)
    update, calls = Optimizer.update, []

    def failing_update(self, *args, **kwargs):
        out = update(self, *args, **kwargs)
        calls.append(1)
        if len(calls) == 3:
            raise KeyboardInterrupt
        return out

    monkeypatch.setattr(Optimizer, "update", failing_update)
    run = str(tmp_path / "run")
    with pytest.raises(KeyboardInterrupt):
        train(run, corpus, cfg, num_steps=5, prefetch_depth=0, device="cpu")
    assert checkpoint_steps(run) == [2]
    _, opt = _final_state(run)
    assert opt["step"] == 2 and opt["count"] == 2
    assert "interrupted inside step 3" in open(
        os.path.join(run, "train.log")).read()


def test_checkpoint_written_once_per_step(corpus, tmp_path, monkeypatch):
    """A run that ends on a checkpoint step does not write that step again;
    a save over an existing step replaces it and leaves nothing aside."""
    from tacotron_tpu_torch.train.checkpoint import CheckpointManager

    _, cfg = _config(checkpoint_interval=2)
    save, saved = CheckpointManager.save, []

    def counting_save(self, state):
        saved.append(state.step)
        return save(self, state)

    monkeypatch.setattr(CheckpointManager, "save", counting_save)
    run = str(tmp_path / "run")
    state = train(run, corpus, cfg, num_steps=2, device="cpu")
    assert saved == [2]
    assert train(run, corpus, cfg, num_steps=2, device="cpu").step == 2
    assert saved == [2]
    CheckpointManager(run, cfg).save(state)
    assert sorted(os.listdir(os.path.join(run, "checkpoints"))) == ["2"]


def test_max_seconds_stops_and_resumes(corpus, tmp_path):
    _, cfg = _config()
    run = str(tmp_path / "budget")
    state = train(run, corpus, cfg, num_steps=50, max_seconds=0.0,
                  device="cpu")
    assert state.step == 0
    assert "wall budget" in open(os.path.join(run, "train.log")).read()
    assert checkpoint_steps(run) == [0]
    assert train(run, corpus, cfg, num_steps=2, device="cpu").step == 2


def test_synthesizer_loads_trained_weights(corpus, tmp_path):
    _, cfg = _config()
    run = str(tmp_path / "run")
    state = train(run, corpus, cfg, num_steps=2, device="cpu")
    synth = Synthesizer(device="cpu").load(run)
    assert synth.config == cfg
    trained = state.model.state_dict()
    for key, value in synth.model.state_dict().items():
        torch.testing.assert_close(value, trained[key], rtol=0, atol=0)
    res = synth.synthesize(texts=["안녕하세요"], speaker_ids=[1],
                           max_steps=3, librosa_trim=False)
    assert np.isfinite(res["wavs"][0]).all()


@pytest.mark.parametrize("pad_to_corpus_max", [True, False],
                         ids=["one-bucket", "bucket-ladder"])
def test_train_prewarm_logs_and_keeps_state(corpus, tmp_path, monkeypatch,
                                            pad_to_corpus_max):
    """As ``tests/test_data.py::test_train_driver_prewarm``: the prewarm
    lines and the bucket count; and the state after 3 steps with
    ``prewarm=True`` equals the state without it, bit for bit."""
    from tacotron_tpu_torch.data.feeder import DataFeeder
    from tacotron_tpu_torch.utils import graphs

    _, cfg = _config()
    cfg = cfg.replace(data=dataclasses.replace(
        cfg.data, pad_to_corpus_max=pad_to_corpus_max))
    shapes = DataFeeder(corpus, cfg, data_type="train",
                        seed=123).bucket_shapes()
    assert (len(shapes) == 1) == pad_to_corpus_max
    eager = str(tmp_path / "eager")
    train(eager, corpus, cfg, num_steps=3, device="cpu")

    replays = []
    call = graphs.Graphed.__call__
    monkeypatch.setattr(graphs.Graphed, "__call__",
                        lambda self, *a: replays.append(1) or call(self, *a))
    run = str(tmp_path / "run_prewarm")
    state = train(run, corpus, cfg, num_steps=3, device="cpu", prewarm=True)
    assert state.step == 3
    assert len(replays) == 3
    text = open(os.path.join(run, "train.log")).read()
    assert f"prewarming {len(shapes)} bucket program(s)" in text
    assert "prewarm done" in text
    (wa, oa), (wb, ob) = _final_state(eager), _final_state(run)
    assert set(wa) == set(wb)
    for key in wa:
        np.testing.assert_array_equal(wb[key], wa[key], err_msg=key)
    assert oa["step"] == ob["step"] == 3 and oa["count"] == ob["count"] == 3
    for moment in ("m", "v"):
        for name in oa[moment]:
            assert torch.equal(ob[moment][name], oa[moment][name]), name
    losses = [[r["loss"] for r in read_metrics(
        os.path.join(d, "metrics.jsonl"), kind="train")] for d in (eager, run)]
    assert losses[0] == losses[1]


@pytest.mark.parametrize("flag", [["--preset", "tpu"],
                                  ["--scan_unroll", "8"], ["--distributed"]])
def test_cli_refuses_xla_and_multi_gpu_flags(corpus, tmp_path, flag,
                                             monkeypatch):
    # --distributed trains under torchrun (tests/test_torch_parallel.py);
    # without torchrun's environment it is refused
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    from tacotron_tpu_torch.train.__main__ import main

    with pytest.raises(SystemExit):
        main([f"--data_paths={corpus[0]}", f"--log_dir={tmp_path}",
              "--device", "cpu"] + flag)
    assert os.listdir(tmp_path) == []


def test_cli_prewarm_trains(corpus, tmp_path):
    from tacotron_tpu_torch.config import save_config
    from tacotron_tpu_torch.train.__main__ import main

    _, cfg = _config(test_interval=2, checkpoint_interval=2)
    cfg_path = str(tmp_path / "small.json")
    save_config(cfg, cfg_path)
    main([f"--data_paths={','.join(corpus)}", f"--config={cfg_path}",
          f"--log_dir={tmp_path / 'logs'}", "--num_steps=2", "--device",
          "cpu", "--prewarm"])
    [run] = os.listdir(tmp_path / "logs")
    run = str(tmp_path / "logs" / run)
    assert checkpoint_steps(run) == [2]
    text = open(os.path.join(run, "train.log")).read()
    assert "prewarming" in text and "prewarm done" in text
    trains = read_metrics(os.path.join(run, "metrics.jsonl"), kind="train")
    assert [r["step"] for r in trains] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in trains)


def test_cli_trains_on_the_cpu_and_needs_a_card_otherwise(corpus, tmp_path):
    from tacotron_tpu_torch.config import save_config
    from tacotron_tpu_torch.train.__main__ import main

    _, cfg = _config(test_interval=2, checkpoint_interval=2)
    cfg_path = str(tmp_path / "small.json")
    save_config(cfg, cfg_path)
    args = [f"--data_paths={','.join(corpus)}", f"--config={cfg_path}",
            f"--log_dir={tmp_path / 'logs'}", "--num_steps=2"]
    main(args + ["--device", "cpu"])
    [run] = os.listdir(tmp_path / "logs")
    run = str(tmp_path / "logs" / run)
    assert checkpoint_steps(run) == [2]
    assert os.path.isfile(os.path.join(run, "samples",
                                       "step000000002.wav"))
    main(args + ["--device", "cpu", f"--load_path={run}",
                 "--num_steps=3"])
    assert checkpoint_steps(run) == [2, 3]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card error cannot show")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(args)
