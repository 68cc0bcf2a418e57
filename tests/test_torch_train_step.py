"""The port's train step against ``tacotron_tpu.train.step`` on the same
weights and batch, at small widths with ``dropout_prob=0`` (dropout masks
cannot match across frameworks).

- BatchNorm in training mode (output and the moved running statistics)
  against flax's ``nn.BatchNorm``: 1e-6.
- ``features_from_waveform``, ``spectrogram`` and ``melspectrogram``
  against JAX's: 1e-5 on the normalized targets,
  but for at most 0.01 % of the bins, which stay within 1e-4: bins near a
  spectral null (the DC bin of a frame whose samples nearly cancel) turn
  the two FFT libraries' float32 rounding into dB differences (observed
  5.8e-5 at the DC bin, where the port lies 7.5e-5 and JAX 1.7e-5 from a
  float64 reference).
- One train step against ``make_train_step``, guided attention off and on
  (annealed): loss and every metric rel 1e-5; per-parameter gradients,
  compared through Adam's first moment after one step (``(1 - b1)`` times
  the clipped gradient on both sides), max abs over the global gradient
  norm 1e-4; the new BatchNorm statistics 1e-5; the new parameters within
  ``2 * lr + 1e-6`` (Adam's first update is ``+-lr * sign(g)``, so a
  gradient near 0 may flip its sign between frameworks).
- The eval step on the stepped state: rel 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron_tpu.config import Config, ModelConfig, TrainConfig
from tacotron_tpu.dsp.chip import (features_from_waveform, melspectrogram,
                                   spectrogram)
from tacotron_tpu.models.modules import BatchNorm
from tacotron_tpu.train.optim import make_optimizer
from tacotron_tpu.train.state import TrainState
from tacotron_tpu.train.step import Batch, make_eval_step, make_train_step
from tacotron_tpu_torch import params as P
from tacotron_tpu_torch.config import Config as TorchConfig
from tacotron_tpu_torch.dsp import chip as port_chip
from tacotron_tpu_torch.models.modules import BatchNorm as PortBatchNorm
from tacotron_tpu_torch.train import step as port_step
from tacotron_tpu_torch.train.state import TrainState as PortState
from tacotron_tpu_torch.train.state import create_model
from tacotron_tpu_torch.train.optim import AdamState
from test_torch_params import SMALL, random_variables


def test_batchnorm_training_matches_flax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 7, 12)) * 2.0 + 0.5).astype(np.float32)
    mean0 = rng.standard_normal(12).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 12).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 12).astype(np.float32)
    bias = rng.standard_normal(12).astype(np.float32)
    variables = {"params": {"BatchNorm_0": {"scale": scale, "bias": bias}},
                 "batch_stats": {"BatchNorm_0": {"mean": mean0,
                                                 "var": var0}}}
    want, mutated = BatchNorm().apply(variables, jnp.asarray(x), True,
                                      mutable=["batch_stats"])
    bn = PortBatchNorm(12).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    got = bn(torch.from_numpy(x))
    stats = mutated["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=0, atol=1e-6)


def test_features_from_waveform_matches_jax():
    cfg = Config().audio
    rng = np.random.default_rng(1)
    S = 40 * cfg.hop_length
    t = np.arange(S) / cfg.sample_rate
    wavs = np.stack([0.5 * np.sin(2 * np.pi * 220 * t)
                     + 0.05 * rng.standard_normal(S),
                     0.3 * np.sin(2 * np.pi * 97 * t)
                     + 0.05 * rng.standard_normal(S)])
    wavs[1, S // 2:] = 0.0                     # a zero-padded tail
    wavs = wavs.astype(np.float32)
    want_lin, want_mel = jax.jit(
        lambda w: features_from_waveform(w, cfg))(jnp.asarray(wavs))
    tcfg = TorchConfig().audio
    got_lin, got_mel = port_chip.features_from_waveform(
        torch.from_numpy(wavs), tcfg)
    assert got_lin.shape == (2, 41, cfg.num_freq)
    assert got_mel.shape == (2, 41, cfg.num_mels)
    # the unbatched JAX spectrogram / melspectrogram against the port's
    # batched ones, row by row
    one_lin = jax.jit(jax.vmap(lambda w: spectrogram(w, cfg)))(
        jnp.asarray(wavs))
    one_mel = jax.jit(jax.vmap(lambda w: melspectrogram(w, cfg)))(
        jnp.asarray(wavs))
    pairs = ((got_lin, want_lin), (got_mel, want_mel),
             (port_chip.spectrogram(torch.from_numpy(wavs), tcfg), one_lin),
             (port_chip.melspectrogram(torch.from_numpy(wavs), tcfg),
              one_mel))
    for got, want in pairs:
        err = np.abs(got.numpy() - np.asarray(want))
        assert float(err.max()) <= 1e-4, float(err.max())
        assert int((err > 1e-5).sum()) <= 1e-4 * err.size, \
            int((err > 1e-5).sum())


def _configs(guided: bool):
    model = dict(SMALL, model_type="deepvoice", num_speakers=3,
                 dropout_prob=0.0)
    train = dict(decay_learning_rate_mode=0, initial_learning_rate=0.002,
                 grad_clip_norm=1.0)
    if guided:
        train.update(guided_attention_weight=0.5,
                     guided_attention_decay_steps=10)
    cfg = Config().replace(model=ModelConfig(**model),
                           train=TrainConfig(**train))
    audio = dataclasses.replace(cfg.audio, num_freq=SMALL["num_freq"],
                                num_mels=SMALL["num_mels"])
    return cfg.replace(audio=audio), TorchConfig.from_json(
        cfg.replace(audio=audio).to_json())


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    N, T_in, T_out = 3, 12, 16
    lengths = np.asarray([12, 9, 6], np.int32)
    inputs = rng.integers(1, 60, (N, T_in)).astype(np.int32)
    inputs[np.arange(T_in)[None, :] >= lengths[:, None]] = 0
    target_lengths = np.asarray([14, 11, 7], np.int32)
    pad = np.arange(T_out)[None, :, None] >= target_lengths[:, None, None]
    mel = rng.uniform(0, 1, (N, T_out, cfg.model.num_mels))
    lin = rng.uniform(0, 1, (N, T_out, cfg.model.num_freq))
    return Batch(inputs=inputs, input_lengths=lengths,
                 loss_coeff=np.asarray([1.0, 0.5, 1.0], np.float32),
                 mel_targets=np.where(pad, 0, mel).astype(np.float32),
                 linear_targets=np.where(pad, 0, lin).astype(np.float32),
                 speaker_id=np.asarray([0, 2, 1], np.int32),
                 target_lengths=target_lengths)


@pytest.mark.parametrize("guided", [False, True],
                         ids=["plain", "guided-annealed"])
def test_train_step_matches_jax(guided):
    cfg, tcfg = _configs(guided)
    variables = random_variables(cfg.model, 21)
    batch = _batch(cfg, 22)

    opt = make_optimizer(cfg.train, True)
    start_step = 3
    j_state = TrainState(
        step=jnp.asarray(start_step, jnp.int32),
        params=jax.tree.map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=opt.init(variables["params"]))
    j_new, j_metrics = make_train_step(cfg)(
        j_state, Batch(*(None if x is None else jnp.asarray(x)
                         for x in batch)), jax.random.PRNGKey(0))

    model = create_model(tcfg)
    model.load_state_dict(P.from_flax(variables))
    state = PortState(step=start_step, model=model.train(),
                      opt=AdamState.zeros(list(model.parameters())))
    t_batch = port_step.batch_to_device(port_step.Batch(*batch), "cpu")
    state, metrics = port_step.make_train_step(tcfg)(state, t_batch, 0)
    assert state.step == start_step + 1

    assert set(metrics) == set(j_metrics)
    for key, want in j_metrics.items():
        np.testing.assert_allclose(float(metrics[key]), float(want),
                                   rtol=1e-5, err_msg=key)

    got = P.flatten_variables(P.to_flax(state.model.state_dict()))
    want = P.flatten_variables({"params": j_new.params,
                                "batch_stats": j_new.batch_stats})
    assert set(got) == set(want)
    lr = float(j_metrics["learning_rate"])
    for path, arr in want.items():
        tol = 1e-5 if path.startswith("batch_stats") else 2 * lr + 1e-6
        np.testing.assert_allclose(got[path], np.asarray(arr), rtol=0,
                                   atol=tol, err_msg=path)

    # gradients through Adam's first moment: (1 - b1) * clipped gradient
    names = [n for n, _ in state.model.named_parameters()]
    moments = dict(state.model.state_dict())
    moments.update(zip(names, state.opt.m))
    m_port = P.flatten_variables(P.to_flax(moments))
    m_jax = P.flatten_variables({"params": j_new.opt_state[1].mu})
    g_norm = float(j_metrics["grad_norm"])
    clip = min(1.0, cfg.train.grad_clip_norm / g_norm)
    scale = clip * g_norm * (1.0 - cfg.train.adam_beta1)
    for path, arr in m_jax.items():
        err = float(np.abs(m_port[path] - np.asarray(arr)).max()) / scale
        assert err <= 1e-4, (path, err)

    # the eval step on the stepped state
    j_eval = make_eval_step(cfg)(j_new, Batch(
        *(None if x is None else jnp.asarray(x) for x in batch)))
    t_eval = port_step.make_eval_step(tcfg)(state, t_batch)
    assert set(t_eval) == set(j_eval)
    for key, want in j_eval.items():
        np.testing.assert_allclose(float(t_eval[key]), float(want),
                                   rtol=1e-5, err_msg=f"eval {key}")
