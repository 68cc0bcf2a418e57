"""The port's training losses against the JAX package's on the same random
tensors: ``tacotron_loss`` (plain means, the reference-equivalent
``target_lengths`` normalization, the prioritized band, ``loss_coeff``) and
``guided_attention_loss`` (with and without target lengths), atol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron_tpu.config import AudioConfig, TrainConfig
from tacotron_tpu.train.losses import guided_attention_loss, tacotron_loss
from tacotron_tpu_torch.train import losses as port

N, T, M, F, T_IN = 3, 24, 10, 33, 9


def _inputs(seed):
    rng = np.random.default_rng(seed)
    arrays = dict(
        mel_outputs=rng.uniform(0, 1, (N, T, M)),
        linear_outputs=rng.uniform(0, 1, (N, T, F)),
        mel_targets=rng.uniform(0, 1, (N, T, M)),
        linear_targets=rng.uniform(0, 1, (N, T, F)))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    coeff = rng.uniform(0.2, 1.0, N).astype(np.float32)
    lengths = np.asarray([T - 9, T - 3, 7], np.int32)
    return arrays, coeff, lengths


@pytest.mark.parametrize("prioritize", [False, True])
@pytest.mark.parametrize("with_lengths", [False, True])
@pytest.mark.parametrize("with_coeff", [False, True])
def test_tacotron_loss_matches_jax(prioritize, with_lengths, with_coeff):
    arrays, coeff, lengths = _inputs(1)
    tc = TrainConfig(prioritize_loss=prioritize)
    audio = AudioConfig(num_freq=F)
    kw = dict(reduction_factor=4)
    want = tacotron_loss(
        **{k: jnp.asarray(v) for k, v in arrays.items()},
        loss_coeff=jnp.asarray(coeff) if with_coeff else None,
        train_config=tc, audio_config=audio,
        target_lengths=jnp.asarray(lengths) if with_lengths else None, **kw)
    got = port.tacotron_loss(
        **{k: torch.from_numpy(v) for k, v in arrays.items()},
        loss_coeff=torch.from_numpy(coeff) if with_coeff else None,
        train_config=tc, audio_config=audio,
        target_lengths=torch.from_numpy(lengths) if with_lengths else None,
        **kw)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=0, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("with_lengths", [False, True])
def test_guided_attention_loss_matches_jax(with_lengths):
    rng = np.random.default_rng(2)
    T_dec = T // 4
    align = rng.dirichlet(np.ones(T_IN), (N, T_dec)).transpose(0, 2, 1)
    align = (0.9 * align).astype(np.float32)        # some mass leaks
    in_len = np.asarray([T_IN, 5, 1], np.int32)
    lengths = np.asarray([T - 9, T - 3, 3], np.int32)
    want = guided_attention_loss(
        jnp.asarray(align), jnp.asarray(in_len),
        jnp.asarray(lengths) if with_lengths else None, 4, sigma=0.3)
    got = port.guided_attention_loss(
        torch.from_numpy(align), torch.from_numpy(in_len),
        torch.from_numpy(lengths) if with_lengths else None, 4, sigma=0.3)
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-6)
