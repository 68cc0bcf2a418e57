"""Weight bridge of the PyTorch port: flax variable tree <-> state dict.

``from_flax`` -> ``to_flax`` must reproduce a JAX-initialized tree exactly
(same paths, same arrays), and the state dict must load into the port's
``Tacotron`` with no missing or unexpected key."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron_tpu.config import ModelConfig
from tacotron_tpu.models.tacotron import Tacotron
from tacotron_tpu_torch import params as P
from tacotron_tpu_torch.config import ModelConfig as TorchModelConfig
from tacotron_tpu_torch.models.tacotron import Tacotron as TorchTacotron

# SHAPE_A of tests/test_forward_oracle.py
SMALL = dict(
    num_mels=10, num_freq=33, embedding_size=32, enc_prenet_sizes=(32, 16),
    enc_bank_size=4, enc_bank_channel_size=16, enc_highway_depth=2,
    enc_rnn_size=16, enc_proj_sizes=(16, 16), attention_size=16,
    attention_state_size=16, dec_layer_num=2, dec_rnn_size=16,
    dec_prenet_sizes=(16, 8), post_bank_size=2, post_bank_channel_size=16,
    post_highway_depth=2, post_rnn_size=16, post_proj_sizes=(16, 10),
    reduction_factor=2)


def _init_args(cfg: ModelConfig):
    N, T_in, steps = 2, 7, 2
    spk = (jnp.zeros((N,), jnp.int32) if cfg.num_speakers > 1 else None)
    key = jax.random.PRNGKey(0)
    return ({"params": key, "dropout": key},
            jnp.zeros((N, T_in), jnp.int32), jnp.full((N,), T_in, jnp.int32)), \
        dict(speaker_id=spk, mel_targets=jnp.zeros(
            (N, steps * cfg.reduction_factor, cfg.num_mels)), train=True)


def init_variables(cfg: ModelConfig):
    """JAX-initialized {"params", "batch_stats"} tree as numpy arrays."""
    args, kwargs = _init_args(cfg)
    return jax.tree.map(np.asarray,
                        dict(Tacotron(cfg).init(*args, **kwargs)))


def random_variables(cfg: ModelConfig, seed: int):
    """A tree with the JAX model's structure (traced, not compiled) filled
    with random params (0.3 normal) and batch statistics, so no init
    symmetry hides a layout error."""
    args, kwargs = _init_args(cfg)
    shapes = jax.eval_shape(lambda: Tacotron(cfg).init(*args, **kwargs))
    rng = np.random.default_rng(seed)
    out = {}
    for keys, leaf in jax.tree_util.tree_flatten_with_path(dict(shapes))[0]:
        path = "/".join(k.key for k in keys)
        if path.endswith("/var"):
            val = rng.uniform(0.5, 1.5, leaf.shape)
        else:
            val = 0.3 * rng.standard_normal(leaf.shape)
        out[path] = np.asarray(val, np.float32)
    return P.unflatten_variables(out)


def model_config(model_type: str, emb: int, **shape) -> dict:
    n_spk = 1 if model_type == "single" else 3
    return dict(model_type=model_type, num_speakers=n_spk,
                speaker_embedding_size=emb, **(shape or SMALL))


@pytest.mark.parametrize("model_type,emb,jax_init", [
    ("single", 16, False), ("deepvoice", 16, True), ("deepvoice", 1, False),
    ("simple", 16, False)])
def test_round_trip_is_exact(model_type, emb, jax_init):
    """On the JAX-initialized tree (one case; a full init compile is slow
    on the CPU) and on random trees of the JAX model's structure."""
    kw = model_config(model_type, emb)
    cfg = ModelConfig(**kw)
    variables = (init_variables(cfg) if jax_init
                 else random_variables(cfg, 11))
    state = P.from_flax(variables)
    model = TorchTacotron(TorchModelConfig(**kw))
    assert set(state) == set(model.state_dict()), \
        set(state) ^ set(model.state_dict())
    for key, value in model.state_dict().items():
        assert state[key].shape == value.shape, key
    model.load_state_dict(state)

    back = P.flatten_variables(P.to_flax(model.state_dict()))
    want = P.flatten_variables(variables)
    assert set(back) == set(want), set(back) ^ set(want)
    for path, arr in want.items():
        np.testing.assert_array_equal(back[path], arr, err_msg=path)
        assert back[path].dtype == np.float32


def test_flat_npz_round_trip(tmp_path):
    kw = model_config("deepvoice", 16)
    variables = random_variables(ModelConfig(**kw), 7)
    model = TorchTacotron(TorchModelConfig(**kw))
    model.load_state_dict(P.from_flax(variables))
    path = str(tmp_path / "weights.npz")
    P.save_npz(path, model.state_dict())
    flat = P.load_npz(path)
    assert "params/decoder/prenet/dense_1/kernel" in flat
    assert "batch_stats/encoder_cbhg/bank_bn/BatchNorm_0/mean" in flat
    state = P.from_flax(flat)
    for key, value in model.state_dict().items():
        torch.testing.assert_close(state[key], value, rtol=0, atol=0)


def test_random_init_distributions():
    """init_random_ follows the flax initializers: GRU gate bias 1, highway
    T bias -1, BatchNorm identity, embeddings truncated at 2 std, and the
    same seed gives the same weights."""
    cfg = TorchModelConfig(**model_config("deepvoice", 16))
    a = P.init_random_(TorchTacotron(cfg), seed=3).state_dict()
    b = P.init_random_(TorchTacotron(cfg), seed=3).state_dict()
    c = P.init_random_(TorchTacotron(cfg), seed=4).state_dict()
    for key in a:
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
    assert not torch.equal(a["char_embedding.embedding"],
                           c["char_embedding.embedding"])
    assert torch.all(a["decoder.attention_rnn.gates.bias"] == 1.0)
    assert torch.all(a["encoder_cbhg.highway_1.T.bias"] == -1.0)
    assert torch.all(a["encoder_cbhg.bank_bn.running_var"] == 1.0)
    emb = a["char_embedding.embedding"]
    assert float(emb.abs().max()) <= 2 * 0.5 + 1e-6
    assert 0.3 < float(emb.std()) < 0.5   # 0.5 * 0.88 after truncation
    k = a["decoder.frame_projection.weight"]           # [out, in]
    assert abs(float(k.std()) * np.sqrt(k.shape[1]) - 1.0) < 0.15
