"""Composition-level parity: the port's ``Tacotron`` against the JAX
``Tacotron`` on the same randomized weights, teacher-forced and greedy.

Shapes and cases are those of tests/test_forward_oracle.py (SHAPE_A/SHAPE_B
x model_type/embedding, and the four non-default attention mechanisms).
Tolerances as there: 2e-4 teacher-forced, 5e-4 greedy (the greedy decode
feeds its own output back, so float32 reassociation compounds over steps)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron_tpu.config import ModelConfig
from tacotron_tpu.models.tacotron import Tacotron
from tacotron_tpu_torch import params as P
from tacotron_tpu_torch.config import ModelConfig as TorchModelConfig
from tacotron_tpu_torch.models.tacotron import Tacotron as TorchTacotron
from test_forward_oracle import SHAPE_A, SHAPE_B
from test_torch_params import model_config, random_variables

CASES = [(SHAPE_A, "single", 16, "bah_mon", 101),
         (SHAPE_A, "deepvoice", 16, "bah_mon", 202),
         (SHAPE_A, "deepvoice", 1, "bah_mon", 303),
         (SHAPE_A, "simple", 16, "bah_mon", 404),
         (SHAPE_B, "single", 16, "bah_mon", 101),
         (SHAPE_B, "deepvoice", 16, "bah_mon", 202),
         (SHAPE_B, "deepvoice", 1, "bah_mon", 303),
         (SHAPE_B, "simple", 16, "bah_mon", 404)] + [
    (SHAPE_A, "single", 16, att, 7)
    for att in ("bah", "bah_norm", "luong", "luong_scaled")]
IDS = [f"{'AB'[c[0] is SHAPE_B]}-{c[1]}-emb{c[2]}-{c[3]}" for c in CASES]


@pytest.mark.parametrize("shape,model_type,emb,attention_type,seed", CASES,
                         ids=IDS)
def test_tacotron_matches_jax(shape, model_type, emb, attention_type, seed):
    kw = dict(model_config(model_type, emb, **shape),
              attention_type=attention_type)
    cfg = ModelConfig(**kw)
    variables = random_variables(cfg, seed)
    model = Tacotron(cfg)
    port = TorchTacotron(TorchModelConfig(**kw)).eval()
    port.load_state_dict(P.from_flax(variables))

    rng = np.random.default_rng(seed + 100)
    N, T_in, steps = 2, 12, 4
    T_out = steps * cfg.reduction_factor
    inputs = rng.integers(0, 80, (N, T_in)).astype(np.int32)
    lengths = np.asarray([T_in, T_in - 3], np.int32)
    mels = rng.uniform(0, 1, (N, T_out, cfg.num_mels)).astype(np.float32)
    spk = None if model_type == "single" else np.asarray([0, 2], np.int32)

    t_in, t_len = torch.from_numpy(inputs).long(), torch.from_numpy(lengths)
    t_spk = None if spk is None else torch.from_numpy(spk).long()
    with torch.no_grad():
        got_f = port(t_in, t_len, t_spk, mel_targets=torch.from_numpy(mels))
        got_g = port(t_in, t_len, t_spk, max_steps=steps)
    want_f = model.apply(variables, jnp.asarray(inputs), jnp.asarray(lengths),
                         speaker_id=spk, mel_targets=jnp.asarray(mels),
                         train=False)
    want_g = model.apply(variables, jnp.asarray(inputs), jnp.asarray(lengths),
                         speaker_id=spk, train=False, max_steps=steps)
    for got, want, tol, mode in ((got_f, want_f, 2e-4, "forced"),
                                 (got_g, want_g, 5e-4, "greedy")):
        for key in ("mel_outputs", "linear_outputs", "alignments"):
            np.testing.assert_allclose(
                got[key].numpy(), np.asarray(want[key]), rtol=tol, atol=tol,
                err_msg=f"{model_type}/emb{emb}/{attention_type} {mode} "
                        f"{key}")


def test_manual_alignment_override_matches_jax():
    """Greedy decode with the manual-alignment override switched on: the
    given alignments replace the computed ones at every step."""
    kw = model_config("deepvoice", 16, **SHAPE_A)
    cfg = ModelConfig(**kw)
    variables = random_variables(cfg, 9)
    port = TorchTacotron(TorchModelConfig(**kw)).eval()
    port.load_state_dict(P.from_flax(variables))
    rng = np.random.default_rng(9)
    N, T_in, steps = 2, 10, 3
    inputs = rng.integers(0, 80, (N, T_in)).astype(np.int32)
    lengths = np.asarray([T_in, T_in - 4], np.int32)
    spk = np.asarray([1, 2], np.int32)
    manual = rng.dirichlet(np.ones(T_in), (N, steps)).astype(np.float32)
    want = Tacotron(cfg).apply(
        variables, jnp.asarray(inputs), jnp.asarray(lengths),
        speaker_id=jnp.asarray(spk), train=False, max_steps=steps,
        manual_alignments=jnp.asarray(manual), is_manual=jnp.asarray(True))
    with torch.no_grad():
        got = port(torch.from_numpy(inputs).long(),
                   torch.from_numpy(lengths), torch.from_numpy(spk).long(),
                   max_steps=steps, manual_alignments=torch.from_numpy(manual),
                   is_manual=torch.tensor(True))
    np.testing.assert_allclose(got["alignments"].numpy(),
                               manual.transpose(0, 2, 1), atol=0)
    for key in ("mel_outputs", "linear_outputs", "alignments"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=5e-4, atol=5e-4, err_msg=key)
