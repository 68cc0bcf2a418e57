"""The whole bfloat16 model against JAX's, over ``tests/test_torch_model.py``'s
``CASES`` (SHAPE_A / SHAPE_B x model type / speaker embedding, and the
non-default attention mechanisms), teacher-forced and greedy at 4 steps,
on the same random weights.  The bounds (``tests/test_torch_bf16.py``
explains the bf16 ulp):

- mel and linear within 3 % of the peak of JAX's float32 output of the
  port's against the jitted JAX bf16 program, alignments within 1e-2;
- the port's distance from JAX's float32 output at most twice the jitted
  JAX bf16 program's own distance from it, plus one ulp of the peak.

Measured on these cases (the CPU): the port against JAX bf16 at most
1.9 % of the peak (mel) and 5.9e-3 (alignments); JAX's own jitted bf16
against its eager bf16 spreads as far (up to 0.0625 on a mel peak of
5.4), so no bound is set at twice that spread.  ``bah_norm`` has no bf16
program: JAX's decode scan refuses to trace it (its float32 score changes
the carry's dtype) and the port refuses it when the model is built.
"""

import dataclasses

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
from test_torch_bf16 import ulp
from test_torch_model import CASES, IDS
from test_torch_params import model_config, random_variables

KEYS = ("mel_outputs", "linear_outputs", "alignments")


def _inputs(cfg, model_type, seed):
    rng = np.random.default_rng(seed + 100)
    N, T_in, steps = 2, 12, 4
    inputs = rng.integers(0, 80, (N, T_in)).astype(np.int32)
    lengths = np.asarray([T_in, T_in - 3], np.int32)
    mels = rng.uniform(0, 1, (N, steps * cfg.reduction_factor,
                              cfg.num_mels)).astype(np.float32)
    spk = None if model_type == "single" else np.asarray([0, 2], np.int32)
    return inputs, lengths, mels, spk, steps


@pytest.mark.parametrize("shape,model_type,emb,attention_type,seed", CASES,
                         ids=IDS)
def test_bf16_tacotron_matches_jax(shape, model_type, emb, attention_type,
                                   seed):
    kw = dict(model_config(model_type, emb, **shape),
              attention_type=attention_type)
    variables = random_variables(ModelConfig(**kw), seed)
    inputs, lengths, mels, spk, steps = _inputs(ModelConfig(**kw),
                                                model_type, seed)

    def jax_run(dtype, forced):
        model = Tacotron(ModelConfig(**kw, compute_dtype=dtype))
        return jax.jit(lambda v: model.apply(
            v, inputs, lengths, speaker_id=spk,
            mel_targets=mels if forced else None,
            max_steps=None if forced else steps))(variables)

    if attention_type == "bah_norm":
        with pytest.raises(TypeError, match="carry"):
            jax_run("bfloat16", True)
        with pytest.raises(ValueError, match="bah_norm"):
            TorchTacotron(TorchModelConfig(**kw, compute_dtype="bfloat16"))
        return

    port = TorchTacotron(TorchModelConfig(**kw, compute_dtype="bfloat16"))
    port.load_state_dict(P.from_flax(variables))
    port.eval()
    t_spk = None if spk is None else torch.from_numpy(spk).long()
    for forced in (True, False):
        with torch.no_grad():
            got = port(torch.from_numpy(inputs).long(),
                       torch.from_numpy(lengths), t_spk,
                       mel_targets=torch.from_numpy(mels) if forced else None,
                       max_steps=None if forced else steps)
        want = jax_run("bfloat16", forced)
        ref = jax_run("float32", forced)
        mode = "forced" if forced else "greedy"
        for key in KEYS:
            g = got[key].numpy()
            assert got[key].dtype == torch.float32, key
            w, r = np.asarray(want[key]), np.asarray(ref[key])
            peak = float(np.abs(r).max())
            err = float(np.abs(g - w).max())
            bound = 1e-2 if key == "alignments" else 0.03 * peak
            assert err <= bound, f"{mode} {key}: {err} against JAX bf16"
            to_f32 = float(np.abs(g - r).max())
            jax_to_f32 = float(np.abs(w - r).max())
            assert to_f32 <= 2 * jax_to_f32 + ulp(peak), \
                f"{mode} {key}: {to_f32} from f32, JAX bf16 {jax_to_f32}"


def test_manual_alignments_enter_in_the_compute_dtype():
    """Float32 manual alignments are cast to bf16 before the decoder, so
    the carry stays bf16 and the returned alignments are their bf16
    values; the decode equals JAX's bf16 model given the same alignments
    in bf16 within the model bounds."""
    kw = model_config("deepvoice", 16)
    variables = random_variables(ModelConfig(**kw), 9)
    rng = np.random.default_rng(9)
    N, T_in, steps = 2, 10, 3
    inputs = rng.integers(0, 80, (N, T_in)).astype(np.int32)
    lengths = np.asarray([T_in, T_in - 4], np.int32)
    spk = np.asarray([1, 2], np.int32)
    manual = rng.dirichlet(np.ones(T_in), (N, steps)).astype(np.float32)
    jax_model = Tacotron(ModelConfig(**kw, compute_dtype="bfloat16"))
    want = jax.jit(lambda v: jax_model.apply(
        v, inputs, lengths, speaker_id=spk, max_steps=steps,
        manual_alignments=jnp.asarray(manual).astype(jnp.bfloat16),
        is_manual=jnp.asarray(True)))(variables)
    port = TorchTacotron(TorchModelConfig(**kw, compute_dtype="bfloat16"))
    port.load_state_dict(P.from_flax(variables))
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(inputs).long(), torch.from_numpy(lengths),
                   torch.from_numpy(spk).long(), max_steps=steps,
                   manual_alignments=torch.from_numpy(manual),
                   is_manual=torch.tensor(True))
    rounded = torch.from_numpy(manual).bfloat16().float().numpy()
    np.testing.assert_array_equal(got["alignments"].numpy(),
                                  rounded.transpose(0, 2, 1))
    for key in ("mel_outputs", "linear_outputs"):
        w = np.asarray(want[key])
        err = float(np.abs(got[key].numpy() - w).max())
        assert err <= 0.03 * float(np.abs(w).max()), (key, err)
    # without the cast JAX's own scan refuses float32 manual alignments
    with pytest.raises(TypeError, match="carry"):
        jax_model.apply(variables, inputs, lengths, speaker_id=spk,
                        max_steps=steps,
                        manual_alignments=jnp.asarray(manual),
                        is_manual=jnp.asarray(True))


def test_compute_dtype_values():
    with pytest.raises(ValueError, match="float16"):
        TorchTacotron(dataclasses.replace(TorchModelConfig(),
                                          compute_dtype="float16"))
