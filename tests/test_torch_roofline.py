"""The port's train-step roofline (``train/roofline.py``) and width scaling
(``config.py::scale_model_widths``) against the JAX package's.

- ``forward_flops`` (every component), ``sequential_scan_steps`` and
  ``train_step_model`` (FLOPs, parameter count from the port's model, bytes,
  sequential iterations) equal JAX's for ``Config()`` and a scaled config,
  at two shapes;
- ``scale_model_widths`` and ``ModelConfig.scaled`` mirror
  ``tests/test_config.py``: widths divide, structure and output widths stay,
  factor 0 raises, the scaled model runs a forward;
- ``mfu`` divides by the named H100 float32 peak.
"""

import dataclasses

import pytest
import torch

from tacotron_tpu.config import Config
from tacotron_tpu.config import scale_model_widths as jax_scale
from tacotron_tpu.train import roofline as jax_roofline
from tacotron_tpu_torch.config import Config as TorchConfig
from tacotron_tpu_torch.config import ModelConfig, scale_model_widths
from tacotron_tpu_torch.train import roofline


def _pair(factor: int, **model):
    cfg = Config()
    cfg = cfg.replace(model=dataclasses.replace(
        jax_scale(cfg.model, factor), **model))
    return cfg, TorchConfig.from_json(cfg.to_json())


@pytest.mark.parametrize("factor", [1, 4])
def test_roofline_matches_jax(factor):
    # the JAX model counts its parameters from a single-speaker init, so
    # the whole-step model is compared on Config(); the FLOP model also on
    # Deep Voice 2 with two speakers and on 'simple'
    for model in ({}, dict(model_type="deepvoice", num_speakers=2),
                  dict(model_type="simple", num_speakers=3)):
        cfg, tcfg = _pair(factor, **model)
        for batch, t_in, t_out in ((16, 64, 400), (3, 17, 90)):
            assert roofline.forward_flops(tcfg, batch, t_in, t_out) == \
                jax_roofline.forward_flops(cfg, batch, t_in, t_out)
            assert roofline.sequential_scan_steps(tcfg, t_in, t_out) == \
                jax_roofline.sequential_scan_steps(cfg, t_in, t_out)
    cfg, tcfg = _pair(factor)
    got = roofline.train_step_model(tcfg, 16, 64, 400)
    want = jax_roofline.train_step_model(cfg, 16, 64, 400)
    assert got == want


def test_scale_model_widths_mirrors_jax():
    base = ModelConfig()
    assert scale_model_widths(base, 1) == base
    s = scale_model_widths(base, 4)
    assert s.embedding_size == 64
    assert s.enc_prenet_sizes == (64, 32)
    assert s.dec_rnn_size == 64
    assert s.post_proj_sizes == (64, 80)   # last stays num_mels
    assert s.num_mels == base.num_mels and s.num_freq == base.num_freq
    assert s.enc_bank_size == base.enc_bank_size
    assert s.reduction_factor == base.reduction_factor
    with pytest.raises(ValueError):
        scale_model_widths(base, 0)
    assert base.scaled(4) == s
    for factor in (2, 3, 8):
        # the port's Tacotron fields as its config JSON holds them (without
        # the architecture and Tacotron 2 fields, which JAX has not)
        got = TorchConfig(model=scale_model_widths(base, factor)).as_dict()
        assert got["model"] == \
            dataclasses.asdict(jax_scale(Config().model, factor))

    from tacotron_tpu_torch.models.tacotron import Tacotron
    model = Tacotron(s).eval()
    with torch.no_grad():
        out = model(torch.zeros((1, 8), dtype=torch.int64),
                    torch.full((1,), 8), max_steps=2)
    assert out["linear_outputs"].shape == (1, 2 * s.reduction_factor,
                                           s.num_freq)


def test_mfu_uses_h100_peaks():
    assert roofline.H100_FP32_PEAK_TFLOPS == 67.0
    assert roofline.H100_HBM_GB_S == 3350.0
    assert roofline.mfu(67e12, 1.0) == pytest.approx(100.0)
    assert roofline.mfu(6.7e12, 2.0) == pytest.approx(5.0)
    assert roofline.mfu(1e12, 1.0, peak_tflops=100.0) == pytest.approx(1.0)
