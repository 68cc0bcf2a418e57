"""The serving slice as a whole: the port's ``Synthesizer.synthesize``
against the JAX ``Synthesizer.synthesize`` on the CPU, same weights, same
texts, through the fused Griffin-Lim engine, through matmul_half with the
overlap-add, through the "pallas" engine (the spectral step) and through the
dense and split matrix engines.

Tolerances: equal frame ends; alignments 5e-4 (the greedy-decode tolerance
of the model test); waveforms correlated above 0.999 with a std ratio in
[0.95, 1.05] (int16 quantization of both and bf16 Griffin-Lim)."""

import subprocess
import sys
import wave
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron_tpu.config import Config
from tacotron_tpu.synth import synthesizer as jsynth
from tacotron_tpu_torch.config import Config as TorchConfig
from tacotron_tpu_torch.synth import synthesizer as tsynth
from test_torch_params import SMALL, random_variables

AUDIO = dict(num_freq=129, sample_rate=16000, frame_shift_ms=8,
             frame_length_ms=16, griffin_lim_iters=3)
MODEL = dict(SMALL, num_mels=10, num_freq=129, reduction_factor=4,
             model_type="deepvoice", num_speakers=2)
TEXTS = ["안녕하세요.", "반갑습니다 여러분", "음성 합성"]


def _configs(**audio):
    raw = {"audio": dict(AUDIO, **audio), "model": MODEL}
    cfg = Config.from_dict(raw)
    return cfg, TorchConfig.from_json(cfg.to_json())


@pytest.fixture(scope="module")
def variables():
    cfg, _ = _configs()
    return random_variables(cfg.model, 5)


def _pair(variables, **audio):
    cfg, tcfg = _configs(**audio)
    js = jsynth.Synthesizer()
    js.config, js.model = cfg, jsynth._model_for(cfg)
    js.variables = jax.tree.map(jnp.asarray, variables)
    ts = tsynth.Synthesizer(device="cpu").load_variables(variables, tcfg)
    return js, ts


@pytest.mark.parametrize("engine,wire,manual", [
    ("fused", "int16", False), ("matmul_half", "int16", False),
    ("matmul_half", "mulaw8", False), ("matmul_half", "int16", True),
    ("pallas", "int16", False), ("matmul_split", "int16", False),
    ("matmul_bf16", "int16", False)])
def test_synthesize_matches_jax(variables, engine, wire, manual):
    js, ts = _pair(variables, griffin_lim_impl=engine)
    kw = dict(texts=TEXTS, speaker_ids=[0, 1, 1], max_steps=4,
              librosa_trim=False, wire_format=wire)
    if manual:   # [N, T_in, T_dec] alignments given by the caller
        kw["manual_alignments"] = np.random.default_rng(2).dirichlet(
            np.ones(4), (3, 11)).astype(np.float32)
    want = js.synthesize(**kw)
    got = ts.synthesize(**kw)
    hop = ts.config.audio.hop_length
    assert len(got["wavs"]) == len(want["wavs"]) == 3
    for i, (wa, wb) in enumerate(zip(want["wavs"], got["wavs"])):
        assert wb.shape == wa.shape == (got["ends"][i] * hop,)
        assert wb.dtype == np.float32
        assert np.corrcoef(wa, wb)[0, 1] > 0.999
        assert 0.95 <= wb.std() / wa.std() <= 1.05
    for aa, ab in zip(want["alignments"], got["alignments"]):
        np.testing.assert_allclose(ab, aa, atol=5e-4)
    assert got["sequences"][0].tolist() == want["sequences"][0].tolist()


def test_attention_trim_frames_matches_jax():
    rng = np.random.default_rng(0)
    al = rng.random((4, 9, 12)).astype(np.float32)
    al[1, :, 6:] = 0.0
    al[1, 8, 6:] = 1.0           # reaches the last token halfway
    lengths = np.asarray([9, 9, 5, 1], np.int32)
    want = jsynth.attention_trim_frames(jnp.asarray(al),
                                        jnp.asarray(lengths), 4)
    got = tsynth.attention_trim_frames(torch.from_numpy(al),
                                       torch.from_numpy(lengths).long(), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_helpers_match_jax():
    for n in (1, 5, 12, 13, 30, 49, 50, 80):
        assert tsynth.adaptive_max_steps(n, 30, 200) == \
            jsynth.adaptive_max_steps(n, 30, 200)
    x = np.linspace(-1.2, 1.2, 101).astype(np.float32)
    np.testing.assert_array_equal(
        tsynth.mulaw_encode(torch.from_numpy(x)).numpy(),
        np.asarray(jsynth.mulaw_encode(jnp.asarray(x))))
    codes = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(tsynth.mulaw_decode(codes),
                                  jsynth.mulaw_decode(codes))
    audio = np.concatenate([np.random.default_rng(1).standard_normal(9000),
                            np.zeros(8000)]).astype(np.float32)
    np.testing.assert_array_equal(tsynth.trim_silence_db(audio),
                                  jsynth.trim_silence_db(audio))


def test_device_resolution():
    """No device means the card: without CUDA that raises instead of
    falling back to the CPU; the CPU runs when asked for."""
    if torch.cuda.is_available():
        assert tsynth.Synthesizer().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tsynth.Synthesizer()
    assert tsynth.Synthesizer(device="cpu").device.type == "cpu"


def test_unknown_wire_format_raises(variables):
    """(``vocode="host"``/``"none"`` and ``manual_attention_mode`` are held
    against JAX in ``test_torch_synth_features.py``.)"""
    _, ts = _pair(variables)
    with pytest.raises(ValueError, match="wire_format"):
        ts.synthesize(texts=TEXTS[:1], max_steps=2, wire_format="bogus")


def test_cli_and_save_results(tmp_path):
    """``python -m tacotron_tpu_torch.synth --device cpu`` writes wavs at
    the configured rate, from random weights and from a flat npz."""
    from tacotron_tpu_torch import params as P
    from tacotron_tpu_torch.config import save_config
    from tacotron_tpu_torch.synth import Synthesizer

    _, tcfg = _configs()
    cfg_path = str(tmp_path / "config.json")
    save_config(tcfg, cfg_path)
    npz = str(tmp_path / "w.npz")
    P.save_npz(npz, Synthesizer(device="cpu").init_random(tcfg, 1)
               .model.state_dict())
    for weights in (["--random_init"], ["--load_npz", npz]):
        out = tmp_path / weights[0].strip("-")
        proc = subprocess.run(
            [sys.executable, "-m", "tacotron_tpu_torch.synth", *weights,
             "--device", "cpu", "--config", cfg_path, "--max_steps", "3",
             "--speaker_id", "1", "--sample_path", str(out), "안녕"],
            capture_output=True, text=True, timeout=300,
            cwd=Path(__file__).resolve().parents[1])
        assert proc.returncode == 0, proc.stderr
        with wave.open(str(out / "synth_0.wav")) as fh:
            assert fh.getframerate() == 16000 and fh.getnframes() > 0
        assert (out / "synth_0_alignment.npy").exists()
