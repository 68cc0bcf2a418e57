"""The port's studies (``tacotron_tpu_torch/studies/``) against the repo's
scripts (``scripts/make_synthetic_corpus.py``, ``convergence_study.py``,
``mulaw_quality.py``), imported by path and left as they are, on the CPU.

- The corpus: ``main`` of both versions writes byte-equal files (wavs,
  ``metadata.csv``, ``config.json``, ``heldout.json``) for ``melody``,
  ``melody_var`` and ``sine`` at a few utterances, each run from its own
  working directory with the same relative output path (the metadata
  holds the paths); the built ``.npz`` files are array-equal.
- ``sentence_pool``, ``TEXTS``, ``token_frequency``,
  ``token_duration_steps``, ``token_slot_bounds``, ``speaker_band_hz`` and
  ``melody_wav`` equal the script's (exactly: the same numpy code).
- The instruments on the same seeded waveforms fed to both:
  ``dominant_hz``, ``token_tone_accuracy`` (a clean melody, a noisy one,
  one with tones shifted by a few bins, one cut short so slots fall past
  its end), ``log_spectral_distance`` (floored and unfloored) and
  ``snr_db``: equal results.
- The ground-truth melody of every held-out sentence scores accuracy 1.0
  and a wrong-token rate of 0 for both speakers, in both melody styles.
- The study end to end with ``--device cpu``: two training steps at small
  widths, then a second call with the same ``--work`` that resumes from
  the first call's checkpoint; the report holds every key of the script's
  report; ``loss_curve.json`` holds a run's (step, loss) pairs, and the
  PNG is skipped and logged without matplotlib; ``mulaw_quality`` on the
  trained run gives the script's report keys.
"""

import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

from tacotron_tpu.config import load_config as jax_load_config
from tacotron_tpu.data import build_from_path as jax_build_from_path
from tacotron_tpu_torch.config import load_config, scale_model_widths
from tacotron_tpu_torch.data.builder import build_from_path
from tacotron_tpu_torch.studies import convergence_study as tstudy
from tacotron_tpu_torch.studies import make_synthetic_corpus as tcorpus
from tacotron_tpu_torch.studies import mulaw_quality as tmulaw
from tacotron_tpu_torch.text import text_to_sequence

ROOT = Path(__file__).resolve().parents[1]
SR = 24000


def _script(name):
    """A script of ``scripts/`` as a module, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"script_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jcorpus = _script("make_synthetic_corpus")
jstudy = _script("convergence_study")
jmulaw = _script("mulaw_quality")

#: the keys of the script's convergence_report.json
REPORT_KEYS = {"steps", "train_seconds", "attention_type", "corpus_style",
               "config", "heldout_texts", "speaker_eval", "dominant_f0",
               "token_tone_accuracy", "device"}
CONFIG_KEYS = {"batch_size", "compute_dtype", "on_device_features",
               "guided_attention_weight", "guided_attention_decay_steps",
               "device_resident_corpus", "schedule"}
TONE_KEYS = {"mean_accuracy", "min_accuracy", "mean_accuracy_tol",
             "wrong_token_rate", "n_segments", "measured_fraction",
             "per_utterance", "per_utterance_tol"}
#: the keys of the script's mulaw report
MULAW_KEYS = {"n_utterances", "lsd_db_mean", "lsd_db_max", "lsd_floor_db",
              "lsd_db_mean_unfloored", "snr_db_mean", "snr_db_min", "note"}


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("style", ["melody", "melody_var", "sine"])
def test_corpus_byte_equal(style, tmp_path, monkeypatch):
    args = ["corpus", "--style", style, "--utterances", "3",
            "--store_waveform"]
    for who in ("jax", "torch"):
        (tmp_path / who).mkdir()
        monkeypatch.chdir(tmp_path / who)
        if who == "jax":
            monkeypatch.setattr(sys, "argv", ["make_synthetic_corpus.py"]
                                + args)
            jcorpus.main()
        else:
            tcorpus.main(args)
    want, got = (_files(tmp_path / w / "corpus") for w in ("jax", "torch"))
    names = {"config.json", "spk0/metadata.csv", "spk1/metadata.csv",
             "spk0/utt000.wav", "spk1/utt002.wav"}
    if style != "sine":
        names.add("heldout.json")
    assert names <= set(want)
    assert sorted(got) == sorted(want)
    for name, data in want.items():
        assert got[name] == data, name

    # the built corpus: the same arrays from both builders
    for spk in ("spk0", "spk1"):
        monkeypatch.chdir(tmp_path / "jax")
        jax_build_from_path(f"corpus/{spk}/metadata.csv",
                            jax_load_config("corpus/config.json"),
                            num_workers=1)
        monkeypatch.chdir(tmp_path / "torch")
        build_from_path(f"corpus/{spk}/metadata.csv",
                        load_config("corpus/config.json"), num_workers=1)
        jdir, tdir = (tmp_path / w / "corpus" / spk / "data"
                      for w in ("jax", "torch"))
        assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
        assert len(os.listdir(jdir)) == 3
        for name in os.listdir(jdir):
            with np.load(jdir / name) as a, np.load(tdir / name) as b:
                assert sorted(a.files) == sorted(b.files)
                assert "wav" in a.files
                for key in a.files:
                    np.testing.assert_array_equal(b[key], a[key],
                                                  err_msg=f"{name}/{key}")


def test_melody_functions_equal():
    assert tcorpus.TEXTS == jcorpus.TEXTS
    assert tcorpus.sentence_pool() == jcorpus.sentence_pool()
    assert tcorpus.sentence_pool(3) == jcorpus.sentence_pool(3)
    for name in ("TOKEN_SECONDS", "TONES_PER_SPEAKER", "VAR_MIN_STEPS",
                 "VAR_MAX_STEPS", "_BAND_ORIGIN_BIN", "_BAND_STRIDE_BIN",
                 "_TONE_STRIDE_BIN", "_SPACE_ID"):
        assert getattr(tcorpus, name) == getattr(jcorpus, name), name
    for tok in range(80):
        assert tcorpus.token_duration_steps(tok) == \
            jcorpus.token_duration_steps(tok)
        for spk in (0, 1, 2):
            assert tcorpus.token_frequency(tok, spk) == \
                jcorpus.token_frequency(tok, spk)
            assert tcorpus.token_frequency(tok, spk, 16000) == \
                jcorpus.token_frequency(tok, spk, 16000)
    for spk in (0, 1):
        assert tcorpus.speaker_band_hz(spk) == jcorpus.speaker_band_hz(spk)
        tones = tcorpus.speaker_tones(spk)
        assert (tones[0], tones[-1]) == jcorpus.speaker_band_hz(spk)
    for text in tcorpus.sentence_pool()[-8:] + tcorpus.TEXTS[:2]:
        tokens = text_to_sequence(text, ["korean_cleaners"])
        for var in (False, True):
            assert tcorpus.token_slot_bounds(tokens, SR, var) == \
                jcorpus.token_slot_bounds(tokens, SR, var)
            for spk in (0, 1):
                np.testing.assert_array_equal(
                    tcorpus.melody_wav(tokens, spk, SR, variable_rate=var),
                    jcorpus.melody_wav(tokens, spk, SR, variable_rate=var))


def _test_waves(text, spk, var, rng):
    """Seeded waveforms for one sentence: clean, noisy, tones shifted by a
    few bins in every other slot, and cut short."""
    tokens = text_to_sequence(text, ["korean_cleaners"])
    clean = tcorpus.melody_wav(tokens, spk, SR, variable_rate=var)
    noisy = clean + 0.3 * rng.standard_normal(clean.shape).astype(np.float32)
    shifted = clean.copy()
    bin_hz = SR / 2048.0
    for i, (lo, hi) in enumerate(tcorpus.token_slot_bounds(tokens, SR, var)):
        if i % 2:
            t = np.arange(hi - lo) / SR
            shifted[lo:hi] = 0.4 * np.sin(
                2 * np.pi * (300 + bin_hz * (i % 9)) * t)
    return {"clean": clean, "noisy": noisy, "shifted": shifted,
            "short": noisy[:len(noisy) // 2]}


@pytest.mark.parametrize("var", [False, True], ids=["melody", "melody_var"])
def test_instruments_equal_on_the_same_waveforms(var):
    rng = np.random.default_rng(5)
    texts = tcorpus.sentence_pool()[-3:]
    for k, text in enumerate(texts):
        spk = k % 2
        for name, wav in _test_waves(text, spk, var, rng).items():
            assert tstudy.dominant_hz(wav, SR) == jstudy.dominant_hz(wav, SR)
            got = tstudy.token_tone_accuracy(wav, text, spk, SR,
                                             variable_rate=var)
            want = jstudy.token_tone_accuracy(wav, text, spk, SR,
                                              variable_rate=var)
            assert got == want, (text, name)
            if name == "short":
                assert got["measured_fraction"] < 1.0
                assert got["wrong_token_rate"] > 0.0
            if name == "shifted":
                assert 0.0 < got["accuracy"] < 1.0
    assert tstudy.dominant_hz(np.zeros(100), SR) == 0.0


def test_lsd_and_snr_equal_on_the_same_waveforms():
    rng = np.random.default_rng(9)
    for n in (3000, 24000):
        a = rng.standard_normal(n).astype(np.float32)
        b = (a + 0.05 * rng.standard_normal(n)).astype(np.float32)
        for x, y in ((a, b), (a, b[:n - 500]), (a, a)):
            for floor in (-60.0, -40.0, None):
                assert tmulaw.log_spectral_distance(x, y, floor_db=floor) \
                    == jmulaw.log_spectral_distance(x, y, floor_db=floor)
            assert tmulaw.log_spectral_distance(x, y, n_fft=512, hop=128) \
                == jmulaw.log_spectral_distance(x, y, n_fft=512, hop=128)
            assert tmulaw.snr_db(x, y) == jmulaw.snr_db(x, y)
    assert tmulaw.snr_db(a, a) == pytest.approx(10 * np.log10(
        (a.astype(np.float64) ** 2).sum() / 1e-20))


@pytest.mark.parametrize("var", [False, True], ids=["melody", "melody_var"])
def test_ground_truth_melody_scores_one(var):
    for text in tcorpus.sentence_pool()[-8:]:
        tokens = text_to_sequence(text, ["korean_cleaners"])
        for spk in (0, 1):
            wav = tcorpus.melody_wav(tokens, spk, SR, variable_rate=var)
            acc = tstudy.token_tone_accuracy(wav, text, spk, SR,
                                             variable_rate=var)
            assert acc["accuracy"] == 1.0 and acc["accuracy_tol"] == 1.0
            assert acc["wrong_token_rate"] == 0.0
            assert acc["measured_fraction"] == 1.0
            assert acc["n_segments"] > 10


STUDY_CONFIG = tstudy.study_config


def _small_study_config(*args, **kwargs):
    """The study's config at small widths and a short decode, with two
    Griffin-Lim iterations."""
    import dataclasses
    cfg = STUDY_CONFIG(*args, **kwargs)
    model = dataclasses.replace(scale_model_widths(cfg.model, 16),
                                post_proj_sizes=(16, 80), max_iters=8)
    return cfg.replace(model=model, audio=dataclasses.replace(
        cfg.audio, griffin_lim_iters=2))


def test_study_end_to_end_on_the_cpu(tmp_path, monkeypatch, capsys):
    from tacotron_tpu_torch.synth import Synthesizer
    from tacotron_tpu_torch.train.checkpoint import checkpoint_steps
    from tacotron_tpu_torch.utils import MetricsLogger, read_metrics

    monkeypatch.setattr(tstudy, "study_config", _small_study_config)
    monkeypatch.setattr(Synthesizer, "FAST_GRIFFIN_LIM_ITERS", 2)
    work = str(tmp_path / "work")
    common = ["--work", work, "--batch_size", "2", "--utterances", "6",
              "--dump_every", "2", "--device", "cpu"]
    first = tstudy.main(common + ["--steps", "2"])
    assert first["steps"] == 2
    second = tstudy.main(common + ["--steps", "3"])
    run = os.path.join(work, "run")
    with open(os.path.join(run, "train.log"), encoding="utf-8") as fh:
        assert f"resumed from {run} at step 2" in fh.read()
    assert checkpoint_steps(run) == [2, 3]
    # evals every --dump_every steps, over both calls
    recs = read_metrics(os.path.join(run, "metrics.jsonl"), "eval")
    assert [r["step"] for r in recs] == [2]

    art = os.path.join(work, "artifacts")
    with open(os.path.join(art, "convergence_report.json"),
              encoding="utf-8") as fh:
        report = json.load(fh)
    assert set(report) == REPORT_KEYS and report == json.loads(
        json.dumps(second, ensure_ascii=False))
    assert report["steps"] == 3 and report["device"] == "cpu"
    assert set(report["config"]) == CONFIG_KEYS
    assert report["config"]["compute_dtype"] == "bfloat16"
    assert report["config"]["device_resident_corpus"] is True
    assert report["heldout_texts"] == tcorpus.sentence_pool()[-8:]
    assert set(report["speaker_eval"]["speakers"]) == {"0", "1"}
    for spk in ("0", "1"):
        assert set(report["token_tone_accuracy"][spk]) == TONE_KEYS
        assert len(report["dominant_f0"][spk]["peaks_hz"]) == 8
    # the driver logs a train record every 25 steps: none in 3
    with open(os.path.join(art, "loss_curve.json")) as fh:
        assert json.load(fh) == []
    assert os.path.exists(os.path.join(art, "loss_curve.png"))
    with open(os.path.join(art, "CONVERGENCE.md"), encoding="utf-8") as fh:
        md = fh.read()
    assert "Trained **3 steps" in md and "device: cpu" in md
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1])["tone_accuracy"]

    # the loss curve of a metrics file, with and without matplotlib: the
    # pairs are always written, the PNG where matplotlib imports
    metrics = str(tmp_path / "metrics.jsonl")
    logger = MetricsLogger(metrics)
    for step, loss in ((25, 0.9), (50, 0.5), (75, 0.25)):
        logger.write(step, {"loss": loss})
    logger.write(50, {"loss": 0.7}, kind="eval")
    logger.close()
    for has_matplotlib in (True, False):
        if not has_matplotlib:
            monkeypatch.setitem(sys.modules, "matplotlib", None)
        png = tmp_path / f"curve{has_matplotlib}" / "loss_curve.png"
        png.parent.mkdir()
        curve = tstudy.plot_loss_curve(metrics, str(png))
        assert curve == [(25, 0.9), (50, 0.5), (75, 0.25)]
        assert png.exists() == has_matplotlib
        with open(png.parent / "loss_curve.json") as fh:
            assert json.load(fh) == [list(p) for p in curve]
    assert "loss curve PNG" in capsys.readouterr().out

    # the mu-law check on the trained run
    out_json = str(tmp_path / "mulaw.json")
    mu = tmulaw.main(["--load_path", run, "--texts_json",
                      os.path.join(work, "corpus", "heldout.json"),
                      "--out", out_json, "--device", "cpu"])
    with open(out_json) as fh:
        assert json.load(fh) == mu
    assert set(mu) == MULAW_KEYS and mu["n_utterances"] == 8
    assert np.isfinite([mu["lsd_db_mean"], mu["snr_db_mean"]]).all()
