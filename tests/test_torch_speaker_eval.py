"""The port's speaker-eval harness and alignment plots against the JAX
package's, on the CPU.

- ``acoustic_stats`` and ``_aggregate``: equal (the same numpy code).
- ``evaluate_speakers`` on a small two-speaker model (``max_iters=4``) with
  the same weights in both packages (the flax tree through
  ``params.from_flax``): the same report keys, texts, token counts, ``ok``
  flags and gates; attention floats within 5e-4 absolute (the greedy-decode
  tolerance of the model test); acoustic floats within 1e-3 relative with
  the float32 Griffin-Lim engine (``griffin_lim_impl="fft"``).  With the
  default engine on the CPU (``matmul_half``, bf16 products) 30
  momentum-0.99 iterations amplify single bf16 rounding flips, and the
  waveforms' peaks part by more than 1e-3 (the serving test bounds the
  same engines' waveforms only by a 5 % std ratio), so there the acoustic
  floats are held within 2e-2 relative.
- The CLI: ``--device cpu --random_init`` runs; without ``--device`` it
  needs a card.
- Plots: ``save_results`` and the driver's ``dump_samples`` write the PNG
  beside the ``.npy``; with matplotlib's import failing, ``plot_alignment``
  raises and both still write the wav and the ``.npy`` and log once; every
  module of the port imports without matplotlib or the Google Cloud
  client.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron_tpu.config import Config
from tacotron_tpu.synth import synthesizer as jsynth
from tacotron_tpu.tools import speaker_eval as jeval
from tacotron_tpu.utils import plot as jplot
from tacotron_tpu_torch.config import Config as TorchConfig
from tacotron_tpu_torch.data import DataFeeder
from tacotron_tpu_torch.synth import synthesizer as tsynth
from tacotron_tpu_torch.tools import speaker_eval as teval
from tacotron_tpu_torch.train.driver import dump_samples
from tacotron_tpu_torch.train.state import create_train_state
from tacotron_tpu_torch.train.step import batch_to_device
from tacotron_tpu_torch.utils import plot as tplot
from test_torch_params import SMALL, random_variables

ROOT = Path(__file__).resolve().parents[1]
AUDIO = dict(num_freq=129, sample_rate=16000, frame_shift_ms=8,
             frame_length_ms=16)
MODEL = dict(SMALL, num_mels=10, num_freq=129, reduction_factor=4,
             model_type="deepvoice", num_speakers=2, max_iters=4)
TEXTS = ["안녕하세요.", "반갑습니다 여러분"]

ATTENTION_ABS = 5e-4
ACOUSTIC_REL = 1e-3          # the float32 Griffin-Lim engine
ACOUSTIC_REL_BF16 = 2e-2     # the bf16 engine, 30 momentum iterations
#: report floats derived from the alignments (the rest are acoustic)
ATTENTION_FLOATS = {"coverage", "focus", "monotonicity", "path_coverage",
                    "mean_coverage", "mean_focus", "mean_monotonicity",
                    "mean_path_coverage", "worst_path_coverage"}


def _synthesizers(griffin_lim_impl):
    """The JAX and the port synthesizer on the same random weights."""
    cfg = Config.from_dict({"audio": dict(
        AUDIO, griffin_lim_impl=griffin_lim_impl), "model": MODEL})
    tcfg = TorchConfig.from_json(cfg.to_json())
    variables = random_variables(cfg.model, 11)
    js = jsynth.Synthesizer()
    js.config, js.model = cfg, jsynth._model_for(cfg)
    js.variables = jax.tree.map(jnp.asarray, variables)
    ts = tsynth.Synthesizer(device="cpu").load_variables(variables, tcfg)
    return js, ts


@pytest.fixture(scope="module")
def pair():
    return _synthesizers("fft")


def _assert_reports_close(got, want, key="", rel=ACOUSTIC_REL):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), key
        for k in want:
            _assert_reports_close(got[k], want[k], k, rel)
    elif isinstance(want, list):
        assert len(got) == len(want), key
        for g, w in zip(got, want):
            _assert_reports_close(g, w, key, rel)
    elif isinstance(want, float):
        assert isinstance(got, float), key
        if key in ATTENTION_FLOATS:
            assert abs(got - want) <= ATTENTION_ABS, (key, got, want)
        elif not key.startswith("attention_ok_rate") and \
                not key.startswith("worst_attention_ok_rate"):
            assert abs(got - want) <= rel * abs(want), (key, got, want)
        else:
            assert got == want, key
    else:  # ok flags, gates, texts, token counts
        assert type(got) is type(want) and got == want, key


def test_acoustic_stats_and_aggregate_match_jax():
    rng = np.random.default_rng(0)
    sr = 24000
    t = np.arange(sr) / sr
    signals = [
        np.concatenate([0.5 * np.sin(2 * np.pi * 440 * t),
                        np.zeros(sr)]).astype(np.float32),
        (0.2 * rng.standard_normal(3 * sr // 2)).astype(np.float32),
        np.zeros(8, np.float32), np.zeros(8192, np.float32),
        np.zeros(0, np.float32)]
    for wav in signals:
        for kw in ({}, {"frame": 512, "hop": 128, "silence_db": -30.0}):
            assert teval.acoustic_stats(wav, sr, **kw) == \
                jeval.acoustic_stats(wav, sr, **kw)
    utts = [{"num_tokens": n, "attention": {
        "ok": bool(n % 2), "gate": "soft_monotonic",
        "ok_sharpness": n > 3, "ok_soft_monotonic": bool(n % 2),
        "coverage": 0.1 * n, "focus": 0.3, "monotonicity": 0.9,
        "path_coverage": 0.05 * n},
        "audio": jeval.acoustic_stats(signals[n % 2], sr)}
        for n in range(1, 6)]
    assert teval._aggregate(utts) == jeval._aggregate(utts)
    assert teval._aggregate([]) == jeval._aggregate([])


def test_evaluate_speakers_matches_jax(pair, tmp_path):
    js, ts = pair
    reports, wavs = {}, {}
    for name, mod, synth in (("jax", jeval, js), ("port", teval, ts)):
        save = tmp_path / name
        reports[name] = mod.evaluate_speakers(
            synth, texts=TEXTS, speakers=[0, 1], save_dir=str(save))
        wavs[name] = sorted(os.listdir(save))
    got, want = reports["port"], reports["jax"]
    assert set(got["speakers"]) == {"0", "1"}
    assert got["cross_speaker"]["num_speakers"] == 2
    _assert_reports_close(got, want)
    assert wavs["port"] == wavs["jax"] == [
        f"spk{s}_utt{i}.wav" for s in (0, 1) for i in range(2)]
    json.dumps(got)
    # the sharpness gate, one speaker, the classic vocoder
    kw = dict(texts=TEXTS[:1], speakers=[1], max_steps=3,
              fast_vocoder=False, health_kwargs={"soft_monotonic": False})
    _assert_reports_close(teval.evaluate_speakers(ts, **kw),
                          jeval.evaluate_speakers(js, **kw))


def test_evaluate_speakers_on_the_default_engine_matches_jax():
    js, ts = _synthesizers("auto")
    kw = dict(texts=TEXTS, speakers=[0, 1])
    _assert_reports_close(teval.evaluate_speakers(ts, **kw),
                          jeval.evaluate_speakers(js, **kw),
                          rel=ACOUSTIC_REL_BF16)


def test_speaker_eval_cli_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "report.json"
    teval.main(["--device", "cpu", "--random_init", "--texts", "안녕",
                "--max_steps", "4", "--out", str(out), "--save_dir",
                str(tmp_path / "wavs")])
    report = json.loads(out.read_text())
    assert set(report["speakers"]) == {"0"}   # Config() has one speaker
    assert (tmp_path / "wavs" / "spk0_utt0.wav").is_file()
    printed = capsys.readouterr().out
    assert f"[*] wrote {out}" in printed and "speaker 0:" in printed
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            teval.main(["--random_init", "--texts", "안녕"])


def test_speaker_eval_cli_needs_weights():
    with pytest.raises(SystemExit):
        teval.main(["--device", "cpu"])


# -------------------------------------------------------------------- plots

@pytest.fixture(scope="module")
def driver_inputs(tmp_path_factory):
    """A small two-speaker train state and a test batch of the tiny
    corpus that the driver tests build."""
    from tacotron_tpu.data import build_from_path
    from test_data import _make_corpus, _tiny_config
    from test_torch_train_driver import _config

    root = tmp_path_factory.mktemp("plot_corpus")
    dirs = []
    for spk in range(2):
        meta = _make_corpus(str(root / f"spk{spk}"), seed=spk)
        build_from_path(meta, _tiny_config(), num_workers=1)
        dirs.append(str(root / f"spk{spk}" / "data"))
    _, tcfg = _config()
    state = create_train_state(tcfg, 0, "cpu")
    batch = next(DataFeeder(dirs, tcfg, data_type="test", batch_size=2,
                            n_test=2).batches())
    return state, batch_to_device(batch, "cpu"), tcfg


def _block_matplotlib(monkeypatch):
    for name in [m for m in sys.modules
                 if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)


def test_save_results_writes_the_png_beside_the_npy(pair, tmp_path):
    js, ts = pair
    kw = dict(texts=TEXTS, speaker_ids=[0, 1], max_steps=4)
    outs = {}
    for name, synth in (("jax", js), ("port", ts)):
        synth.save_results(synth.synthesize(**kw), str(tmp_path / name))
        outs[name] = sorted(os.listdir(tmp_path / name))
    assert outs["jax"] == ["synth_0.png", "synth_0.wav", "synth_1.png",
                           "synth_1.wav"]
    assert outs["port"] == sorted(outs["jax"] + ["synth_0_alignment.npy",
                                                 "synth_1_alignment.npy"])
    assert tplot._korean_font() == jplot._korean_font()


def test_dump_samples_writes_the_png(driver_inputs, tmp_path):
    state, batch, cfg = driver_inputs
    dump_samples(state, batch, cfg, 7, str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == [
        "step000000007.png", "step000000007.wav",
        "step000000007_alignment.npy"]


def test_without_matplotlib_the_png_is_skipped_and_logged_once(
        pair, driver_inputs, tmp_path, monkeypatch, capsys):
    _block_matplotlib(monkeypatch)
    with pytest.raises(ImportError, match="matplotlib"):
        tplot.plot_alignment(np.eye(3), str(tmp_path / "a.png"))

    _, ts = pair
    res = ts.synthesize(texts=TEXTS, speaker_ids=[0, 1], max_steps=4)
    capsys.readouterr()
    paths = ts.save_results(res, str(tmp_path / "synth"))
    assert sorted(os.listdir(tmp_path / "synth")) == [
        "synth_0.wav", "synth_0_alignment.npy", "synth_1.wav",
        "synth_1_alignment.npy"]
    assert len(paths) == 2
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "skipped" in ln]
    assert len(lines) == 1 and "synth_0.png" in lines[0] and \
        "matplotlib" in lines[0]

    state, batch, cfg = driver_inputs
    dump_samples(state, batch, cfg, 3, str(tmp_path / "samples"))
    assert sorted(os.listdir(tmp_path / "samples")) == [
        "step000000003.wav", "step000000003_alignment.npy"]
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "skipped" in ln]
    assert len(lines) == 1 and "step000000003.png" in lines[0]


IMPORT_WITHOUT_OPTIONAL = r"""
import importlib, pkgutil, sys


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("matplotlib", "google"):
            raise ModuleNotFoundError(f"No module named {name!r}")


sys.meta_path.insert(0, Block())
import numpy as np
import tacotron_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    tacotron_tpu_torch.__path__, "tacotron_tpu_torch.")
    if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
from tacotron_tpu_torch.tools import asr
from tacotron_tpu_torch.utils import plot
try:
    plot.plot_alignment(np.eye(2), "x.png")
except ImportError as e:
    assert "matplotlib" in str(e), e
else:
    raise AssertionError("plot_alignment ran without matplotlib")
try:
    asr._default_recognize(np.zeros(4), "ko-KR")
except RuntimeError as e:
    assert "google-cloud-speech" in str(e), e
else:
    raise AssertionError("ASR ran without the client")
print(len(names))
"""


def test_every_module_imports_without_matplotlib_or_google_cloud(tmp_path):
    proc = subprocess.run([sys.executable, "-c", IMPORT_WITHOUT_OPTIONAL],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 65
