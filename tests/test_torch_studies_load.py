"""The port's serving and training studies (``studies/serving_load.py``,
``synth_sweep.py``, ``bf16_study.py``, ``batch_study.py``) against the
repo's scripts of the same names, imported by path and left as they are,
on the CPU at small widths.

- ``serving_load``: the script's ``run_load_test`` and the port's, each
  driving the port's ``app.SynthWorker`` and handler on a real CPU
  synthesizer (the script imports ``app``, given the port's module here):
  the same row keys (the port adds its launch and replay counts), no
  coalescing at level 1 or with ``max_batch=1``, coalescing at level 4;
  then the port's CLI, prewarmed (every call replays) and eager.
- ``synth_sweep``: a point of each engine on the same weights as the
  script's compiled program; the spectral convergence within twice JAX's
  own jit-against-eager spread over those points at this size
  (``SWEEP_SPREAD``; ``python tests/test_torch_studies_load.py``
  re-measures it); the CLI.
- ``bf16_study``: ``study_config`` equal to the script's field for field
  for both dtypes; ``build_corpus`` writing byte-equal files at 4
  utterances a speaker; the script's ``main`` and the port's, fed the same
  canned train records, writing the same report apart from the device
  line; the CLI at small widths, both arms for 10 steps.
- ``batch_study``: the script's report and the port's ``report`` on the
  same canned curves, equal apart from the device line, in each branch of
  the conclusion; the CLI at small widths, four arms of 10 steps.
"""

import dataclasses
import importlib.util
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tacotron_tpu
from tacotron_tpu.config import Config as JaxConfig
from tacotron_tpu.dsp import chip as jchip
from tacotron_tpu.dsp import host as jhost
from tacotron_tpu.synth import synthesizer as jsynth
from tacotron_tpu_torch import app as tapp
from tacotron_tpu_torch.config import (AudioConfig, Config, ModelConfig,
                                       scale_model_widths)
from tacotron_tpu_torch.studies import batch_study as tbatch
from tacotron_tpu_torch.studies import bf16_study as tbf16
from tacotron_tpu_torch.studies import serving_load as tload
from tacotron_tpu_torch.studies import synth_sweep as tsweep
from tacotron_tpu_torch.synth import Synthesizer
from test_torch_params import SMALL, random_variables

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: these small models gain nothing from more, and
    beside the other test processes a pool per process oversubscribes the
    cores (the server test ran 10x slower so)."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _script(name):
    """A script of ``scripts/`` as a module, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"script_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jload = _script("serving_load")
jsweep = _script("synth_sweep")
jbf16 = _script("bf16_study")
jbatch = _script("batch_study")

#: the keys of a row of the script's serving report
LOAD_ROW_KEYS = {"concurrency", "requests", "p50_ms", "p95_ms", "mean_ms",
                 "throughput_rps", "batched_calls", "max_batch"}
#: JAX's jit-against-eager spread of ``spectral_convergence`` at this
#: test's size (``SWEEP_AUDIO``, ``SWEEP_MODEL``, batch 2, 8 steps): the
#: largest over the four points, (``matmul_bf16``, 30, 0.99), which reads
#: 2.00882 compiled and 2.01071 eagerly; the others 9.1e-4, 1.2e-4, 1.6e-4
SWEEP_SPREAD = 1.9e-3
SWEEP_AUDIO = dict(num_freq=129, sample_rate=16000, frame_shift_ms=8,
                   frame_length_ms=16)
SWEEP_MODEL = dict(SMALL, num_mels=10, num_freq=129, reduction_factor=4)
SWEEP_B, SWEEP_STEPS = 2, 8


# ------------------------------------------------------------ serving load

def _load_config():
    """A 2-speaker model at small widths and a 30-step budget, 16 kHz."""
    cfg = Config(
        audio=AudioConfig(num_freq=129, sample_rate=16000, frame_shift_ms=8,
                          frame_length_ms=16, griffin_lim_iters=3),
        model=ModelConfig(**dict(SMALL, num_mels=10, num_freq=129,
                                 reduction_factor=4, model_type="deepvoice",
                                 num_speakers=2, max_iters=30)))
    return cfg.replace(data=dataclasses.replace(cfg.data, min_iters=1))


def test_serving_load_rows_match_the_script(monkeypatch):
    monkeypatch.setitem(sys.modules, "app", tapp)
    kw = dict(levels=(1, 4), requests_per_level=8, max_batches=(4, 1),
              prewarm=False)
    want = jload.run_load_test(
        Synthesizer(device="cpu").init_random(_load_config(), seed=1), **kw)
    got = tload.run_load_test(
        Synthesizer(device="cpu").init_random(_load_config(), seed=1), **kw)
    extra = {"k1_launches", "k2_launches", "k3_launches", "replays"}
    assert len(got["levels"]) == len(want["levels"]) == 4
    for g, w in zip(got["levels"], want["levels"]):
        assert set(w) == LOAD_ROW_KEYS and set(g) == LOAD_ROW_KEYS | extra
        for key in ("concurrency", "requests", "max_batch"):
            assert g[key] == w[key]
        assert g["p50_ms"] > 0 and g["throughput_rps"] > 0
        # eager calls on the CPU: the plain versions, no graph
        assert (g["k1_launches"] == g["k2_launches"] == g["k3_launches"]
                == g["replays"] == 0)
        if g["concurrency"] == 1 or g["max_batch"] == 1:
            assert g["batched_calls"] == w["batched_calls"] == 0
        else:   # four clients at once: the queue coalesces
            assert g["batched_calls"] >= 1 and w["batched_calls"] >= 1


def test_serving_load_cli(monkeypatch, tmp_path):
    monkeypatch.setattr(tload, "Config", _load_config)
    out = tmp_path / "load.json"
    args = ["--levels", "1,2", "--requests_per_level", "2", "--device",
            "cpu"]
    warm = tload.main(args + ["--out", str(out)])
    with open(out, encoding="utf-8") as fh:
        assert json.load(fh) == json.loads(json.dumps(warm))
    assert warm["device"] == "cpu" and warm["prewarm"] is True
    assert warm["model"] == "random_init"
    # prewarmed: every call replays a captured program (one call a
    # request at max_batch 1)
    assert [r["max_batch"] for r in warm["levels"]] == [4, 4, 1, 1]
    for row in warm["levels"]:
        assert row["replays"] >= 1
    assert warm["levels"][2]["replays"] == 2
    eager = tload.main(args + ["--no_prewarm"])
    assert eager["prewarm"] is False
    assert all(r["replays"] == 0 for r in eager["levels"])


# ------------------------------------------------------------ synth sweep

def _sweep_pair():
    cfg = JaxConfig.from_dict({"audio": SWEEP_AUDIO, "model": SWEEP_MODEL})
    variables = random_variables(cfg.model, 5)
    synth = Synthesizer(device="cpu").load_variables(
        variables, Config.from_json(cfg.to_json()))
    return cfg, jax.tree.map(jnp.asarray, variables), synth


def _jax_point(cfg, variables, inp, lens, impl, iters, momentum,
               compiled=True):
    """The script's point at this size: its ``full`` program (compiled, or
    eagerly) and its spectral convergence of utterance 0."""
    model = jsynth._model_for(cfg)
    acfg = dataclasses.replace(cfg.audio, griffin_lim_impl=impl,
                               griffin_lim_iters=iters,
                               griffin_lim_momentum=momentum)
    spec0 = np.asarray(model.apply(variables, inp, lens, train=False,
                                   max_steps=SWEEP_STEPS)[
        "linear_outputs"])[0]

    def full(variables, inp, lens):
        out = model.apply(variables, inp, lens, train=False,
                          max_steps=SWEEP_STEPS)
        wavs = jchip.batched_linear_to_waveform(out["linear_outputs"], acfg)
        return wavs, jnp.sum(jnp.abs(wavs))

    if compiled:
        wavs = np.asarray(jax.jit(full)(variables, inp, lens)[0])
    else:
        with jax.disable_jit():
            wavs = np.asarray(full(variables, inp, lens)[0])
    S = np.asarray(jchip.db_to_amp(
        jchip.denormalize_db(jnp.asarray(spec0), acfg)
        + acfg.ref_level_db)) ** acfg.power
    est = np.abs(jhost.stft(wavs[0], acfg)).T
    n = min(len(est), len(S))
    return float(np.linalg.norm(est[:n] - S[:n]) / np.linalg.norm(S[:n]))


@pytest.mark.parametrize("impl,iters,momentum", tsweep.POINTS[1:3])
def test_sweep_point_matches_the_script(impl, iters, momentum):
    """One point an engine (the momentum point of ``matmul_bf16``, whose
    JAX spread is the largest, and the plain point of ``pallas``)."""
    cfg, variables, synth = _sweep_pair()
    inp, lens = tsweep.make_inputs(synth, SWEEP_B)
    want = _jax_point(cfg, variables, jnp.asarray(inp.numpy(), jnp.int32),
                      jnp.asarray(lens.numpy(), jnp.int32), impl, iters,
                      momentum)
    import torch
    with torch.no_grad():
        spec0 = synth.model(inp, lens, max_steps=SWEEP_STEPS)[
            "linear_outputs"][0].numpy()
    got = tsweep.sweep_point(synth, inp, lens, spec0, impl, iters, momentum,
                             max_steps=SWEEP_STEPS, reps=1, warmup=0)
    assert set(got) >= {"batch", "impl", "iters", "momentum",
                        "batch_seconds", "audio_s_per_s",
                        "spectral_convergence"}
    assert (got["batch"], got["impl"], got["iters"], got["momentum"]) == \
        (SWEEP_B, impl, iters, momentum)
    assert got["k2_launches"] == got["k3_launches"] == 0   # CPU: plain
    assert abs(got["spectral_convergence"] - want) <= 2 * SWEEP_SPREAD


def test_sweep_texts_points_and_cli(monkeypatch, capsys, tmp_path):
    """The texts, points, batch sizes, decode steps and bucket are the
    script's; the CLI prints and writes one JSON line a point."""
    import inspect
    source = inspect.getsource(jsweep.main)
    for text in tsweep.TEXTS:
        assert f'"{text}"' in source
    for impl, iters, momentum in tsweep.POINTS:
        assert f'("{impl}", {iters}, {momentum})' in source
    assert "for B in (16, 32, 64)" in source and tsweep.BATCHES == (
        16, 32, 64)
    assert "MAX_STEPS = 50" in source and tsweep.MAX_STEPS == 50
    assert "bucket = 64" in source and tsweep.BUCKET == 64

    def small():
        return Config.from_json(JaxConfig.from_dict(
            {"audio": SWEEP_AUDIO, "model": SWEEP_MODEL}).to_json())

    monkeypatch.setattr(tsweep, "Config", small)
    monkeypatch.setattr(tsweep, "POINTS", tsweep.POINTS[::3])
    monkeypatch.setattr(tsweep, "BATCHES", (2,))
    monkeypatch.setattr(tsweep, "MAX_STEPS", 4)
    out = tmp_path / "sweep.jsonl"
    points = tsweep.main(["--device", "cpu", "--out", str(out)])
    assert [(p["impl"], p["iters"]) for p in points] == [
        ("matmul_bf16", 60), ("pallas", 30)]
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "[*] device: cpu"
    assert [json.loads(x) for x in lines[1:]] == points
    assert [json.loads(x) for x in out.read_text().splitlines()] == points


# ------------------------------------------------------------- bf16 study

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bf16_study_config_equals_the_script(dtype):
    want = dataclasses.asdict(jbf16.study_config(dtype))
    # the port's config as its JSON holds it (a Tacotron config leaves out
    # the architecture and Tacotron 2 fields, which JAX has not)
    got = tbf16.study_config(dtype).as_dict()
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    assert got["model"]["compute_dtype"] == dtype
    assert tbf16.TEXTS == ["안녕하세요 만나서 반갑습니다",
                           "오늘은 날씨가 정말 좋네요",
                           "음성 합성 시스템을 시험합니다",
                           "내일 아침 일찍 만나요",
                           "어제는 비가 조금 내렸어요", "스물 네 시간 열두 달"]


def test_bf16_study_corpus_byte_equal(tmp_path, monkeypatch):
    """Both builders from their own working directory with the same
    relative root (the metadata holds the paths): every file equal."""
    dirs = {}
    for who, mod in (("jax", jbf16), ("torch", tbf16)):
        (tmp_path / who).mkdir()
        monkeypatch.chdir(tmp_path / who)
        dirs[who] = mod.build_corpus("corpus", n_utts=4)
    assert dirs["jax"] == dirs["torch"] == ["corpus/spk0/data",
                                            "corpus/spk1/data"]
    files = {}
    for who in ("jax", "torch"):
        root = tmp_path / who / "corpus"
        files[who] = {str(p.relative_to(root)): p.read_bytes()
                      for p in sorted(root.rglob("*")) if p.is_file()}
    assert sorted(files["torch"]) == sorted(files["jax"])
    assert sum(n.endswith(".npz") for n in files["jax"]) == 8
    assert sum(n.endswith(".wav") for n in files["jax"]) == 8
    for name, data in files["jax"].items():
        assert files["torch"][name] == data, name


def _records(losses, sps, every=10):
    return [{"step": every * (i + 1), "loss": l, "sec_per_step": s,
             "kind": "train"} for i, (l, s) in enumerate(zip(losses, sps))]


#: canned (f32, bf16) train records: bf16 equivalent and faster; bf16
#: slower
BF16_CASES = {
    "recommend": (_records(np.linspace(1.0, 0.30, 8), [0.2] * 8),
                  _records(np.linspace(1.0, 0.31, 8), [0.15] * 8)),
    "keep_f32": (_records(np.linspace(1.0, 0.30, 8), [0.2] * 8),
                 _records(np.linspace(1.0, 0.29, 8), [0.25] * 8)),
}


def _undevice(text: str, device: str) -> str:
    assert f"device: {device}." in text
    return text.replace(f"device: {device}.", "device: <device>.")


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_bf16_study_report_equals_the_script(case, tmp_path, monkeypatch):
    f32, bf16 = BF16_CASES[case]
    arms = {"float32": f32, "bfloat16": bf16}

    def fake_run(tag, dtype, data_dirs, steps, out_root, *device):
        assert data_dirs == ["d0", "d1"] and steps == 80
        return arms[dtype]

    monkeypatch.setattr(tacotron_tpu, "enable_compilation_cache",
                        lambda *a, **k: None)
    for mod in (jbf16, tbf16):
        monkeypatch.setattr(mod, "run", fake_run)
        monkeypatch.setattr(mod, "build_corpus", lambda root: ["d0", "d1"])
    jout, tout = tmp_path / "jax.md", tmp_path / "torch.md"
    monkeypatch.setattr(sys, "argv", [
        "bf16_study.py", "--steps", "80", "--out", str(jout),
        "--work_dir", str(tmp_path / "jw")])
    jbf16.main()
    text = tbf16.main(["--steps", "80", "--out", str(tout), "--work_dir",
                       str(tmp_path / "tw"), "--device", "cpu"])
    assert tout.read_text() == text
    assert _undevice(text, "cpu") == _undevice(
        jout.read_text(), str(jax.devices()[0]))
    assert ("use `model.compute_dtype=\"bfloat16\"`" in text) == (
        case == "recommend")


def _small_config(cfg):
    """``cfg`` at 1/16 of the widths and an 8-step decode, its audio kept;
    batch 2."""
    model = dataclasses.replace(scale_model_widths(cfg.model, 16),
                                post_proj_sizes=(16, 80), max_iters=8)
    return cfg.replace(model=model, train=dataclasses.replace(
        cfg.train, batch_size=2))


def test_bf16_study_cli_on_the_cpu(tmp_path, monkeypatch):
    config, corpus = tbf16.study_config, tbf16.build_corpus
    monkeypatch.setattr(tbf16, "study_config",
                        lambda dtype="float32": _small_config(config(dtype)))
    monkeypatch.setattr(tbf16, "build_corpus",
                        lambda root: corpus(root, n_utts=6))
    work = tmp_path / "work"
    # the driver logs a train record every 10 steps, as the script asks
    text = tbf16.main(["--steps", "10", "--work_dir", str(work), "--device",
                       "cpu"])
    assert (work / "BF16_STUDY.md").read_text() == text
    assert "device: cpu." in text and "**Recommendation**" in text
    for tag in ("f32", "bf16"):
        with open(work / tag / "config.json") as fh:
            saved = json.load(fh)
        assert saved["model"]["compute_dtype"] == (
            "float32" if tag == "f32" else "bfloat16")
        assert saved["train"]["batch_size"] == 2


# ------------------------------------------------------------ batch study

def _curve(batch, losses, sps):
    return [(10 * (i + 1) * batch, float(l), sps)
            for i, l in enumerate(losses)]


def _curves(b64_4k_end, b64_1k_end):
    return {
        "b16_noam4k": _curve(16, np.linspace(1.0, 0.30, 40), 0.09),
        "b32_noam2k": _curve(32, np.linspace(1.0, 0.305, 20), 0.11),
        "b64_noam4k": _curve(64, np.linspace(1.0, b64_4k_end, 10), 0.16),
        "b64_noam1k": _curve(64, np.linspace(1.0, b64_1k_end, 10), 0.16),
    }


#: each branch of the conclusion: the rescaled warmup wins within 5 %, the
#: default one wins within 5 %, batch 64 diverges
BATCH_CASES = {"rescaled": _curves(0.33, 0.31),
               "default": _curves(0.305, 0.32),
               "diverges": _curves(0.45, 0.40)}


@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_batch_study_report_equals_the_script(case, tmp_path, monkeypatch,
                                              capsys):
    curves = BATCH_CASES[case]
    calls = []

    def fake_run_one(tag, batch, warmup, steps, data_dirs, work, *device):
        calls.append((tag, batch, warmup, steps))
        return curves[tag]

    monkeypatch.setattr(tacotron_tpu, "enable_compilation_cache",
                        lambda *a, **k: None)
    for mod in (jbatch, tbatch):
        monkeypatch.setattr(mod, "run_one", fake_run_one)
        monkeypatch.setattr(mod, "ensure_corpus",
                            lambda work, utterances: ["d0", "d1"])
    jout, tout = tmp_path / "jax.md", tmp_path / "torch.md"
    monkeypatch.setattr(sys, "argv", [
        "batch_study.py", "--work", str(tmp_path / "jw"), "--samples",
        "32000", "--out", str(jout)])
    jbatch.main()
    want_summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    summary = tbatch.main(["--work", str(tmp_path / "tw"), "--samples",
                           "32000", "--out", str(tout), "--device", "cpu"])
    assert calls[:4] == calls[4:] == [
        ("b16_noam4k", 16, 4000.0, 2000), ("b32_noam2k", 32, 2000.0, 1000),
        ("b64_noam4k", 64, 4000.0, 500), ("b64_noam1k", 64, 1000.0, 500)]
    assert summary == want_summary
    assert _undevice(tout.read_text(), "cpu") == _undevice(
        jout.read_text(), str(jax.devices()[0]))
    text, same = tbatch.report(curves, 32000, "cpu")
    assert text == tout.read_text() and same == summary


def test_batch_study_cli_on_the_cpu(tmp_path, monkeypatch):
    ensure, load = tbatch.ensure_corpus, tbatch.load_config
    monkeypatch.setattr(tbatch, "ensure_corpus",
                        lambda work, utterances: ensure(
                            work, utterances=6, num_workers=1))
    monkeypatch.setattr(tbatch, "load_config",
                        lambda path: _small_config(load(path)))
    monkeypatch.setattr(tbatch, "ARMS", tuple(
        (tag, 2, warmup) for tag, _, warmup in tbatch.ARMS))
    work = tmp_path / "work"
    summary = tbatch.main(["--work", str(work), "--samples", "20",
                           "--device", "cpu"])
    assert set(summary) == {"b16", "b64", "b64_rescaled", "winner",
                            "rel_diff"}
    assert "device: cpu." in (work / "BATCH_STUDY.md").read_text()
    for tag, _, warmup in tbatch.ARMS:
        with open(work / f"run_{tag}" / "config.json") as fh:
            saved = json.load(fh)
        assert saved["model"]["compute_dtype"] == "bfloat16"
        assert saved["train"]["warmup_steps_fresh"] == warmup


if __name__ == "__main__":
    # re-measure SWEEP_SPREAD: JAX's compiled against eager point (the
    # eager pallas points take ~20 s each)
    cfg, variables, synth = _sweep_pair()
    inp, lens = tsweep.make_inputs(synth, SWEEP_B)
    ji = jnp.asarray(inp.numpy(), jnp.int32)
    jl = jnp.asarray(lens.numpy(), jnp.int32)
    for point in tsweep.POINTS:
        jit = _jax_point(cfg, variables, ji, jl, *point)
        eager = _jax_point(cfg, variables, ji, jl, *point, compiled=False)
        print(point, f"compiled {jit:.6f} eager {eager:.6f} spread "
                     f"{abs(jit - eager):.3e}")
