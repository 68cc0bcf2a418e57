"""The port's benchmark harness (``tacotron_tpu_torch/bench.py``) against the
repo's root ``bench.py``, on the CPU at small widths.

- The raw and fast programs (decode plus batched Griffin-Lim) against the
  root's jitted ``model.apply`` + ``dsp.chip.batched_linear_to_waveform``
  on the same weights (carried by ``params.py``) and the same inputs, at
  the tolerance ``tests/test_torch_synth.py`` holds the same engine to:
  each waveform correlated above 0.999 with a std ratio in [0.95, 1.05].
- ``run`` at batch 2, 3 steps, one repetition, a chain of 2 and one load
  level of 2 requests: every key of the committed ``BENCH_DETAIL.json``,
  through ``RENAMED``, every number finite, the Griffin-Lim FLOPs the
  root's formula.
- ``main``: the headline as the last line (valid JSON, at most 200
  bytes), the record at the default ``--out`` (not ``BENCH_DETAIL.json``,
  whose bytes stay as they were), ``--device cpu`` running and no device
  argument raising without CUDA.
- ``run``'s defaults, texts and fast vocoder are the root harness's.
"""

import ast
import dataclasses
import functools
import inspect
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron_tpu.config import Config as JaxConfig
from tacotron_tpu.dsp import chip as jchip
from tacotron_tpu.synth import synthesizer as jsynth
from tacotron_tpu_torch import bench
from tacotron_tpu_torch.config import Config
from tacotron_tpu_torch.ops.kernels.gl_fused import iteration_flops
from tacotron_tpu_torch.parallel.prefetch import DevicePrefetcher
from tacotron_tpu_torch.studies import synth_sweep
from tacotron_tpu_torch.synth import Synthesizer
from test_torch_params import SMALL, random_variables

ROOT = Path(__file__).resolve().parents[1]
AUDIO = dict(num_freq=129, num_mels=10, sample_rate=16000, frame_shift_ms=8,
             frame_length_ms=16)
MODEL = dict(SMALL, num_mels=10, num_freq=129, reduction_factor=4,
             max_iters=8)
#: run()'s counts in these tests
COUNTS = dict(batch=2, train_batch=2, max_steps=3, warmup=1, reps=1,
              chain=2, fresh=2, t_out=24, preset_batch=2, n_store=4,
              load_levels=(1,), load_requests=2, max_batches=(4,))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: these small models gain nothing from more, and
    beside the other test processes a pool per process oversubscribes the
    cores (the server part runs many times slower so)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _jax_config():
    cfg = JaxConfig.from_dict({"audio": AUDIO, "model": MODEL})
    return cfg.replace(data=dataclasses.replace(cfg.data, min_iters=1))


def small_config() -> Config:
    return Config.from_json(_jax_config().to_json())


#: the record fixture's run, in order: "timed" and "/timed" around each
#: timed function, "stop" where a prefetcher stops
EVENTS = []


@pytest.fixture(scope="module")
def record():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # as one_torch_thread, for the whole module
    timed, stop = bench.timed, DevicePrefetcher.stop

    def logged_timed(*args, **kwargs):
        EVENTS.append("timed")
        try:
            return timed(*args, **kwargs)
        finally:
            EVENTS.append("/timed")

    def logged_stop(self):
        EVENTS.append("stop")
        stop(self)

    bench.timed, DevicePrefetcher.stop = logged_timed, logged_stop
    try:
        synth = Synthesizer(device="cpu").init_random(small_config())
        return bench.run(synth, small_config(), **COUNTS)
    finally:
        bench.timed, DevicePrefetcher.stop = timed, stop
        torch.set_num_threads(threads)


def _root_detail() -> dict:
    with open(ROOT / "BENCH_DETAIL.json", encoding="utf-8") as fh:
        return json.load(fh)


# ------------------------------------------------------------- programs

@pytest.mark.parametrize("program", ["raw", "fast"])
def test_programs_match_the_root_program(program):
    """bench.py:112-119 (and :139-145 for the fast vocoder): decode plus
    the batched vocoder in one jit, on the weights the port loads."""
    cfg = _jax_config()
    variables = random_variables(cfg.model, 3)
    synth = Synthesizer(device="cpu").load_variables(variables,
                                                     small_config())
    steps = 5
    inp, lens = synth_sweep.make_inputs(synth, 2, bench.BUCKET)
    audio = (cfg.audio if program == "raw" else dataclasses.replace(
        cfg.audio, griffin_lim_iters=30, griffin_lim_momentum=0.99))
    model = jsynth._model_for(cfg)

    @jax.jit
    def synth_batch(variables, inputs, lengths):
        out = model.apply(variables, inputs, lengths, train=False,
                          max_steps=steps)
        wavs = jchip.batched_linear_to_waveform(out["linear_outputs"],
                                                audio)
        return wavs, jnp.sum(jnp.abs(wavs))

    want, want_chk = synth_batch(jax.tree.map(jnp.asarray, variables),
                                 jnp.asarray(inp.numpy(), jnp.int32),
                                 jnp.asarray(lens.numpy(), jnp.int32))
    got, got_chk = bench.synthesis_programs(synth, steps)[program](inp, lens)
    want, got = np.asarray(want), got.numpy()
    assert got.shape == want.shape == (2, (steps * 4 - 1)
                                       * synth.config.audio.hop_length)
    for wa, wb in zip(want, got):
        assert np.corrcoef(wa, wb)[0, 1] > 0.999
        assert 0.95 <= wb.std() / wa.std() <= 1.05
    assert 0.95 <= float(got_chk) / float(want_chk) <= 1.05


def test_fast_vocoder_and_constants_are_the_roots():
    """The fast vocoder's iterations and momentum, the texts and run()'s
    defaults, read from the root harness's source."""
    source = (ROOT / "bench.py").read_text(encoding="utf-8")
    assert "griffin_lim_iters=30" in source
    assert "griffin_lim_momentum=0.99" in source
    fast = Synthesizer.fast_audio(small_config().audio)
    assert (fast.griffin_lim_iters, fast.griffin_lim_momentum) == (30, 0.99)
    for text in synth_sweep.TEXTS:
        assert f'"{text}"' in source
    [long_text] = [ast.literal_eval(node.value)
                   for node in ast.walk(ast.parse(source))
                   if isinstance(node, ast.Assign)
                   and getattr(node.targets[0], "id", None) == "long_text"]
    assert bench.LONG_TEXT == long_text
    assert "bucket = 64" in source and bench.BUCKET == 64
    defaults = {k: p.default for k, p in inspect.signature(
        bench.run).parameters.items() if p.default is not p.empty}
    for line in ("WARMUP = 3", "REPS = 20", "BATCH = 32",
                 "TRAIN_BATCH = 16", "MAX_STEPS = 50", "T_OUT = 192",
                 "CHAIN = 20", "FRESH = 10", "PRESET_NB = 32",
                 "N_STORE = 256", "levels=(1, 2, 4, 8), "
                 "requests_per_level=16", "max_batches=(4, 1)"):
        assert line in source, line
    assert defaults == dict(batch=32, train_batch=16, max_steps=50,
                            warmup=3, reps=20, chain=20, fresh=10,
                            t_out=192, preset_batch=32, n_store=256,
                            load_levels=(1, 2, 4, 8), load_requests=16,
                            max_batches=(4, 1))


# ---------------------------------------------------------------- record

def test_record_has_every_root_key(record):
    root = _root_detail()
    assert set(record) == set(root)
    assert (record["metric"], record["unit"]) == (root["metric"],
                                                  root["unit"])
    detail = record["detail"]
    for key in root["detail"]:
        if key == "roofline":
            for sub in root["detail"]["roofline"]:
                name = bench.RENAMED.get(f"roofline.{sub}",
                                         f"roofline.{sub}")
                assert name.split(".", 1)[1] in detail["roofline"], name
        else:
            assert bench.RENAMED.get(key, key) in detail, key
    for old in bench.RENAMED:
        assert old.split(".")[-1] not in detail
        assert old.split(".")[-1] not in detail["roofline"]
    # the load rows: the root's keys and the port's counts
    for row in detail["serving_concurrent_levels"]:
        assert set(root["detail"]["serving_concurrent_levels"][0]) <= set(
            row)
    assert detail["training_scan_unroll"] is None
    assert detail["device"] == "cpu"


def test_record_numbers_are_finite(record):
    numbers = dict(bench.numbers(record))
    assert len(numbers) > 100
    bad = {k: v for k, v in numbers.items() if not math.isfinite(v)}
    assert not bad
    detail = record["detail"]
    assert record["value"] > 0 and record["vs_baseline"] > 0
    for key in ("device_batch_seconds", "serving_batch_seconds",
                "training_step_seconds", "eager_device_batch_seconds",
                "eager_training_step_seconds", "prewarm_s", "wall_s"):
        assert detail[key] > 0, key
    # the port's additions: the five eager rows and each section's counts
    # (the plain versions on the CPU: no kernel)
    assert {k for k in detail if k.startswith("eager_")} >= {
        "eager_device_batch_seconds", "eager_fast_gla_batch_seconds",
        "eager_serving_batch_seconds", "eager_serving_latency_1utt_ms",
        "eager_training_step_seconds"}
    assert set(detail["launches"]) == {
        "raw", "fast_gla", "serving", "serving_fast", "serving_mulaw8",
        "serving_latency_1utt", "serving_default_1utt",
        "serving_default_batch", "long_text"}
    assert all(v == {"K1": 0, "K2": 0, "K3": 0}
               for v in detail["launches"].values())
    assert detail["training_live_prefetch_depth"] == 2
    assert detail["training_live_step_ms"] == detail[
        "training_pipelined_step_ms"]
    # the replays against the eager calls (the same function on the CPU)
    assert detail["replay_vs_eager"] == {"raw": 0.0, "fast_gla": 0.0}


def test_prefetchers_stop_outside_the_timed_runs(record):
    """The pipelined rows time the driver's loop in its steady state: each
    of the three prefetchers (spectrograms, waveforms, the preset) stops
    after its runs are timed, never inside one."""
    open_timers, stops = 0, 0
    for event in EVENTS:
        open_timers += {"timed": 1, "/timed": -1}.get(event, 0)
        if event == "stop":
            assert open_timers == 0
            stops += 1
    assert stops == 3 and open_timers == 0


def test_gl_flops_are_the_roots_formula(record):
    """bench.py:545-551: 2 x (2M ne + 2M no + 2 ne M + 2 no M) FLOPs a
    frame row and iteration."""
    def root_formula(n_fft, rows, iters):
        M, ne, no = n_fft // 2, n_fft // 4 + 1, n_fft // 4
        macs_per_row = (2 * M * ne + 2 * M * no + 2 * ne * M + 2 * no * M)
        return iters * rows * 2 * macs_per_row

    for n_fft, rows in ((2048, 32 * 50 * 4), (256, 24), (512, 7)):
        assert 60 * iteration_flops(rows, n_fft) == root_formula(
            n_fft, rows, 60)
    cfg = small_config()
    rows = COUNTS["batch"] * COUNTS["max_steps"] * 4
    roof = record["detail"]["roofline"]
    assert roof["gl_matmul_tflop_per_batch"] == root_formula(
        cfg.audio.n_fft, rows, cfg.audio.griffin_lim_iters) / 1e12
    assert roof["bf16_peak_tflop_s"] == 989.0


# ------------------------------------------------------------------ main

class _SmallConfig:
    """``bench.Config`` for ``main``: the small config, with the class's
    preset."""
    tpu_recommended = staticmethod(Config.tpu_recommended)

    def __new__(cls):
        return small_config()


def test_main_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(bench, "Config", _SmallConfig)
    monkeypatch.setattr(bench, "run", functools.partial(bench.run, **COUNTS))
    assert Path(bench.DEFAULT_OUT).name != "BENCH_DETAIL.json"
    # the root harness writes BENCH_DETAIL.json in its working directory
    monkeypatch.chdir(tmp_path)
    (tmp_path / "BENCH_DETAIL.json").write_bytes(b"root record")
    root_bytes = (ROOT / "BENCH_DETAIL.json").read_bytes()
    record = bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "[*] device: cpu"
    assert len(lines[-1].encode()) <= 200
    head = json.loads(lines[-1])
    assert head == {"metric": "synthesis_throughput",
                    "value": record["value"],
                    "unit": "audio-seconds/s/chip",
                    "vs_baseline": record["vs_baseline"],
                    "detail_file": bench.DEFAULT_OUT}
    with open(tmp_path / bench.DEFAULT_OUT, encoding="utf-8") as fh:
        assert json.load(fh) == json.loads(json.dumps(record))
    assert (tmp_path / "BENCH_DETAIL.json").read_bytes() == b"root record"
    assert (ROOT / "BENCH_DETAIL.json").read_bytes() == root_bytes


def test_main_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--device", "cuda"])


def test_headline_is_bounded():
    record = {"metric": "synthesis_throughput", "value": 1.5,
              "unit": "audio-seconds/s/chip", "vs_baseline": 2.5}
    line = bench.headline_line(record, "out.json")
    assert json.loads(line)["detail_file"] == "out.json"
    with pytest.raises(ValueError, match="headline"):
        bench.headline_line(record, "x" * 200)
