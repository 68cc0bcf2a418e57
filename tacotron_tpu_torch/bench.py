"""The port's benchmark harness: the counterpart of the repo's root
``bench.py``, with the same measurements in the same order on the same
inputs, run on the card::

    python -m tacotron_tpu_torch.bench [--device cuda|cpu] [--out PATH]

The last line of stdout is one compact JSON headline (at most 200 bytes:
``metric``, ``value``, ``unit``, ``vs_baseline``, ``detail_file``); the
full record goes to ``--out`` (default :data:`DEFAULT_OUT`), never to the
root's ``BENCH_DETAIL.json``.  ``--device cpu`` runs it on the CPU; without
it the card runs it, and a machine without CUDA raises.

Headline: synthesis audio seconds per second on one card, for the greedy
decode of 32 texts at 50 steps plus 60 classic Griffin-Lim iterations (on
the card the fused engine, ``gl_iteration``) as one program.
``vs_baseline`` divides it by the host numpy Griffin-Lim of one such
spectrogram (``dsp/host.py``), the reference's CPU serving path.

Where the root harness times a ``jax.jit`` program, this one times the
port's counterpart: the function captured as a CUDA graph and replayed
(``utils/graphs.py``, ``Synthesizer.prewarm``, ``TrainStep.prewarm``) under
the root's key; the capture seconds add up in ``prewarm_s``.  Five rows are
also timed eagerly, under an ``eager_`` prefix: the raw program, the fast
program, serving at batch 32, the one-utterance latency and the float32
training chain.  The first call of each synthesis and serving section runs
eagerly, before its programs are captured; its kernel launches (the
wrappers' counters, which do not see replays) are in ``launches``.

Left out, as the port leaves them out: XLA's scan unroll
(``training_scan_unroll`` is null) and the automatic prefetch depth (the
train driver runs at depth 2, so the live rows are the pipelined loop).
The keys that named the TPU are renamed (:data:`RENAMED`), and the
roofline is against the H100's peaks.

Timing: every timed function fetches a scalar or host arrays inside the
timed region, which waits for the card; warm-ups first, then the median
and p10/p90 of the repetitions.  :func:`run` takes the root harness's
constants as its defaults; a section that the root repeats fewer times
than ``reps`` (or warms up less than ``warmup``) keeps its own count.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import itertools
import json
import os
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .config import Config
from .dsp import host as dsp_host
from .ops.kernels.gl_fused import gl_iteration, iteration_flops
from .ops.kernels.griffin_lim import spectral_step
from .ops.kernels.ola import overlap_add_batched
from .studies import serving_load, synth_sweep
from .synth import Synthesizer
from .train.driver import PREFETCH_DEPTH
from .utils.graphs import GraphSet

#: the root record's keys that named the TPU -> the port's keys (a dotted
#: key is inside ``roofline``)
RENAMED = {
    "tpu_batch_seconds": "device_batch_seconds",
    "tpu_batch_seconds_p10_p90": "device_batch_seconds_p10_p90",
    "roofline.mxu_utilization_pct": "roofline.tensor_core_utilization_pct",
}
#: where the record goes unless ``--out`` says otherwise (``logs/`` is
#: gitignored)
DEFAULT_OUT = os.path.join("logs", "bench_torch_detail.json")
#: published dense peak of one H100 SXM in bf16 (the Griffin-Lim products
#: and the bf16 train steps); float32 is ``train/roofline.py``'s
H100_BF16_PEAK_TFLOPS = 989.0
#: the root harness's repetitions and warm-ups
REPS, WARMUP = 20, 3
#: the synthesis batch's token bucket
BUCKET = 64
#: a replayed program against its eager first call on the same inputs:
#: the same kernels, so bit-equal is expected (the limit is a share of the
#: eager output's peak)
REPLAY_TOLERANCE = 1e-6
#: the paragraph of the long-text section
LONG_TEXT = ("안녕하세요 오늘은 정말 좋은 날씨입니다 함께 산책을 나가요. "
             "음성 합성 시스템의 품질을 평가하기 위한 긴 문단입니다 여러 "
             "문장이 이어집니다. 어제 저녁에는 친구들과 함께 맛있는 "
             "식사를 했습니다 그리고 커피도 마셨습니다. 대한민국의 "
             "수도는 서울이며 많은 사람들이 살고 있습니다.")


def timed(fn: Callable, reps: int = REPS, warmup: int = WARMUP):
    """(median, p10, p90) wall seconds of ``fn()``, which waits for the
    card itself, over ``reps`` calls after ``warmup``."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    arr = np.asarray(times)
    return (float(np.median(arr)), float(np.percentile(arr, 10)),
            float(np.percentile(arr, 90)))


def numbers(tree, path: str = ""):
    """(path, value) of every number in a tree of dicts and lists (a bool
    counts as one)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from numbers(v, f"{path}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from numbers(v, f"{path}[{i}]")
    elif isinstance(tree, (int, float)):
        yield path, tree


def synthesis_programs(synth, max_steps: int) -> Dict[str, Callable]:
    """The root harness's two jitted programs, decode plus batched
    Griffin-Lim of a batch, as functions ``(ids, lengths) -> (wavs,
    sum |wavs|)``: ``raw`` with the config's vocoder (60 classic
    iterations), ``fast`` with ``Synthesizer.fast_audio``."""
    audio = synth.config.audio
    return {"raw": synth_sweep.full_program(synth, audio, max_steps),
            "fast": synth_sweep.full_program(
                synth, Synthesizer.fast_audio(audio), max_steps)}


def headline_line(record: dict, detail_file: str) -> str:
    """The last stdout line: the headline keys and ``detail_file``."""
    head = {k: record[k] for k in ("metric", "value", "unit",
                                   "vs_baseline")}
    head["detail_file"] = detail_file
    line = json.dumps(head)
    if len(line) > 200:
        raise ValueError(f"headline of {len(line)} bytes: {line}")
    return line


class _Harness:
    """What the sections share: the synthesizer and config, the counts,
    the capture seconds and the launches of each section's first call."""

    def __init__(self, synth, cfg, reps: int, warmup: int):
        self.synth, self.cfg = synth, cfg
        self.device = synth.device
        self.reps, self.warmup = reps, warmup
        self.prewarm_s = 0.0
        self.launches: Dict[str, Dict[str, int]] = {}

    def timed(self, fn: Callable, reps: int = REPS, warmup: int = WARMUP):
        """:func:`timed` at the section's counts, capped by the run's."""
        return timed(fn, min(self.reps, reps), min(self.warmup, warmup))

    def capture(self, fn: Callable):
        """``fn()``, which captures programs, its seconds in
        ``prewarm_s``."""
        t0 = time.perf_counter()
        out = fn()
        self.prewarm_s += time.perf_counter() - t0
        return out

    def counted(self, name: str, fn: Callable):
        """``fn()``, its K1, K2 and K3 launches recorded under ``name``."""
        k1, k2 = gl_iteration.launches, overlap_add_batched.launches
        k3 = spectral_step.launches
        out = fn()
        self.launches[name] = {"K1": gl_iteration.launches - k1,
                               "K2": overlap_add_batched.launches - k2,
                               "K3": spectral_step.launches - k3}
        return out


def _synthesis(h: _Harness, batch: int, max_steps: int) -> dict:
    """Sections 1-2: the raw and fast programs, eager and replayed; each
    replay's waveforms held to its eager first call's on the same inputs
    (``replay_err``: the largest difference over the eager peak)."""
    inp, lens = synth_sweep.make_inputs(h.synth, batch, BUCKET)
    programs = synthesis_programs(h.synth, max_steps)
    graphs = GraphSet(h.device)
    out = {"inputs": (inp, lens), "replay_err": {}}
    for name, fn, reps in (("raw", programs["raw"], REPS),
                           ("fast_gla", programs["fast"], 10)):
        want, chk = h.counted(name, lambda: fn(inp, lens))
        if not np.isfinite(float(chk)):
            raise RuntimeError(f"{name} program: checksum {float(chk)}")
        out[f"{name}_eager"] = h.timed(lambda: float(fn(inp, lens)[1]), reps)
        gc.collect()  # no graph may be freed inside a capture
        graphed = h.capture(lambda: graphs.capture(fn, inp, lens))
        out[name] = h.timed(lambda: float(graphed(inp, lens)[1]), reps)
        err = float((graphed(inp, lens)[0] - want).abs().max()
                    / want.abs().max())
        if not err <= REPLAY_TOLERANCE:
            raise RuntimeError(f"{name} program: the replay is {err} of the "
                               f"peak from the eager call")
        out["replay_err"][name] = err
    return out


def _serving(h: _Harness, batch: int, max_steps: int, load_levels,
             load_requests: int, max_batches) -> dict:
    """Sections 3-8: ``synthesize`` at the batch (classic, fast, mulaw8),
    one utterance, the adaptive-budget default, the phase budget,
    ``synthesize_long`` and the server under load."""
    synth = h.synth
    texts = [synth_sweep.TEXTS[i % len(synth_sweep.TEXTS)]
             for i in range(batch)]
    out = {}

    def samples(res):
        return sum(len(w) for w in res["wavs"])

    def section(name, call, call_texts, reps, eager=False, **key):
        """The first call eagerly (counted), the eager timing if asked,
        then the call's programs captured and its replays timed."""
        first = h.counted(name, call)
        if eager:
            out[f"{name}_eager"] = h.timed(call, reps)
        h.capture(lambda: synth.prewarm(**synth.prewarm_args(
            call_texts, **key)))
        out[name] = h.timed(call, reps)
        return first

    fixed = dict(max_steps=max_steps, attention_trim=False,
                 librosa_trim=False)

    def serve(**kw):
        return lambda: samples(synth.synthesize(texts=texts, **fixed, **kw))

    serve_samples = section("serving", serve(), texts, REPS, eager=True,
                            max_steps=max_steps, attention_trim=False)
    fast_samples = section("serving_fast",
                           serve(return_alignments=False, fast_vocoder=True),
                           texts, 10, max_steps=max_steps,
                           attention_trim=False, fast_vocoder=True)
    mulaw_samples = section(
        "serving_mulaw8", serve(return_alignments=False, fast_vocoder=True,
                                wire_format="mulaw8"),
        texts, 10, max_steps=max_steps, attention_trim=False,
        fast_vocoder=True, wire_format="mulaw8")
    if not serve_samples == fast_samples == mulaw_samples:
        raise RuntimeError(f"samples: classic {serve_samples}, fast "
                           f"{fast_samples}, mulaw8 {mulaw_samples}")
    out["serve_samples"] = serve_samples

    def one():
        return len(synth.synthesize(texts=texts[:1], **fixed,
                                    return_alignments=False,
                                    fast_vocoder=True)["wavs"][0])

    section("serving_latency_1utt", one, texts[:1], 10, eager=True,
            max_steps=max_steps, attention_trim=False, fast_vocoder=True)

    # the default call: max_steps omitted (the adaptive budget), attention
    # and dB trims on
    def default_one():
        return len(synth.synthesize(texts=texts[:1], return_alignments=False,
                                    fast_vocoder=True)["wavs"][0])

    out["default_samples"] = section("serving_default_1utt", default_one,
                                     texts[:1], 10, fast_vocoder=True)

    def default_batch():
        return samples(synth.synthesize(texts=texts, return_alignments=False,
                                        fast_vocoder=True))

    out["default_batch_samples"] = section(
        "serving_default_batch", default_batch, texts, 10,
        fast_vocoder=True)

    # the phase budget of the fast call at the batch (its programs are
    # the fast section's)
    keys = ("frontend_ms", "dispatch_ms", "device_ms", "fetch_ms", "post_ms",
            "total_ms")
    phases = {k: [] for k in keys}
    for _ in range(min(h.reps, 10)):
        res = synth.synthesize(texts=texts, **fixed, return_alignments=False,
                               fast_vocoder=True, collect_timings=True)
        for k in keys:
            phases[k].append(res["timings"][k])
    out["phase_budget"] = {k: float(np.median(v)) for k, v in phases.items()}

    def long():
        res = synth.synthesize_long(LONG_TEXT, robust=False,
                                    fast_vocoder=True,
                                    return_alignments=False,
                                    librosa_trim=False)
        return len(res["wav"]), res["chunks"]

    long_samples, chunks = h.counted("long_text", long)
    h.capture(lambda: synth.prewarm(**synth.prewarm_args(
        chunks, fast_vocoder=True)))
    out["long_text"] = h.timed(lambda: long()[0], 5)
    out["long_samples"], out["long_chunks"] = long_samples, len(chunks)

    # the server under load: its programs first (run_load_test's own
    # prewarm then finds them captured), then every call replays
    h.capture(lambda: synth.prewarm(token_buckets=(32, 64),
                                    batch_sizes=(1, 2, 4),
                                    fast_vocoder=True))
    out["concurrent"] = serving_load.run_load_test(
        synth, levels=tuple(load_levels), requests_per_level=load_requests,
        max_batches=tuple(max_batches), prewarm=True)
    return out


def _training(h: _Harness, inputs: np.ndarray, lengths: np.ndarray,
              train_batch: int, chain: int, fresh: int, t_out: int,
              preset_batch: int, n_store: int) -> dict:
    """Section 10: the train step at ``train_batch`` (synced, a chain,
    bf16), fresh batches (spectrograms against waveforms, synchronous and
    prefetched), the live loop, the ``tpu_recommended`` preset and the
    resident corpus."""
    from .data.resident import assemble_batch
    from .parallel.prefetch import DevicePrefetcher
    from .train.state import create_train_state
    from .train.step import Batch, batch_to_device, make_train_step

    cfg, dev = h.cfg, h.device
    NB, hop = train_batch, cfg.audio.hop_length
    rng = np.random.default_rng(0)
    seed = 1
    out = {}

    def host_batch(n, mel, linear, wav):
        return Batch(
            inputs=inputs[:n], input_lengths=lengths[:n],
            loss_coeff=np.ones((n,), np.float32),
            mel_targets=(rng.random((n, t_out, cfg.model.num_mels))
                         .astype(np.float32) if mel else None),
            linear_targets=(rng.random((n, t_out, cfg.audio.num_freq))
                            .astype(np.float32) if linear else None),
            speaker_id=np.zeros((n,), np.int32),
            target_lengths=np.full((n,), t_out - 1, np.int32),
            waveforms=(rng.integers(-2000, 2000, (n, (t_out - 1) * hop))
                       .astype(np.int16) if wav else None))

    def chain_fn(step_fn, state, batch):
        def run():
            m = None
            for _ in range(chain):
                _, m = step_fn(state, batch, seed)
            float(m["param_norm"])
        return run

    # float32: the eager chain, then the step captured on the batch's shape
    state = create_train_state(cfg, seed=0, device=dev)
    tstep = make_train_step(cfg)
    tb = batch_to_device(host_batch(NB, True, True, False), dev)
    out["chain_eager"] = h.timed(chain_fn(tstep, state, tb), 5, 2)
    h.capture(lambda: tstep.prewarm(state, [tb]))

    def train_once():
        # param_norm depends on the whole update: a true end-of-step sync
        float(tstep(state, tb, seed)[1]["param_norm"])

    out["synced"] = h.timed(train_once)
    out["chain"] = h.timed(chain_fn(tstep, state, tb), 5, 2)

    # bf16 compute (parameters and optimizer state stay float32)
    cfg_bf16 = cfg.replace(model=dataclasses.replace(
        cfg.model, compute_dtype="bfloat16"))
    state_bf16 = create_train_state(cfg_bf16, seed=0, device=dev)
    tstep_bf16 = make_train_step(cfg_bf16)
    h.capture(lambda: tstep_bf16.prewarm(state_bf16, [tb]))
    out["bf16"] = h.timed(chain_fn(tstep_bf16, state_bf16, tb), 5, 2)

    # a fresh batch every step: f32 spectrogram targets against int16
    # waveforms with on-device features
    spec_batches = [host_batch(NB, True, True, False) for _ in range(4)]
    wav_cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, on_device_features=True))
    wav_batches = [b._replace(mel_targets=None, linear_targets=None,
                              waveforms=rng.integers(
                                  -2000, 2000, (NB, (t_out - 1) * hop))
                              .astype(np.int16)) for b in spec_batches]
    out["fresh_bytes"] = [sum(np.asarray(a).nbytes for a in b
                              if a is not None)
                          for b in (spec_batches[0], wav_batches[0])]
    state_wav = create_train_state(wav_cfg, seed=0, device=dev)
    tstep_wav = make_train_step(wav_cfg)
    h.capture(lambda: tstep_wav.prewarm(
        state_wav, [batch_to_device(wav_batches[0], dev)]))

    def fresh_chain(batches, step_fn, state):
        def run():
            m = None
            for i in range(fresh):
                _, m = step_fn(state, batch_to_device(batches[i % 4], dev),
                               seed)
            float(m["param_norm"])
        return run

    def pipelined(batches, step_fn, state):
        """The driver's loop, timed in its steady state: one prefetcher
        (batch k+1 copied on a side stream while step k runs,
        ``parallel/prefetch.py``) feeds every timed run, and is started
        and stopped outside them."""
        source = itertools.cycle(batches)
        pf = DevicePrefetcher(lambda: next(source), dev,
                              depth=PREFETCH_DEPTH)

        def run():
            m = None
            for _ in range(fresh):
                _, m = step_fn(state, pf.get(), seed)
            float(m["param_norm"])

        try:
            return h.timed(run, 3, 1)
        finally:
            pf.stop()

    run_spec = fresh_chain(spec_batches, tstep, state)
    run_wav = fresh_chain(wav_batches, tstep_wav, state_wav)
    out["fresh_spec"] = h.timed(run_spec, 3, 1)
    out["fresh_wav"] = h.timed(run_wav, 3, 1)
    out["pipelined_spec"] = pipelined(spec_batches, tstep, state)
    out["pipelined_wav"] = pipelined(wav_batches, tstep_wav, state_wav)

    # the preset a user is told to run (Config.tpu_recommended: bf16,
    # int16 waveform wire + on-device features) at its batch
    preset_cfg = Config.tpu_recommended(cfg)
    state_p = create_train_state(preset_cfg, seed=0, device=dev)
    tstep_p = make_train_step(preset_cfg)
    preset_batches = [host_batch(preset_batch, False, False, True)
                      for _ in range(4)]
    preset_dev = batch_to_device(preset_batches[0], dev)
    h.capture(lambda: tstep_p.prewarm(state_p, [preset_dev]))
    out["preset"] = h.timed(chain_fn(tstep_p, state_p, preset_dev), 5, 2)
    out["preset_live"] = pipelined(preset_batches, tstep_p, state_p)

    # the resident corpus: the waveforms on the card once, each step ships
    # the small fields and an index array and gathers on the card
    store = {"waveforms": torch.from_numpy(rng.integers(
        -2000, 2000, (n_store, (t_out - 1) * hop)).astype(np.int16)).to(dev)}
    smalls = [b._replace(waveforms=None) for b in preset_batches]
    indices = [rng.integers(0, n_store, (preset_batch,)).astype(np.int32)
               for _ in range(4)]

    def resident_chain():
        m = None
        for i in range(fresh):
            small = batch_to_device(smalls[i % 4], dev)
            idx = torch.from_numpy(indices[i % 4]).to(dev)
            _, m = tstep_p(state_p, assemble_batch(store, small, idx), seed)
        float(m["param_norm"])

    out["resident"] = h.timed(resident_chain, 3, 1)
    out["preset_cfg"] = preset_cfg
    return out


def run(synth, cfg: Config, *, batch: int = 32, train_batch: int = 16,
        max_steps: int = 50, warmup: int = WARMUP, reps: int = REPS,
        chain: int = 20, fresh: int = 10, t_out: int = 192,
        preset_batch: int = 32, n_store: int = 256,
        load_levels: Sequence[int] = (1, 2, 4, 8), load_requests: int = 16,
        max_batches: Sequence[int] = (4, 1)) -> dict:
    """Every section of the root harness: synthesis and serving on
    ``synth`` (a model of ``cfg`` with its weights), training on ``cfg``'s
    train step from random weights; returns the record (the headline keys
    and ``detail``).  The defaults are the root harness's constants."""
    from .train.roofline import mfu, train_step_model
    from .utils.misc import device_line

    t_start = time.perf_counter()
    h = _Harness(synth, cfg, reps, warmup)
    r = cfg.model.reduction_factor
    sr, hop = cfg.audio.sample_rate, cfg.audio.hop_length
    hop_s = hop / sr

    syn = _synthesis(h, batch, max_steps)
    audio_seconds = batch * max_steps * r * hop_s
    raw_s, fast_s = syn["raw"][0], syn["fast_gla"][0]
    device_throughput = audio_seconds / raw_s
    sv = _serving(h, batch, max_steps, load_levels, load_requests,
                  max_batches)

    # the host baseline: numpy Griffin-Lim of one decoded spectrogram
    inp, lens = syn["inputs"]
    with torch.inference_mode():
        spec = synth.model(inp[:1], lens[:1], max_steps=max_steps)[
            "linear_outputs"][0].float().cpu().numpy()
    t0 = time.perf_counter()
    dsp_host.inv_spectrogram(spec.T, cfg.audio)
    host_throughput = max_steps * r * hop_s / (time.perf_counter() - t0)

    n_rows = max(batch, train_batch, preset_batch)
    ids, lengths = synth_sweep.make_inputs(synth, n_rows, BUCKET)
    tr = _training(h, ids.cpu().numpy().astype(np.int32),
                   lengths.cpu().numpy().astype(np.int32), train_batch,
                   chain, fresh, t_out, preset_batch, n_store)

    # roofline: the Griffin-Lim products of the raw program against the
    # bf16 peak (their operands are bf16), the train step against the
    # peak of its compute dtype
    gl_flops = (cfg.audio.griffin_lim_iters
                * iteration_flops(batch * max_steps * r, cfg.audio.n_fft))
    achieved_tflops = gl_flops / raw_s / 1e12
    tr_model = train_step_model(cfg, train_batch, BUCKET, t_out)
    preset_model = train_step_model(tr["preset_cfg"], preset_batch, BUCKET,
                                    t_out)
    chain_step, bf16_step, preset_step = (tr[k][0] / chain for k in (
        "chain", "bf16", "preset"))
    fresh_ms = {k: tr[k][0] / fresh * 1e3 for k in (
        "fresh_spec", "fresh_wav", "pipelined_spec", "pipelined_wav",
        "preset_live", "resident")}
    live_ms = fresh_ms["pipelined_wav"]
    frames, preset_frames = train_batch * t_out, preset_batch * t_out
    serve_audio_s = sv["serve_samples"] / sr
    serve_throughput = serve_audio_s / sv["serving"][0]
    ms = 1e3

    detail = {
        "batch": batch,
        "decode_steps": max_steps,
        "reps": reps,
        "audio_seconds_per_batch": audio_seconds,
        "device_batch_seconds": raw_s,
        "device_batch_seconds_p10_p90": list(syn["raw"][1:]),
        "serving_audio_s_per_s": serve_throughput,
        "serving_batch": batch,
        "serving_batch_seconds": sv["serving"][0],
        "serving_batch_seconds_p10_p90": list(sv["serving"][1:]),
        "serving_vs_raw": serve_throughput / device_throughput,
        "serving_fast_audio_s_per_s": serve_audio_s / sv["serving_fast"][0],
        "serving_fast_batch_seconds": sv["serving_fast"][0],
        "serving_fast_vs_raw": (serve_audio_s / sv["serving_fast"][0]
                                / device_throughput),
        "serving_fast_config": {
            "fast_vocoder": True, "return_alignments": False,
            "note": "the recommended serving preset: 30 Griffin-Lim "
                    "iterations at momentum 0.99"},
        "serving_mulaw8_audio_s_per_s": (serve_audio_s
                                         / sv["serving_mulaw8"][0]),
        "serving_mulaw8_batch_seconds": sv["serving_mulaw8"][0],
        "serving_mulaw8_vs_raw": (serve_audio_s / sv["serving_mulaw8"][0]
                                  / device_throughput),
        "serving_mulaw8_note": "fast preset + wire_format='mulaw8': the "
                               "audio crosses to the host as 8-bit mu-law, "
                               "half the bytes of int16",
        "serving_latency_1utt_ms": sv["serving_latency_1utt"][0] * ms,
        "serving_latency_1utt_ms_p10_p90": [
            x * ms for x in sv["serving_latency_1utt"][1:]],
        "serving_latency_note": "one text -> audio through "
                                "Synthesizer.synthesize, fast preset, "
                                "replayed",
        "serving_default_latency_1utt_ms": (
            sv["serving_default_1utt"][0] * ms),
        "serving_default_latency_1utt_ms_p10_p90": [
            x * ms for x in sv["serving_default_1utt"][1:]],
        "serving_default_audio_s_per_s": (
            sv["default_batch_samples"] / sr
            / sv["serving_default_batch"][0]),
        "serving_default_1utt_samples": int(sv["default_samples"]),
        "serving_default_note": "max_steps omitted (the server's default): "
                                "the length-adaptive decode budget (200 "
                                "steps for these texts: the spectral-step "
                                "and overlap-add kernels) and "
                                "the attention and dB trims. With random "
                                "weights the trims cut most of the audio, "
                                "so latency is the number to read",
        "serving_phase_budget_ms": sv["phase_budget"],
        "serving_phase_note": "the fast call at the batch, replayed, with "
                              "collect_timings (median): dispatch = the "
                              "host until the last chunk is launched; "
                              "device = until a one-element fetch from the "
                              "last chunk returns; fetch = the bulk int16 "
                              "copy; frontend/post = host text and unpack "
                              "work",
        "long_text_audio_s_per_s": (sv["long_samples"] / sr
                                    / sv["long_text"][0]),
        "long_text_seconds": sv["long_text"][0],
        "long_text_chunks": int(sv["long_chunks"]),
        "long_text_audio_s": sv["long_samples"] / sr,
        "long_text_note": "a 4-sentence paragraph through synthesize_long "
                          "(sentence split -> one batched decode -> "
                          "silence stitch), fast preset, adaptive budget, "
                          "replayed",
        "serving_concurrent_levels": sv["concurrent"]["levels"],
        "serving_concurrent_note":
            "the port's SynthWorker + HTTP server on 127.0.0.1 under N "
            "closed-loop clients (unique short texts, one token bucket, "
            "prewarmed: each call replays). max_batch=4 rows batch "
            "requests dynamically; max_batch=1 rows are the serial A/B. "
            "batched_calls counts coalesced groups; k1/k2/k3_launches count "
            "eager calls only (a replay launches without the wrappers)",
        "fast_gla_audio_s_per_s": audio_seconds / fast_s,
        "fast_gla_batch_seconds": fast_s,
        "fast_gla_config": {"iters": 30, "momentum": 0.99,
                            "note": "the raw program with the fast "
                                    "vocoder"},
        "cpu_baseline_audio_s_per_s": host_throughput,
        "training_batch": train_batch,
        "training_frames_per_s_per_chip": frames / chain_step,
        "training_step_seconds": chain_step,
        "training_step_seconds_p10_p90": [x / chain
                                          for x in tr["chain"][1:]],
        "training_chain_length": chain,
        "training_synced_frames_per_s": frames / tr["synced"][0],
        "training_synced_step_seconds": tr["synced"][0],
        "training_synced_step_seconds_p10_p90": list(tr["synced"][1:]),
        "training_scan_unroll": None,
        "training_scan_unroll_note": "XLA's scan unroll has no counterpart "
                                     "in the port (left out on purpose)",
        "training_note": "frames_per_s is steady state (a chain of "
                         "replayed steps, one sync at its end, as the "
                         "driver runs); synced_* waits for every step",
        "training_bf16_frames_per_s": frames / bf16_step,
        "training_bf16_step_seconds": bf16_step,
        "training_bf16_note": "compute_dtype=bfloat16 (parameters and "
                              "optimizer state float32), replayed chain",
        "training_fresh_batch_step_ms": fresh_ms["fresh_spec"],
        "training_fresh_batch_waveform_step_ms": fresh_ms["fresh_wav"],
        "training_fresh_batch_bytes": [int(b) for b in tr["fresh_bytes"]],
        "training_fresh_batch_note":
            "a fresh host batch every step, copied before its step "
            "(prefetch depth 0): f32 spectrogram targets against int16 "
            "waveforms + on-device features (on_device_features)",
        "training_live_step_ms": live_ms,
        "training_live_frames_per_s_per_chip": frames / (live_ms / ms),
        "training_live_prefetch_depth": PREFETCH_DEPTH,
        "training_live_note":
            "what `python -m tacotron_tpu_torch.train` runs per step: a "
            "fresh waveform batch every step at the driver's prefetch "
            "depth (training_live_prefetch_depth)",
        "training_pipelined_step_ms": fresh_ms["pipelined_wav"],
        "training_pipelined_spectrogram_step_ms":
            fresh_ms["pipelined_spec"],
        "training_pipelined_note":
            "the prefetch pipeline (parallel/prefetch.py): batch k+1 "
            "copied on a side stream while step k runs; one prefetcher "
            "feeds every timed run and is started and stopped outside "
            "them (the driver's steady state)",
        "training_preset_batch": preset_batch,
        "training_preset_frames_per_s_per_chip": preset_frames / preset_step,
        "training_preset_step_seconds": preset_step,
        "training_preset_live_step_ms": fresh_ms["preset_live"],
        "training_preset_live_frames_per_s_per_chip": (
            preset_frames / (fresh_ms["preset_live"] / ms)),
        "training_preset_mfu_pct": mfu(preset_model["total_flops"],
                                       preset_step, H100_BF16_PEAK_TFLOPS),
        "training_resident_step_ms": fresh_ms["resident"],
        "training_resident_frames_per_s_per_chip": (
            preset_frames / (fresh_ms["resident"] / ms)),
        "training_resident_note":
            "the preset with the waveforms resident on the card: each "
            "step ships the small fields and an int32 index array and "
            "gathers on the card (data/resident.py)",
        "training_preset_note":
            "Config.tpu_recommended (train --preset tpu): bf16 compute, "
            "int16 waveform wire + on-device features, at "
            "training_preset_batch; frames_per_s is the replayed chain on "
            "one resident batch, live_* a fresh batch every step through "
            "the prefetcher",
        "training_mfu_pct": mfu(tr_model["total_flops"], chain_step),
        "training_bf16_mfu_pct": mfu(tr_model["total_flops"], bf16_step,
                                     H100_BF16_PEAK_TFLOPS),
        "training_total_gflops_per_step": tr_model["total_flops"] / 1e9,
        "training_sequential_scan_iterations": int(
            tr_model["sequential_iterations_total"]),
        "training_roofline_note":
            "model matmul FLOPs (train/roofline.py) over the replayed "
            "step: float32 against the H100's 67 TFLOP/s float32 peak, "
            "bf16 and the preset against its 989 TFLOP/s bf16 peak",
        "roofline": {
            "gl_matmul_tflop_per_batch": gl_flops / 1e12,
            "achieved_tflop_s_lower_bound": achieved_tflops,
            "bf16_peak_tflop_s": H100_BF16_PEAK_TFLOPS,
            "tensor_core_utilization_pct": (100 * achieved_tflops
                                            / H100_BF16_PEAK_TFLOPS),
            "note": "the u/v Griffin-Lim products of the raw program "
                    "(ops/kernels/gl_fused.py::iteration_flops) over its "
                    "whole replayed time, decode included: a lower bound "
                    "of the vocoder's rate",
        },
        "device": device_line(synth.device),
        # the port's additions
        "eager_device_batch_seconds": syn["raw_eager"][0],
        "eager_device_batch_seconds_p10_p90": list(syn["raw_eager"][1:]),
        "eager_audio_s_per_s": audio_seconds / syn["raw_eager"][0],
        "eager_fast_gla_batch_seconds": syn["fast_gla_eager"][0],
        "eager_fast_gla_audio_s_per_s": (audio_seconds
                                         / syn["fast_gla_eager"][0]),
        "eager_serving_batch_seconds": sv["serving_eager"][0],
        "eager_serving_audio_s_per_s": (serve_audio_s
                                        / sv["serving_eager"][0]),
        "eager_serving_latency_1utt_ms": (
            sv["serving_latency_1utt_eager"][0] * ms),
        "eager_serving_latency_1utt_ms_p10_p90": [
            x * ms for x in sv["serving_latency_1utt_eager"][1:]],
        "eager_training_step_seconds": tr["chain_eager"][0] / chain,
        "eager_training_frames_per_s_per_chip": (
            frames / (tr["chain_eager"][0] / chain)),
        "eager_note": "the same calls without CUDA graphs: every kernel "
                      "launched from the host",
        "replay_vs_eager": syn["replay_err"],
        "replay_vs_eager_note": "the raw and fast programs' replayed "
                                "waveforms against their eager first "
                                "call's on the same inputs: the largest "
                                "difference over the eager peak",
        "prewarm_s": h.prewarm_s,
        "launches": h.launches,
        "launches_note": "K1 (gl_iteration), K2 (overlap_add_batched) and "
                         "K3 (spectral_step) launches of each section's "
                         "first call, made "
                         "eagerly before its programs are captured",
    }
    detail["wall_s"] = time.perf_counter() - t_start
    return {"metric": "synthesis_throughput",
            "value": round(device_throughput, 2),
            "unit": "audio-seconds/s/chip",
            "vs_baseline": round(device_throughput / host_throughput, 2),
            "detail": detail}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from .utils.misc import device_line

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; raises "
                             "without one; cpu for the CPU)")
    parser.add_argument("--out", default=DEFAULT_OUT,
                        help="the full record (JSON)")
    args = parser.parse_args(argv)

    cfg = Config()
    synth = Synthesizer(device=args.device).init_random(cfg)
    print(f"[*] device: {device_line(synth.device)}", flush=True)
    record = run(synth, cfg)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w", encoding="utf-8") as fh:
        json.dump(record, fh, indent=2)
    print(headline_line(record, args.out), flush=True)
    return record


if __name__ == "__main__":
    main()
