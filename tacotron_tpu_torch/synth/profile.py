"""Where the time of a synthesis call goes, on the card.

    python -m tacotron_tpu_torch.synth.profile [--out profile.json]

Builds the full-width Deep Voice 2 model (``Config()``, two speakers, random
weights from ``--seed``) and, for the three serving rungs that route to the
vocoder kernels (4 sentences x 50 steps with the fast vocoder: the fused
Griffin-Lim chain; 2 sentences x 200 steps with the classic vocoder: past
the fused engine's frame cap, the spectral-step kernel with the overlap-add
kernel; 4 sentences x 50 steps with the fast vocoder and
``griffin_lim_impl="pallas"``: the same kernels), measures:

- the wall time of ``synthesize`` (host clock around a synchronized call),
  and of its two phases run alone: the greedy decode and the vocoder;
- a ``torch.profiler`` trace of one ``synthesize``: device time by kernel,
  grouped (the port's kernels, matrix products, other), and the device's
  busy and idle share of the call's wall time;
- then, after ``Synthesizer.prewarm`` of the rung's key, the same call
  replayed as a CUDA graph: its wall time (``replay_wall_s``) and one trace
  of it (``replay``: device busy time and idle share), beside the eager
  call's in the same run.

Each trace also charges the device's idle gaps to the program's spans
(``idle_ms_by_span``, :class:`TraceWindow`).

Prints one JSON object per rung and writes them all to ``--out``.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import threading
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..utils import trace
from ..utils.misc import card_line

SENTENCES = ["안녕하세요. 만나서 반갑습니다.",
             "오늘 날씨가 참 좋네요.",
             "음성 합성 시스템을 시험하고 있습니다.",
             "감사합니다, 좋은 하루 되세요!"]

RUNGS = [dict(name="50-step, fast vocoder (fused)", n=4, max_steps=50,
              fast_vocoder=True, engine="auto"),
         dict(name="200-step, classic vocoder (spectral step + OLA)",
              n=2, max_steps=200, fast_vocoder=False, engine="auto"),
         dict(name="50-step, fast vocoder (pallas: spectral step + OLA)",
              n=4, max_steps=50, fast_vocoder=True, engine="pallas")]

OWN_KERNELS = ("gl_frame_uv", "gl_dft_project", "gl_idft_window",
               "gl_ola_norm", "ola_centered", "gl_spectral_cast",
               "gl_spectral_dft", "gl_spectral_idft", "gru_input_proj",
               "gru_cluster", "gru_recurrent")


def kernel_group(name: str) -> str:
    for own in OWN_KERNELS:
        if own in name:
            return own
    low = name.lower()
    if "nccl" in low:
        return "collectives (NCCL)"
    if any(k in low for k in ("gemm", "gemv", "xmma", "cutlass", "matmul")):
        return "matrix products (cuBLAS)"
    if "fft" in low:
        return "FFT (cuFFT)"
    if "conv" in low or "cudnn" in low:
        return "convolutions (cuDNN)"
    if "elementwise" in low or "vectorized" in low or "reduce" in low:
        return "elementwise and reductions"
    return "other"


def _wall(fn, repeats: int) -> float:
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def kernel_intervals(prof):
    """(name, start_us, end_us) of every device kernel in the trace, read
    from the profiler's raw events: building its ``FunctionEvent`` list
    (``prof.events()``) is many times slower for the hundreds of thousands
    of kernels, launches and ops of a few train steps."""
    out = []
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == torch.autograd.DeviceType.CUDA:
            start = evt.start_ns() / 1e3
            out.append((evt.name(), start, start + evt.duration_ns() / 1e3))
    return out


def busy_union(intervals, window: Tuple[float, float] = (-math.inf,
                                                           math.inf)
               ) -> List[Tuple[float, float]]:
    """The union of the (name, start_us, end_us) ``intervals`` clipped to
    ``window``, as disjoint sorted (start_us, end_us) pairs."""
    w0, w1 = window
    busy: List[Tuple[float, float]] = []
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if busy and s <= busy[-1][1]:
            busy[-1] = (busy[-1][0], max(busy[-1][1], e))
        else:
            busy.append((s, e))
    return busy


def busy_us(intervals) -> float:
    """The union's length: the device's busy time."""
    return sum(e - s for s, e in busy_union(intervals))


def idle_by_span(intervals, spans: Sequence[trace.Record],
                 window: Tuple[float, float]) -> Dict[str, float]:
    """Each idle gap of the device inside ``window`` (start_us, end_us):
    the stretches that no interval of ``intervals`` (name, start_us,
    end_us) covers, in ms, charged to the innermost span of ``spans``
    (``utils/trace.py`` records, on the same Unix-epoch clock) open at the
    gap's midpoint, the latest-starting one; to "outside the program's
    spans" where none is.  The rule of the benchmark's own trace
    (``perfbench/trace.py``), on the program's spans."""
    w0, w1 = window
    gaps, t = [], w0
    for s, e in busy_union(intervals, window):
        if s > t:
            gaps.append((t, s))
        t = e
    if w1 > t:
        gaps.append((t, w1))
    host = sorted(spans, key=lambda r: r.start_ns)
    out: Dict[str, float] = {}
    for a, b in gaps:
        mid_ns = 0.5 * (a + b) * 1e3
        name = "outside the program's spans"
        for r in host:
            if r.start_ns > mid_ns:
                break
            if r.end_ns >= mid_ns:
                name = r.name
        out[name] = out.get(name, 0.0) + (b - a) / 1e3
    return out


def device_summary(intervals, wall_s: float) -> dict:
    """From the device kernels of a finished trace of ``wall_s`` seconds
    (:func:`kernel_intervals`): their count, their busy time (overlaps
    counted once), the idle share of the wall time (None without a
    kernel), and the device ms and launches by kernel group."""
    by_group: dict = {}
    calls: dict = {}
    for name, s, e in intervals:
        g = kernel_group(name)
        by_group[g] = by_group.get(g, 0.0) + (e - s) / 1e3
        calls[g] = calls.get(g, 0) + 1
    busy_ms = busy_us(intervals) / 1e3
    return {
        "device_kernels": len(intervals),
        "device_busy_ms": busy_ms,
        "device_idle_share": (1.0 - busy_ms / (wall_s * 1e3)
                              if intervals else None),
        "device_ms_by_group": dict(sorted(by_group.items(),
                                          key=lambda kv: -kv[1])),
        "device_launches_by_group": calls,
    }


class TraceWindow:
    """A ``torch.profiler`` trace from :meth:`start` to :meth:`stop`, the
    device synchronized at both ends: the one definition of a traced
    window's wall time and device idle share (the profiles, the train
    driver's ``--profile``), and of where the host was while the device
    idled: the idle gaps charged to the program's spans of the thread that
    opened the window (:func:`idle_by_span`)."""

    def __init__(self, device):
        self.device = torch.device(device)

    def start(self) -> "TraceWindow":
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        self.thread = threading.get_ident()
        # the spans' clock for the join, a monotonic one for the wall time
        self.t0_ns = time.time_ns()
        self.t0 = time.perf_counter()
        return self

    def stop(self, trace_path=None) -> dict:
        """Close the window: its ``wall_s``, :func:`device_summary` and
        ``idle_ms_by_span``; the Chrome trace is written to ``trace_path``
        when given."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1_ns = time.time_ns()
        wall = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        if trace_path:
            self.prof.export_chrome_trace(trace_path)
        intervals = kernel_intervals(self.prof)
        spans = [r for r in trace.records() if r.thread == self.thread
                 and r.end_ns >= self.t0_ns and r.start_ns <= t1_ns]
        return dict(wall_s=wall, **device_summary(intervals, wall),
                    idle_ms_by_span=idle_by_span(
                        intervals, spans, (self.t0_ns / 1e3, t1_ns / 1e3)))


def profile_rung(synth, rung, repeats: int) -> dict:
    from ..dsp import chip as dsp_chip
    from ..text import text_to_sequence

    cfg = synth.config
    texts = SENTENCES[:rung["n"]]
    kw = dict(texts=texts, speaker_ids=[i % 2 for i in range(len(texts))],
              max_steps=rung["max_steps"], fast_vocoder=rung["fast_vocoder"],
              librosa_trim=False)
    res = synth.synthesize(**kw)                     # warm-up
    audio_s = sum(w.size for w in res["wavs"]) / cfg.audio.sample_rate
    wall = _wall(lambda: synth.synthesize(**kw), repeats)

    # the two phases alone, on the same padded batch
    seqs = [text_to_sequence(t, synth.cleaner_names()) for t in texts]
    T_in = max(len(s) for s in seqs)
    ids = np.zeros((len(seqs), T_in), np.int64)
    for i, s in enumerate(seqs):
        ids[i, :len(s)] = s
    dev = synth.device
    ids_t = torch.from_numpy(ids).to(dev)
    lens_t = torch.tensor([len(s) for s in seqs], device=dev)
    spk_t = torch.tensor(kw["speaker_ids"], device=dev)

    def decode():
        with torch.inference_mode():
            return synth.model(ids_t, lens_t, speaker_id=spk_t,
                               max_steps=rung["max_steps"])

    linear = decode()["linear_outputs"]
    audio_cfg = cfg.audio
    if rung["fast_vocoder"]:
        audio_cfg = dataclasses.replace(audio_cfg, griffin_lim_iters=30,
                                        griffin_lim_momentum=0.99)

    def vocode():
        with torch.inference_mode():
            return dsp_chip.batched_linear_to_waveform(linear, audio_cfg)

    decode_s = _wall(decode, repeats)
    vocode_s = _wall(vocode, repeats)

    window = TraceWindow(dev).start()
    synth.synthesize(**kw)
    traced = window.stop()

    # the rung's programs as CUDA graphs
    synth.prewarm(**synth.prewarm_args(texts, max_steps=rung["max_steps"],
                                       fast_vocoder=rung["fast_vocoder"]))
    replayed = synth.synthesize(**kw)
    if replayed["ends"] != res["ends"] or any(
            not np.array_equal(a, b)
            for a, b in zip(replayed["wavs"], res["wavs"])):
        raise RuntimeError(f"{rung['name']}: the replay differs from the "
                           f"eager call")
    replay_wall = _wall(lambda: synth.synthesize(**kw), repeats)
    window = TraceWindow(dev).start()
    synth.synthesize(**kw)
    replay = window.stop()
    return {
        "rung": rung["name"], "batch": rung["n"],
        "max_steps": rung["max_steps"],
        "engine": dsp_chip.resolve_engine(
            audio_cfg, rung["max_steps"] * cfg.model.reduction_factor, dev),
        "audio_s": audio_s, "wall_s": wall,
        "audio_s_per_s": audio_s / wall,
        "decode_s": decode_s, "vocode_s": vocode_s,
        "traced_wall_s": traced.pop("wall_s"), **traced,
        "replay_wall_s": replay_wall,
        "replay_audio_s_per_s": audio_s / replay_wall,
        "replay": replay,
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None, help="write the JSON here")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--repeats", type=int, default=3)
    args = parser.parse_args(argv)

    from ..config import Config
    from .synthesizer import Synthesizer

    base = Config()
    cfg = base.replace(model=dataclasses.replace(
        base.model, model_type="deepvoice", num_speakers=2))
    results = []
    for rung in RUNGS:
        rung_cfg = cfg.replace(audio=dataclasses.replace(
            cfg.audio, griffin_lim_impl=rung["engine"]))
        synth = Synthesizer(device="cuda").init_random(rung_cfg,
                                                       seed=args.seed)
        out = profile_rung(synth, rung, args.repeats)
        print(json.dumps(out), flush=True)
        results.append(out)
    card = card_line()
    print(card)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "rungs": results}, fh, indent=2)


if __name__ == "__main__":
    main()
