"""Synthesis throughput sweep: batch size x Griffin-Lim engine x momentum.
A port of the repo's ``scripts/synth_sweep.py``, whose points inform the
benchmark's headline configuration and the serving batch.

``Config()`` with random weights from seed 0, the four Korean texts of
the script in the 64-token bucket, 50 decode steps; at batch 16, 32 and 64
the four points (``matmul_bf16``, 60, 0.0), (``matmul_bf16``, 30, 0.99),
(``pallas``, 60, 0.0) and (``pallas``, 30, 0.99).  One JSON line a point::

    {"batch": B, "impl": ..., "iters": N, "momentum": a,
     "batch_seconds": t, "audio_s_per_s": x, "spectral_convergence": c,
     "eager_seconds": t, "eager_audio_s_per_s": x, "capture_s": t,
     "k2_launches": n, "k3_launches": n}

The script times the compiled program (``jax.jit``) of decode plus
vocoder; its counterpart here is that function captured once as a CUDA
graph (``utils/graphs.py``) and replayed: ``batch_seconds`` is the
replay's wall, and ``eager_seconds`` the same function called eagerly.
Each is the median of 10 calls after 3 warm-ups, with a scalar checksum
fetched inside the timed region.  ``spectral_convergence`` is the
script's: the STFT magnitude of utterance 0's waveform against the
denormalized magnitude of its decoded spectrogram.  The launch counts are
those of one eager call (the ``pallas`` engine runs the spectral-step
kernel once an iteration and the overlap-add kernel once more; a replay
launches them without the wrappers)::

    python -m tacotron_tpu_torch.studies.synth_sweep [--out sweep.jsonl]

``--device cpu`` runs it on the CPU (there is no graph to replay;
``batch_seconds`` times the same bookkeeping on static buffers).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..dsp import chip as dsp_chip
from ..dsp import host as dsp_host
from ..ops.kernels.griffin_lim import spectral_step
from ..ops.kernels.ola import overlap_add_batched
from ..text import text_to_sequence
from ..utils.graphs import GraphSet

TEXTS = [
    "안녕하세요 오늘은 정말 좋은 날씨입니다 함께 산책을 나가요",
    "음성 합성 시스템의 품질을 평가하기 위한 문장입니다",
    "어제 저녁에는 친구들과 함께 맛있는 식사를 했습니다",
    "대한민국의 수도는 서울이며 많은 사람들이 살고 있습니다",
]
#: (engine, iterations, momentum) of each point
POINTS = (("matmul_bf16", 60, 0.0), ("matmul_bf16", 30, 0.99),
          ("pallas", 60, 0.0), ("pallas", 30, 0.99))
BATCHES = (16, 32, 64)
MAX_STEPS = 50
BUCKET = 64


def make_inputs(synth, B: int, bucket: int = BUCKET):
    """The script's batch: the texts repeated to ``B`` rows, cut to
    ``bucket`` tokens: (ids [B, bucket], lengths [B]) on the device."""
    cfg = synth.config
    seqs = [text_to_sequence(t, list(cfg.data.cleaner_names()))
            for t in TEXTS]
    inputs = np.zeros((B, bucket), np.int64)
    for i in range(B):
        s = seqs[i % len(seqs)]
        inputs[i, :min(len(s), bucket)] = s[:bucket]
    lengths = np.asarray([min(len(seqs[i % len(seqs)]), bucket)
                          for i in range(B)], np.int64)
    return (torch.from_numpy(inputs).to(synth.device),
            torch.from_numpy(lengths).to(synth.device))


def timed(fn, reps: int = 10, warmup: int = 3) -> float:
    """Median wall seconds of ``fn()`` (which fetches a scalar) over
    ``reps`` calls after ``warmup``."""
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(statistics.median(ts))


def spectral_convergence(spec0: np.ndarray, wav0: np.ndarray,
                         audio) -> float:
    """||STFT magnitude of ``wav0`` - target|| / ||target|| over their
    common frames, the target the denormalized magnitude of the
    normalized linear spectrogram ``spec0`` [frames, F]."""
    S = dsp_chip.db_to_amp(
        dsp_chip.denormalize_db(torch.from_numpy(spec0), audio)
        + audio.ref_level_db).numpy() ** audio.power
    est = np.abs(dsp_host.stft(np.asarray(wav0), audio)).T
    n = min(len(est), len(S))
    return float(np.linalg.norm(est[:n] - S[:n]) / np.linalg.norm(S[:n]))


def full_program(synth, audio, max_steps: int = MAX_STEPS):
    """Decode plus vocoder of a batch: (wavs, sum |wavs|), the function
    the script compiles for each point."""
    model = synth.model

    def full(inp, lens):
        with torch.no_grad():
            linear = model(inp, lens, max_steps=max_steps)["linear_outputs"]
            wavs = dsp_chip.batched_linear_to_waveform(linear, audio)
            return wavs, wavs.abs().sum()

    return full


def sweep_point(synth, inp, lens, spec0: np.ndarray, impl: str, iters: int,
                momentum: float, max_steps: int = MAX_STEPS,
                reps: int = 10, warmup: int = 3) -> dict:
    """One point: the eager call counted and timed, then the same function
    captured and its replay timed, and the spectral convergence of the
    replay's utterance 0."""
    cfg = synth.config
    audio = dataclasses.replace(cfg.audio, griffin_lim_impl=impl,
                                griffin_lim_iters=iters,
                                griffin_lim_momentum=momentum)
    full = full_program(synth, audio, max_steps)
    B = inp.shape[0]
    k2, k3 = overlap_add_batched.launches, spectral_step.launches
    _, chk = full(inp, lens)
    launches = {"k2_launches": overlap_add_batched.launches - k2,
                "k3_launches": spectral_step.launches - k3}
    if not np.isfinite(float(chk)):
        raise RuntimeError(f"{impl} at batch {B}: checksum {float(chk)}")
    eager_s = timed(lambda: float(full(inp, lens)[1]), reps, warmup)
    t0 = time.perf_counter()
    graphed = GraphSet(synth.device).capture(full, inp, lens)
    capture_s = time.perf_counter() - t0
    replay_s = timed(lambda: float(graphed(inp, lens)[1]), reps, warmup)
    wavs, chk = graphed(inp, lens)
    if not np.isfinite(float(chk)):
        raise RuntimeError(f"{impl} at batch {B}: replay checksum "
                           f"{float(chk)}")
    audio_s = B * max_steps * cfg.model.reduction_factor \
        * audio.hop_length / audio.sample_rate
    conv = spectral_convergence(spec0, wavs[0].float().cpu().numpy(), audio)
    del graphed
    return {"batch": B, "impl": impl, "iters": iters,
            "momentum": momentum,
            "batch_seconds": round(replay_s, 4),
            "audio_s_per_s": round(audio_s / replay_s, 1),
            "spectral_convergence": round(conv, 4),
            "eager_seconds": round(eager_s, 4),
            "eager_audio_s_per_s": round(audio_s / eager_s, 1),
            "capture_s": round(capture_s, 3), **launches}


def sweep(synth, batches: Sequence[int] = BATCHES, points=POINTS,
          max_steps: int = MAX_STEPS, out=None) -> list:
    """Every point at every batch size, one decode a batch size for the
    convergence target; each point printed (and written to ``out``) as one
    JSON line."""
    results = []
    for B in batches:
        inp, lens = make_inputs(synth, B)
        with torch.no_grad():
            specs = synth.model(inp, lens, max_steps=max_steps)[
                "linear_outputs"]
        spec0 = specs[0].float().cpu().numpy()
        for impl, iters, momentum in points:
            point = sweep_point(synth, inp, lens, spec0, impl, iters,
                                momentum, max_steps)
            results.append(point)
            line = json.dumps(point)
            print(line, flush=True)
            if out is not None:
                out.write(line + "\n")
                out.flush()
    return results


def main(argv: Optional[Sequence[str]] = None) -> list:
    from ..synth import Synthesizer
    from ..utils.misc import device_line

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", default=None,
                        help="also write the points (JSON lines) here")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; raises "
                             "without one; cpu for the CPU)")
    args = parser.parse_args(argv)

    synth = Synthesizer(device=args.device).init_random(Config())
    print(f"[*] device: {device_line(synth.device)}", flush=True)
    out = open(args.out, "w", encoding="utf-8") if args.out else None
    try:
        return sweep(synth, BATCHES, POINTS, MAX_STEPS, out=out)
    finally:
        if out is not None:
            out.close()


if __name__ == "__main__":
    main()
