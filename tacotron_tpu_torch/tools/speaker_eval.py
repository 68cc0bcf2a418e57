"""Multi-speaker evaluation harness.

Synthesizes a fixed sentence set for every speaker of a multi-speaker model
in ONE batched call and reports per-speaker acoustic and attention
statistics, so per-speaker regressions — one speaker's attention
collapsing, loudness or speaking-rate drift after fine-tuning — are visible
at a glance instead of requiring someone to listen to every wav.

A copy of the JAX package's ``tools/speaker_eval.py`` on the port's
:class:`~tacotron_tpu_torch.synth.Synthesizer`.  This is a quality lever
beyond the reference, which only writes wav/png dumps per speaker (its
``eval.py:69-147``) and leaves comparison to the ear.  The attention
diagnostics reuse
:func:`tacotron_tpu_torch.synth.synthesizer.attention_health`.  On the
card the batched call runs the vocoder kernels: the fused Griffin-Lim
iteration for decodes of up to 383 frames, the spectral-step and
overlap-add kernels beyond.

CLI (on the card; ``--device cpu`` runs on the CPU)::

    python -m tacotron_tpu_torch.tools.speaker_eval --load_path logs/park \
        --speakers 0,1 --out report.json [--save_dir eval_wavs]

The JAX CLI first enables its persistent XLA compilation cache; the port
compiles nothing per shape, so it has no counterpart.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import Config
from ..dsp import host as dsp_host
from ..synth.synthesizer import Synthesizer, attention_health
from ..text.eval_sentences import EVAL_TEXTS


def acoustic_stats(wav: np.ndarray, sample_rate: int,
                   frame: int = 1024, hop: int = 256,
                   silence_db: float = -40.0) -> Dict[str, float]:
    """Host-side summary statistics of one waveform.

    duration_s, rms, peak, silence_fraction (frames whose RMS sits below
    ``silence_db`` relative to the utterance peak RMS) and the mean spectral
    centroid in Hz (brightness — a cheap proxy separating muffled/collapsed
    decodes from normal speech).
    """
    wav = np.asarray(wav, np.float32)
    out = {"duration_s": len(wav) / sample_rate,
           "rms": float(np.sqrt(np.mean(wav ** 2))) if wav.size else 0.0,
           "peak": float(np.max(np.abs(wav))) if wav.size else 0.0}
    if len(wav) < frame:
        out.update(silence_fraction=0.0, spectral_centroid_hz=0.0)
        return out
    frames, rms = dsp_host.frame_rms(wav, frame, hop)
    ref = float(rms.max())
    db = dsp_host.rms_db_below_peak(rms)
    out["silence_fraction"] = (float((db < silence_db).mean())
                               if db is not None else 1.0)
    mag = np.abs(np.fft.rfft(frames * np.hanning(frame), axis=1))
    freqs = np.fft.rfftfreq(frame, 1.0 / sample_rate)
    denom = np.maximum(mag.sum(axis=1), 1e-10)
    centroids = (mag * freqs[None, :]).sum(axis=1) / denom
    voiced = rms > 0.1 * ref
    out["spectral_centroid_hz"] = float(
        centroids[voiced].mean() if voiced.any() else centroids.mean())
    return out


def _aggregate(utts: List[Dict]) -> Dict[str, float]:
    """Per-speaker aggregate over the utterance records."""

    def mean(key_path):
        vals = [u[key_path[0]][key_path[1]] for u in utts]
        return float(np.mean(vals)) if vals else 0.0

    n = len(utts)
    ok = sum(1 for u in utts if u["attention"]["ok"])
    # both gate families, so cross-attention-type comparisons are read
    # against the SAME bar (ok_rate alone follows the per-type gate)
    ok_sharp = sum(1 for u in utts if u["attention"]["ok_sharpness"])
    ok_soft = sum(1 for u in utts if u["attention"]["ok_soft_monotonic"])
    return {
        "num_utterances": n,
        "attention_ok_rate": ok / n if n else 0.0,
        "attention_gate": (utts[0]["attention"]["gate"] if n else ""),
        "attention_ok_rate_sharpness": ok_sharp / n if n else 0.0,
        "attention_ok_rate_soft_monotonic": ok_soft / n if n else 0.0,
        "mean_coverage": mean(("attention", "coverage")),
        "mean_focus": mean(("attention", "focus")),
        "mean_monotonicity": mean(("attention", "monotonicity")),
        "mean_path_coverage": mean(("attention", "path_coverage")),
        "mean_duration_s": mean(("audio", "duration_s")),
        "mean_rms": mean(("audio", "rms")),
        "mean_silence_fraction": mean(("audio", "silence_fraction")),
        "mean_spectral_centroid_hz": mean(("audio", "spectral_centroid_hz")),
        "mean_seconds_per_token": float(np.mean(
            [u["audio"]["duration_s"] / max(u["num_tokens"], 1)
             for u in utts])) if n else 0.0,
    }


def evaluate_speakers(synth: Synthesizer,
                      texts: Optional[Sequence[str]] = None,
                      speakers: Optional[Sequence[int]] = None,
                      max_steps: Optional[int] = None,
                      fast_vocoder: bool = True,
                      health_kwargs: Optional[Dict] = None,
                      save_dir: Optional[str] = None) -> Dict:
    """Synthesize ``texts`` x ``speakers`` (one batched call — every
    (sentence, speaker) pair rides the same bucketed fused program) and
    return the per-speaker report.

    Report layout::

        {"speakers": {"0": {"utterances": [...], "aggregate": {...}}, ...},
         "cross_speaker": {...}, "config": {...}}

    ``cross_speaker`` summarizes spread between speakers (max/min ratios of
    loudness and speaking rate, worst attention_ok_rate) — the numbers to
    watch when one speaker of a multi-speaker model degrades.
    """
    texts = list(texts if texts is not None else EVAL_TEXTS)
    num_speakers = synth.config.model.num_speakers
    if speakers is None:
        speakers = list(range(max(1, num_speakers)))
    all_texts = [t for _ in speakers for t in texts]
    speaker_ids = [s for s in speakers for _ in texts]

    res = synth.synthesize(texts=all_texts, speaker_ids=speaker_ids,
                           max_steps=max_steps, fast_vocoder=fast_vocoder,
                           return_alignments=True)
    sr = synth.config.audio.sample_rate
    health_kwargs = dict(health_kwargs or {})
    # judge bah_mon by what soft-monotonic attention can exhibit
    # (path coverage + monotonicity) — see attention_health docstring
    health_kwargs.setdefault(
        "soft_monotonic",
        synth.config.model.attention_type == "bah_mon")

    report: Dict = {"speakers": {}, "cross_speaker": {}}
    for si, spk in enumerate(speakers):
        utts = []
        for ti, text in enumerate(texts):
            k = si * len(texts) + ti
            align = np.asarray(res["alignments"][k])
            utts.append({
                "text": text,
                "num_tokens": len(res["sequences"][k]),
                "attention": attention_health(align,
                                              **(health_kwargs or {})),
                "audio": acoustic_stats(res["wavs"][k], sr),
            })
            if save_dir:
                os.makedirs(save_dir, exist_ok=True)
                dsp_host.save_audio(
                    res["wavs"][k],
                    os.path.join(save_dir, f"spk{spk}_utt{ti}.wav"),
                    synth.config.audio)
        report["speakers"][str(spk)] = {
            "utterances": utts, "aggregate": _aggregate(utts)}

    aggs = [v["aggregate"] for v in report["speakers"].values()]
    if aggs:
        rms = [a["mean_rms"] for a in aggs]
        rate = [a["mean_seconds_per_token"] for a in aggs]
        report["cross_speaker"] = {
            "num_speakers": len(aggs),
            "attention_gate": aggs[0]["attention_gate"],
            "worst_attention_ok_rate": min(a["attention_ok_rate"]
                                           for a in aggs),
            "worst_attention_ok_rate_sharpness": min(
                a["attention_ok_rate_sharpness"] for a in aggs),
            "worst_attention_ok_rate_soft_monotonic": min(
                a["attention_ok_rate_soft_monotonic"] for a in aggs),
            "worst_path_coverage": min(a["mean_path_coverage"]
                                       for a in aggs),
            "rms_spread_ratio": (max(rms) / max(min(rms), 1e-10)),
            "seconds_per_token_spread_ratio": (
                max(rate) / max(min(rate), 1e-10)),
        }
    return report


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--load_path", default=None,
                        help="run directory to evaluate")
    parser.add_argument("--random_init", action="store_true",
                        help="random weights (harness smoke test)")
    parser.add_argument("--speakers", default=None,
                        help="comma-separated speaker ids (default: all)")
    parser.add_argument("--texts", nargs="*", default=None)
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--classic_vocoder", action="store_true")
    parser.add_argument("--save_dir", default=None,
                        help="also dump per-(speaker, utterance) wavs here")
    parser.add_argument("--out", default=None,
                        help="write the JSON report here (default: stdout)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; raises without "
                             "a card)")
    args = parser.parse_args(argv)

    synth = Synthesizer(device=args.device)
    if args.random_init:
        synth.init_random(Config())
    elif args.load_path:
        synth.load(args.load_path)
    else:
        parser.error("--load_path required (or pass --random_init)")

    speakers = ([int(s) for s in args.speakers.split(",")]
                if args.speakers else None)
    report = evaluate_speakers(synth, texts=args.texts, speakers=speakers,
                               max_steps=args.max_steps,
                               fast_vocoder=not args.classic_vocoder,
                               save_dir=args.save_dir)
    payload = json.dumps(report, ensure_ascii=False, indent=2)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(payload)
        print(f"[*] wrote {args.out}")
        cross = report["cross_speaker"]
        for spk, rec in report["speakers"].items():
            agg = rec["aggregate"]
            print(f"    speaker {spk}: attention_ok "
                  f"{agg['attention_ok_rate']:.0%}, "
                  f"rms {agg['mean_rms']:.3f}, "
                  f"{agg['mean_seconds_per_token'] * 1e3:.0f} ms/token")
        if cross:
            print(f"    cross-speaker: worst attention_ok "
                  f"{cross['worst_attention_ok_rate']:.0%}, rms spread "
                  f"x{cross['rms_spread_ratio']:.2f}")
    else:
        print(payload)


if __name__ == "__main__":
    main()
