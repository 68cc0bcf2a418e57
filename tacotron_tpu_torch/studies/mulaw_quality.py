"""mulaw8 wire quality on real synthesized content: a port of the repo's
``scripts/mulaw_quality.py``.

The 8-bit mu-law serving wire halves the bulk waveform fetch.  This
measures its price on the path users hear: the same sentences synthesized
from a trained run twice, ``wire_format="int16"`` and ``"mulaw8"`` (the
same decode and fast vocoder; only the wire differs), compared by
log-spectral distance (LSD: the RMSE of per-bin dB log-power) and
time-domain SNR.

    python -m tacotron_tpu_torch.studies.mulaw_quality \
        --load_path /tmp/tacotron_convergence/run \
        --texts_json /tmp/tacotron_convergence/corpus/heldout.json

``--device cpu`` runs it on the CPU (the default is the card).
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np


def log_spectral_distance(a: np.ndarray, b: np.ndarray,
                          n_fft: int = 1024, hop: int = 256,
                          floor_db: Optional[float] = -60.0) -> float:
    """LSD in dB between two waveforms (truncated to the common length):
    sqrt(mean over bins of (10*log10 P_a - 10*log10 P_b)^2), averaged over
    frames.

    ``floor_db`` clamps both power spectra at ``peak + floor_db`` dB (the
    usual dynamic-range cap): without it, bins that are silent in the
    reference but hold mu-law quantization noise in the test signal
    contribute log-ratios of 60-80 dB each, and the metric measures the
    noise floor's depth, not audible distortion.  ``None`` gives the raw
    unfloored value."""
    n = min(len(a), len(b))
    a, b = a[:n].astype(np.float64), b[:n].astype(np.float64)
    win = np.hanning(n_fft)
    frames = 1 + max(0, (n - n_fft) // hop)

    def power(x):
        idx = (np.arange(n_fft)[None, :]
               + hop * np.arange(frames)[:, None])
        return np.abs(np.fft.rfft(x[idx] * win, axis=1)) ** 2

    pa, pb = power(a) + 1e-12, power(b) + 1e-12
    if floor_db is not None:
        floor = max(pa.max(), pb.max()) * 10.0 ** (floor_db / 10.0)
        pa, pb = np.maximum(pa, floor), np.maximum(pb, floor)
    d = 10.0 * np.log10(pa) - 10.0 * np.log10(pb)
    return float(np.sqrt((d ** 2).mean(axis=1)).mean())


def snr_db(ref: np.ndarray, test: np.ndarray) -> float:
    """Signal-to-noise ratio of ``test`` against ``ref``, in dB."""
    n = min(len(ref), len(test))
    ref, test = ref[:n].astype(np.float64), test[:n].astype(np.float64)
    noise = ref - test
    return float(10.0 * np.log10(
        (ref ** 2).sum() / max((noise ** 2).sum(), 1e-20)))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--load_path", required=True)
    parser.add_argument("--texts_json", default=None,
                        help="JSON list of sentences (default: the "
                             "frontend's eval set)")
    parser.add_argument("--speaker_id", type=int, default=0)
    parser.add_argument("--out", default=None,
                        help="also write the JSON report here")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; raises "
                             "without one; cpu for the CPU)")
    args = parser.parse_args(argv)

    from ..synth import Synthesizer

    if args.texts_json:
        with open(args.texts_json, encoding="utf-8") as fh:
            texts = json.load(fh)
    else:
        from ..text.eval_sentences import EVAL_TEXTS
        texts = list(EVAL_TEXTS)

    synth = Synthesizer(device=args.device).load(args.load_path)
    spk = [args.speaker_id] * len(texts)
    common = dict(texts=texts, speaker_ids=spk, fast_vocoder=True,
                  librosa_trim=False, return_alignments=False)
    ref = synth.synthesize(wire_format="int16", **common)["wavs"]
    mu = synth.synthesize(wire_format="mulaw8", **common)["wavs"]

    lsd = [log_spectral_distance(r, m) for r, m in zip(ref, mu)]
    lsd_raw = [log_spectral_distance(r, m, floor_db=None)
               for r, m in zip(ref, mu)]
    snr = [snr_db(r, m) for r, m in zip(ref, mu)]
    report = {
        "n_utterances": len(texts),
        "lsd_db_mean": round(float(np.mean(lsd)), 3),
        "lsd_db_max": round(float(np.max(lsd)), 3),
        "lsd_floor_db": -60.0,
        "lsd_db_mean_unfloored": round(float(np.mean(lsd_raw)), 3),
        "snr_db_mean": round(float(np.mean(snr)), 2),
        "snr_db_min": round(float(np.min(snr)), 2),
        "note": "int16 wire vs mulaw8 wire, same decode/vocoder — the "
                "distortion is purely the 8-bit companding on the host "
                "link; the waveform fetch halves. LSD uses a -60 dB "
                "dynamic-range floor; the unfloored value measures the "
                "quantization noise floor in silent bins, not audible "
                "distortion",
    }
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=2)
    return report


if __name__ == "__main__":
    main()
