"""Silence-based utterance splitting (host-side numpy).

A copy of the JAX package's ``tools/silence.py``, successor to the
reference's ``audio/silence.py:21-143``, without the
librosa/pydub dependencies: non-silent interval detection is a framewise RMS
threshold against the signal peak (librosa.effects.split semantics), breath
removal zeroes quiet sub-intervals, and segments are bounded to the
reference's 3..8 s serving window.
"""

from __future__ import annotations

import argparse
import os
from glob import glob
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..config import AudioConfig
from ..dsp import host as dsp


def _frame_rms(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    if len(y) < frame_length:
        y = np.pad(y, (0, frame_length - len(y)))
    n = 1 + (len(y) - frame_length) // hop_length
    idx = (np.arange(frame_length)[None, :]
           + hop_length * np.arange(n)[:, None])
    return np.sqrt(np.mean(y[idx] ** 2, axis=1))


def detect_nonsilent(y: np.ndarray, top_db: float = 40.0,
                     frame_length: int = 1024,
                     hop_length: int = 256) -> np.ndarray:
    """[start, end) sample intervals louder than ``top_db`` below the peak
    (librosa.effects.split semantics)."""
    rms = _frame_rms(y, frame_length, hop_length)
    ref = rms.max()
    if ref <= 0:
        return np.zeros((0, 2), np.int64)
    db = 20.0 * np.log10(np.maximum(rms / ref, 1e-10))
    nonsilent = db > -top_db
    edges = np.diff(nonsilent.astype(np.int8), prepend=0, append=0)
    starts = np.flatnonzero(edges == 1)
    ends = np.flatnonzero(edges == -1)
    intervals = np.stack([starts, ends], axis=1) * hop_length
    return np.minimum(intervals, len(y))


def remove_breath(y: np.ndarray) -> np.ndarray:
    """Zero quiet sub-intervals (breaths): mean |amplitude| more than 0.05
    below the utterance mean (reference ``silence.py:20-30``)."""
    y = y.copy()
    overall = np.abs(y).mean()
    for start, end in detect_nonsilent(y, top_db=40, frame_length=128,
                                       hop_length=32):
        seg = y[start:end]
        if seg.size and np.abs(seg).mean() < overall - 0.05:
            y[start:end] = 0.0
    return y


def split_on_silence(audio_path: str,
                     config: Optional[AudioConfig] = None,
                     top_db: float = 40.0,
                     frame_length: int = 1024,
                     hop_length: int = 256,
                     skip_idx: int = 0,
                     min_segment_length: float = 3.0,
                     max_segment_length: float = 8.0,
                     pre_silence_length: float = 0.0,
                     post_silence_length: float = 0.0,
                     out_ext: str = "wav",
                     breath_removal: bool = True) -> List[str]:
    """Split one long recording into utterance wavs next to it
    (reference ``split_on_silence_with_librosa``, ``silence.py:33-76``)."""
    config = config or AudioConfig()
    filename = os.path.basename(audio_path).split(".", 1)[0]
    audio = dsp.load_audio(audio_path, config)
    sr = config.sample_rate

    if breath_removal:
        cleaned = np.zeros_like(audio)
        for start, end in detect_nonsilent(audio, top_db, frame_length,
                                           hop_length)[skip_idx:]:
            cleaned[start:end] = remove_breath(audio[start:end])
        audio = cleaned

    paths = []
    for idx, (start, end) in enumerate(
            detect_nonsilent(audio, top_db, frame_length,
                             hop_length)[skip_idx:]):
        segment = audio[start:end]
        duration = len(segment) / sr
        if duration <= min_segment_length or duration >= max_segment_length:
            continue
        out_path = os.path.join(
            os.path.dirname(audio_path),
            f"{filename}.{idx:04d}.{out_ext}")
        padded = np.concatenate([
            np.zeros(int(sr * pre_silence_length), np.float32),
            segment,
            np.zeros(int(sr * post_silence_length), np.float32)])
        dsp.save_audio(padded, out_path, config)
        paths.append(out_path)
    return paths


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        description="split long recordings on silence into utterances")
    parser.add_argument("audio_pattern",
                        help="glob of input audio files (wav)")
    parser.add_argument("--top_db", type=float, default=40.0)
    parser.add_argument("--min_segment_length", type=float, default=3.0)
    parser.add_argument("--max_segment_length", type=float, default=8.0)
    parser.add_argument("--no_breath_removal", action="store_true")
    args = parser.parse_args(argv)

    for path in sorted(glob(args.audio_pattern)):
        out = split_on_silence(
            path, top_db=args.top_db,
            min_segment_length=args.min_segment_length,
            max_segment_length=args.max_segment_length,
            breath_removal=not args.no_breath_removal)
        print(f"[*] {path}: {len(out)} segments")


if __name__ == "__main__":
    main()
