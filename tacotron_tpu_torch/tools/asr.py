"""ASR transcription step (Google Cloud Speech), optional dependency.

A copy of the JAX package's ``tools/asr.py``, successor to the reference's
``recognition/google.py``: transcribe each
utterance clip (resampled to 16 kHz), cache per-clip sidecar ``.txt``
results, and merge into ``recognition.json`` for the alignment step.

The Google Cloud client is not vendored in this environment; the module
degrades to a clear error at call time while keeping the pipeline's file
contract importable/testable (``transcribe_batch`` with a custom
``recognize_fn`` is fully offline-testable).
"""

from __future__ import annotations

import argparse
import json
import os
from glob import glob
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from ..config import AudioConfig
from ..dsp import host as dsp

ASR_SAMPLE_RATE = 16000
MAX_CLIP_SECONDS = 60.0


def _default_recognize(audio_16k: np.ndarray, language: str) -> str:
    try:
        from google.cloud import speech  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            "google-cloud-speech is not installed; pass a custom "
            "recognize_fn or install the client to run ASR") from e
    client = speech.SpeechClient()
    pcm = (np.clip(audio_16k, -1, 1) * 32767).astype(np.int16).tobytes()
    audio = speech.RecognitionAudio(content=pcm)
    config = speech.RecognitionConfig(
        encoding=speech.RecognitionConfig.AudioEncoding.LINEAR16,
        sample_rate_hertz=ASR_SAMPLE_RATE,
        language_code=language)
    response = client.recognize(config=config, audio=audio)
    return " ".join(r.alternatives[0].transcript
                    for r in response.results).strip()


def transcribe_file(audio_path: str,
                    language: str = "ko-KR",
                    recognize_fn: Optional[Callable] = None,
                    audio_config: Optional[AudioConfig] = None) -> str:
    """Transcribe one clip; cache the result as a sidecar ``.txt``
    (reference ``google.py:13-97``)."""
    txt_path = os.path.splitext(audio_path)[0] + ".txt"
    if os.path.exists(txt_path):
        with open(txt_path, encoding="utf-8") as fh:
            return fh.read().strip()

    config = audio_config or AudioConfig()
    audio = dsp.load_audio(audio_path, config)
    if len(audio) / config.sample_rate > MAX_CLIP_SECONDS:
        raise ValueError(f"{audio_path}: clip exceeds {MAX_CLIP_SECONDS}s")
    audio_16k = dsp.resample(audio, config.sample_rate, ASR_SAMPLE_RATE)

    text = (recognize_fn or _default_recognize)(audio_16k, language)
    with open(txt_path, "w", encoding="utf-8") as fh:
        fh.write(text)
    return text


def transcribe_batch(audio_pattern: str,
                     out_path: Optional[str] = None,
                     language: str = "ko-KR",
                     recognize_fn: Optional[Callable] = None
                     ) -> Dict[str, str]:
    """Transcribe every clip matching the glob; merge to recognition.json."""
    paths = sorted(glob(audio_pattern))
    results: Dict[str, str] = {}
    for path in paths:
        try:
            results[path] = transcribe_file(path, language, recognize_fn)
        except (ValueError, RuntimeError) as e:
            print(f" [!] skip {path}: {e}")
    if out_path is None and paths:
        out_path = os.path.join(os.path.dirname(paths[0]),
                                "recognition.json")
    if out_path:
        with open(out_path, "w") as fh:
            json.dump(results, fh, ensure_ascii=False, indent=2)
    return results


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="batch ASR transcription")
    parser.add_argument("audio_pattern")
    parser.add_argument("--out_path", default=None)
    parser.add_argument("--language", default="ko-KR")
    args = parser.parse_args(argv)
    results = transcribe_batch(args.audio_pattern, args.out_path,
                               args.language)
    print(f"[*] transcribed {len(results)} clips")


if __name__ == "__main__":
    main()
