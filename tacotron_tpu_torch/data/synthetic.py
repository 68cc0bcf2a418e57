"""A synthetic corpus written from a seed, laid out as the data builder
writes one: per-speaker directories of ``.npz`` files with ``tokens``,
``loss_coeff``, ``linear`` and ``mel`` ([T, F] normalized spectrograms from
``dsp/host.py``) and the int16 ``wav``.  No trained voice comes from it; it
exists to drive the training path end to end (``chip_smoke.py``,
``train/profile.py``)."""

from __future__ import annotations

import os
from typing import List

import numpy as np

from ..dsp import host as dsp_host
from ..text import text_to_sequence

SENTENCES = ["안녕하세요. 만나서 반갑습니다.",
             "오늘 날씨가 참 좋네요.",
             "음성 합성 시스템을 시험하고 있습니다.",
             "감사합니다, 좋은 하루 되세요!"]

SPEAKERS = 2
PER_SPEAKER = 32
FRAMES = (120, 400)     # inclusive range of an utterance's frames
TOKENS = (50, 120)      # inclusive range of its token count, EOS included


def write_synthetic_corpus(root: str, config, seed: int = 0) -> List[str]:
    """``SPEAKERS`` dirs of ``PER_SPEAKER`` utterances under ``root``; each
    a seeded sum of three sines with a little noise, ``FRAMES`` long, its
    tokens the sentences' ids repeated to a length in ``TOKENS`` and closed
    by EOS.  Returns the dirs."""
    rng = np.random.default_rng(seed)
    audio, hop = config.audio, config.audio.hop_length
    cleaners = list(config.data.cleaner_names())
    seqs = [text_to_sequence(t, cleaners, symbol_set=config.data.symbol_set)
            for t in SENTENCES]
    dirs = []
    for spk in range(SPEAKERS):
        d = os.path.join(root, f"spk{spk}")
        os.makedirs(d)
        for i in range(PER_SPEAKER):
            n_frames = int(rng.integers(FRAMES[0], FRAMES[1] + 1))
            t = np.arange((n_frames - 1) * hop) / audio.sample_rate
            wav = sum(rng.uniform(0.1, 0.3)
                      * np.sin(2 * np.pi * rng.uniform(100, 1000) * t
                               + rng.uniform(0, 2 * np.pi))
                      for _ in range(3))
            wav = (wav + 0.02 * rng.standard_normal(t.size)).astype(
                np.float32)
            seq = seqs[i % len(seqs)]
            n_tokens = int(rng.integers(TOKENS[0], TOKENS[1] + 1))
            ids = np.concatenate([np.resize(seq[:-1], n_tokens - 1),
                                  seq[-1:]]).astype(np.int32)
            np.savez(os.path.join(d, f"utt{i:03d}.npz"), tokens=ids,
                     loss_coeff=np.float32(1.0),
                     linear=dsp_host.spectrogram(wav, audio).T.astype(
                         np.float32),
                     mel=dsp_host.melspectrogram(wav, audio).T.astype(
                         np.float32),
                     wav=np.round(wav * 32767).astype(np.int16))
        dirs.append(d)
    return dirs
