"""The one generator of the benchmark's traffic.  A mix is a data file
(``<mix>.json`` beside this file) whose parameters this module reads; the
same seed gives the same texts, arrivals and corpus, and every seed the
same set of sizes in another order.

- ``texts(mix, seed, index)``: the texts of one batch call (``kind``
  ``offline``): ``texts_per_call`` texts whose token counts (EOS included)
  are ``texts_per_call`` points spread evenly over ``tokens`` [lo, hi],
  in an order drawn from the seed.
- ``griffin_lim(mix, audio)``: the Griffin-Lim iterations and momentum of
  an ``offline`` mix's vocoder.
- ``corpus(mix, model, seed, root)``: a training corpus (``kind``
  ``train``), one directory of ``.npz`` files per speaker, laid out as the
  port's data builder writes one (``tokens``, ``loss_coeff``, ``linear``,
  ``mel``).  Frame counts are the quantiles of a log-normal cut to
  ``frames`` [lo, hi]; token counts follow the frames linearly into
  ``tokens`` [lo, hi].

A text is whole words of the frozen pool ``words_ko.txt`` joined by
spaces and closed by a full stop, with exactly the token count asked for.
"""

from __future__ import annotations

import math
import os
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from ..reference.frontend import token_count

HERE = Path(__file__).resolve().parent
#: the longest word the builder places before the last one
_MAX_INNER = 9


@lru_cache(maxsize=1)
def word_pool() -> Dict[int, List[str]]:
    """Words of ``words_ko.txt`` by their token count (EOS excluded)."""
    pool: Dict[int, List[str]] = {}
    with open(HERE / "words_ko.txt", encoding="utf-8") as fh:
        for line in fh:
            word = line.strip()
            if word:
                pool.setdefault(token_count(word) - 1, []).append(word)
    return pool


def sentence(rng: np.random.Generator, n_tokens: int) -> str:
    """Words, spaces and a full stop that make ``n_tokens`` ids with the
    EOS."""
    pool = word_pool()
    left = n_tokens - 2              # the full stop and the EOS
    if left < 2:
        raise ValueError(f"no sentence has {n_tokens} tokens")
    words = []
    while left > _MAX_INNER:
        sizes = [n for n in pool if 2 <= n <= min(_MAX_INNER, left - 3)]
        n = sizes[rng.integers(len(sizes))]
        words.append(pool[n][rng.integers(len(pool[n]))])
        left -= n + 1
    words.append(pool[left][rng.integers(len(pool[left]))])
    return " ".join(words) + "."


def token_counts(lo: int, hi: int, n: int) -> List[int]:
    """``n`` counts spread evenly over [lo, hi], both ends included."""
    if n == 1:
        return [hi]
    return [int(round(lo + (hi - lo) * i / (n - 1))) for i in range(n)]


def _rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), *keys])


def texts(mix: dict, seed: int, index: int) -> List[str]:
    lo, hi = mix["tokens"]
    counts = token_counts(lo, hi, mix["texts_per_call"])
    rng = _rng(seed, 1, index)
    order = rng.permutation(len(counts))
    return [sentence(rng, counts[i]) for i in order]


#: the fast vocoder's Griffin-Lim, as the port's synthesizer states it
#: (``Synthesizer.FAST_GRIFFIN_LIM_ITERS`` and ``_MOMENTUM``), frozen here
FAST_GRIFFIN_LIM = (30, 0.99)


def griffin_lim(mix: dict, audio: dict) -> Tuple[int, float]:
    """(iterations, momentum) of the Griffin-Lim that a mix's calls run:
    the fast vocoder's for ``"vocoder": "fast"``, the configuration's
    otherwise."""
    if mix["vocoder"] == "fast":
        return FAST_GRIFFIN_LIM
    return audio["griffin_lim_iters"], audio["griffin_lim_momentum"]


def corpus_lengths(mix: dict) -> List[tuple]:
    """(frames, tokens) of every utterance of one speaker, before the
    seed's shuffle."""
    n = mix["utterances_per_speaker"]
    f_lo, f_hi = mix["frames"]
    t_lo, t_hi = mix["tokens"]
    mu, sigma = math.log(mix["frames_median"]), mix["frames_sigma"]
    out = []
    for i in range(n):
        q = (i + 0.5) / n
        z = math.sqrt(2.0) * _erfinv(2.0 * q - 1.0)
        frames = int(min(f_hi, max(f_lo, round(math.exp(mu + sigma * z)))))
        tokens = int(round(t_lo + (t_hi - t_lo) * (frames - f_lo)
                           / (f_hi - f_lo)))
        out.append((frames, tokens))
    return out


def _erfinv(y: float) -> float:
    """Inverse error function by Newton's method on ``math.erf``."""
    x = 0.0
    for _ in range(60):
        err = math.erf(x) - y
        x -= err / (2.0 / math.sqrt(math.pi) * math.exp(-x * x))
    return x


def corpus(mix: dict, model: dict, seed: int, root: str) -> List[str]:
    """Write the training corpus under ``root``; returns the speakers'
    directories.  Targets are smooth random spectrograms in [0, 1]; token
    ids are drawn from the jamo, punctuation and space ids, closed by
    EOS."""
    from ..reference.frontend import EOS_ID, VOCAB_SIZE
    dirs = []
    lengths = corpus_lengths(mix)
    for spk in range(mix["speakers"]):
        rng = _rng(seed, 2, spk)
        d = os.path.join(root, f"spk{spk}")
        os.makedirs(d)
        for i in rng.permutation(len(lengths)):
            frames, tokens = lengths[i]
            ids = np.concatenate([rng.integers(2, VOCAB_SIZE, tokens - 1),
                                  [EOS_ID]]).astype(np.int32)
            lin = _spectrogram(rng, frames, model["num_freq"])
            mel = _spectrogram(rng, frames, model["num_mels"])
            np.savez(os.path.join(d, f"utt{len(os.listdir(d)):03d}.npz"),
                     tokens=ids, loss_coeff=np.float32(1.0), linear=lin,
                     mel=mel)
        dirs.append(d)
    return dirs


def _spectrogram(rng: np.random.Generator, frames: int, bins: int
                 ) -> np.ndarray:
    """A [frames, bins] float32 array in [0, 1]: a random spectral tilt
    plus noise, so no frame repeats another."""
    tilt = np.linspace(0.8, 0.2, bins, dtype=np.float32)[None, :]
    level = rng.uniform(0.6, 1.0, (frames, 1)).astype(np.float32)
    noise = rng.random((frames, bins), dtype=np.float32) * 0.2
    return np.clip(tilt * level + noise, 0.0, 1.0)
