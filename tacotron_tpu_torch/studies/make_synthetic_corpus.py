"""Generate a synthetic multi-speaker Korean corpus and its run config: a
copy of the repo's ``scripts/make_synthetic_corpus.py`` on the port's
``config``, ``text``, ``dsp/host.py`` and ``data/builder.py``.  The files it
writes are byte-equal to the script's.

Three corpus styles:

- ``melody`` (default): each frontend token of the cleaned text becomes a
  50 ms tone segment (4 frames = exactly one decoder step at r=4) whose
  frequency encodes the token id within the speaker's FFT-bin-aligned
  band (:func:`token_frequency`); spaces and EOS are silent.  The audio is
  a deterministic, monotonic function of the token sequence, so attention
  has a real signal to align to, and disjoint per-speaker bands make
  speaker identity measurable in synthesized audio.
- ``melody_var``: like ``melody`` but each token lasts 1-3 decoder steps
  (:func:`token_duration_steps`, deterministic from the token id, so a
  held-out evaluation reconstructs the slot boundaries from the text
  alone).  The true alignment has a non-uniform slope: attention must
  hold on a token for up to 3 steps, then advance, as with the variable
  phone durations of real speech.
- ``sine``: a stationary sine per utterance with a per-speaker f0, for
  step-time studies where the audio content does not matter.

Produces per-speaker wavs, ``metadata.csv`` in the builder's ``path|text``
format, a run-config JSON whose corpus filters accept the utterances, and
(melody styles) ``heldout.json``: sentences never trained on, for the
held-out evaluation (``tools/speaker_eval.py --texts``).

CLI::

    python -m tacotron_tpu_torch.studies.make_synthetic_corpus OUT_DIR \
        [--style melody|melody_var|sine] [--utterances 24] [--store_waveform]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
from typing import List, Optional, Sequence

import numpy as np

from ..config import Config, DataConfig, TrainConfig, load_config
from ..dsp import host as dsp
from ..text import text_to_sequence
from ..text.symbols import EOS_ID, PAD_ID, char_to_id

TEXTS = [
    "안녕하세요 만나서 반갑습니다 오늘도 좋은 하루 되세요",
    "오늘은 날씨가 정말 좋네요 산책하기 딱 좋은 날입니다",
    "음성 합성 시스템을 시험하고 있습니다 잘 들리시나요",
    "스물 네 시간 열두 달 내내 쉬지 않고 일합니다",
    "어제는 비가 조금 내렸어요 우산을 챙기세요",
    "내일 아침 일찍 만나요 늦지 않게 오세요",
    "기차는 여덟 시 정각에 출발합니다 서두르세요",
    "도서관은 매우 조용한 곳입니다 책을 읽기 좋아요",
]

# combinatorial sentence pool for the melody corpus: enough text variety
# that held-out sentences are genuinely unseen token sequences
_SUBJECTS = ["오늘은", "내일은", "어제는", "우리는", "그들은", "아이는"]
_PLACES = ["아침에", "저녁에", "집에서", "학교에서", "공원에서", "바다에서"]
_ACTIONS = ["노래를 불러요", "책을 읽어요", "밥을 먹어요", "길을 걸어요",
            "꿈을 꾸어요", "춤을 춥니다", "차를 마셔요", "별을 봅니다"]


def sentence_pool(seed: int = 7) -> list:
    """All subject x place x action sentences, deterministically shuffled."""
    pool = [f"{s} {p} {a}" for s in _SUBJECTS for p in _PLACES
            for a in _ACTIONS]
    rng = np.random.default_rng(seed)
    rng.shuffle(pool)
    return pool


#: token segment duration (s): 0.05 s = 4 frames at the 12.5 ms shift = one
#: r=4 decoder step per token
TOKEN_SECONDS = 0.05
#: tones per speaker and the speaker band's origin and stride, in FFT bins
#: of the model's 1025-bin linear spectrogram (bin = sr/2048 = 11.72 Hz at
#: 24 kHz).  Speaker 0 starts at bin 40 (469 Hz): below ~440 Hz a trained
#: model's spectral peaks pull up by up to 1.5 bins (the pre-emphasis
#: attenuates the low band).
TONES_PER_SPEAKER = 24
_BAND_ORIGIN_BIN = 40
_BAND_STRIDE_BIN = 50   # speaker bands 50 bins apart (no overlap)
_TONE_STRIDE_BIN = 2    # adjacent tones 2 bins apart

_SPACE_ID = char_to_id[" "]

#: duration range (decoder steps) for the variable-rate corpus
VAR_MIN_STEPS, VAR_MAX_STEPS = 1, 3

STYLES = ("melody", "melody_var", "sine")


def token_duration_steps(token_id: int) -> int:
    """Decoder steps (r=4 frame groups, 50 ms each) token ``token_id``
    occupies in the ``melody_var`` corpus: 1, 2 or 3, a pure function of
    the token id, so the slot boundaries of any held-out sentence are
    computable from its text alone.  The *11 multiplier decorrelates the
    duration from the *7-strided tone position (:func:`token_frequency`)."""
    return VAR_MIN_STEPS + (token_id * 11) % (VAR_MAX_STEPS
                                              - VAR_MIN_STEPS + 1)


def token_slot_bounds(tokens, sr: int, variable_rate: bool,
                      tok_seconds: float = TOKEN_SECONDS) -> list:
    """Ground-truth ``[start_sample, end_sample)`` per token, the time axis
    of the true alignment: one ``tok_seconds`` slot per token, or
    :func:`token_duration_steps` slots in the variable style.  Shared by
    :func:`melody_wav` (synthesis) and the convergence study's tone
    accuracy (measurement), so the two cannot disagree about where a
    token's audio lives."""
    base = int(round(tok_seconds * sr))
    bounds, pos = [], 0
    for tok in tokens:
        steps = token_duration_steps(int(tok)) if variable_rate else 1
        bounds.append((pos, pos + steps * base))
        pos += steps * base
    return bounds


def token_frequency(token_id: int, speaker: int,
                    sample_rate: int = 24000) -> float:
    """Tone of (token, speaker), on the FFT bin centres of the model's
    linear-spectrogram grid (n_fft 2048), so per-token pitch is measurable
    without a ±1-bin ambiguity.  Adjacent tones sit 2 bins apart and the
    speaker bands are disjoint: speaker 0 = bins 40..86 (469-1008 Hz),
    speaker 1 = bins 90..136 (1055-1594 Hz).  The *7 stride decorrelates
    neighbouring token ids."""
    pos = (token_id * 7) % TONES_PER_SPEAKER
    k = _BAND_ORIGIN_BIN + _BAND_STRIDE_BIN * speaker + _TONE_STRIDE_BIN * pos
    return sample_rate / 2048.0 * k


def speaker_band_hz(speaker: int, sample_rate: int = 24000) -> tuple:
    """[lowest, highest] tone frequency of one speaker's band."""
    k0 = _BAND_ORIGIN_BIN + _BAND_STRIDE_BIN * speaker
    k1 = k0 + _TONE_STRIDE_BIN * (TONES_PER_SPEAKER - 1)
    return (sample_rate / 2048.0 * k0, sample_rate / 2048.0 * k1)


def speaker_tones(speaker: int, sample_rate: int = 24000) -> np.ndarray:
    """The speaker's whole tone table, ascending."""
    k0 = _BAND_ORIGIN_BIN + _BAND_STRIDE_BIN * speaker
    return np.asarray([sample_rate / 2048.0 * (k0 + _TONE_STRIDE_BIN * p)
                       for p in range(TONES_PER_SPEAKER)])


def is_silent_token(tok) -> bool:
    """Space, PAD and EOS are silent slots."""
    return tok in (PAD_ID, EOS_ID, _SPACE_ID)


def melody_wav(tokens, speaker: int, sr: int,
               tok_seconds: float = TOKEN_SECONDS,
               variable_rate: bool = False) -> np.ndarray:
    """Token sequence -> waveform: one enveloped tone segment per token,
    silence for space/PAD/EOS.  ``variable_rate`` holds each tone for its
    :func:`token_duration_steps` slot instead of a uniform one."""
    fade = max(1, int(0.005 * sr))  # 5 ms raised-cosine edges, no clicks
    ramp = 0.5 - 0.5 * np.cos(np.pi * np.arange(fade) / fade)

    def envelope(seg: int) -> np.ndarray:
        env = np.ones(seg)
        env[:fade] *= ramp
        env[-fade:] *= ramp[::-1]
        return env

    bounds = token_slot_bounds(tokens, sr, variable_rate, tok_seconds)
    parts = []
    for tok, (lo, hi) in zip(tokens, bounds):
        seg = hi - lo
        if is_silent_token(tok):
            parts.append(np.zeros(seg, np.float32))
            continue
        f = token_frequency(int(tok), speaker, sr)
        t = np.arange(seg) / sr
        parts.append((0.45 * np.sin(2 * np.pi * f * t)
                      * envelope(seg)).astype(np.float32))
    return np.concatenate(parts)


def ensure_corpus(work: str, utterances: int = 96, batch_size: int = 8,
                  style: str = "melody", num_workers: int = 4) -> list:
    """Build (or reuse) the synthetic corpus under ``work/corpus`` and run
    the corpus builder; returns the per-speaker data dirs.

    The corpus is reused only when it was built with the same parameters:
    a ``build_args.json`` marker records them, and a mismatch (a rerun
    with another ``--utterances``) rebuilds it from scratch.  The script
    version runs its own file in a subprocess; this one calls :func:`main`
    in process, with the same arguments and the same files written."""
    corpus = os.path.join(work, "corpus")
    marker = os.path.join(corpus, "build_args.json")
    want = {"style": style, "utterances": utterances,
            "batch_size": batch_size, "store_waveform": True}
    have = None
    if os.path.exists(marker):
        with open(marker) as fh:
            have = json.load(fh)
    if have != want:
        if os.path.exists(corpus):
            print(f"[*] rebuilding corpus at {corpus}: parameter marker "
                  f"{'mismatched' if have is not None else 'missing'} "
                  f"(have={have}, want={want})")
        shutil.rmtree(corpus, ignore_errors=True)
        main([corpus, "--style", style, "--utterances", str(utterances),
              "--batch_size", str(batch_size), "--store_waveform"])
        with open(marker, "w") as fh:
            json.dump(want, fh)
    from ..data.builder import build_from_path
    cfg = load_config(os.path.join(corpus, "config.json"))
    dirs = []
    for spk_dir in sorted(glob.glob(os.path.join(corpus, "spk*"))):
        build_from_path(os.path.join(spk_dir, "metadata.csv"), cfg,
                        num_workers=num_workers)
        dirs.append(os.path.join(spk_dir, "data"))
    return dirs


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("out_dir")
    parser.add_argument("--style", choices=list(STYLES), default="melody")
    parser.add_argument("--speakers", type=int, default=2)
    parser.add_argument("--utterances", type=int, default=24)
    parser.add_argument("--heldout", type=int, default=8,
                        help="melody style: sentences reserved for eval "
                             "(never trained on); written to heldout.json")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--sample_rate", type=int, default=24000)
    parser.add_argument("--store_waveform", action="store_true",
                        help="run config keeps int16 waveforms in the .npz "
                             "(enables on_device_features training)")
    args = parser.parse_args(argv)

    cfg = Config()
    sr = args.sample_rate
    cleaners = list(cfg.data.cleaner_names())

    train_texts: List[str] = TEXTS
    heldout: List[str] = []
    if args.style.startswith("melody"):
        pool = sentence_pool()
        if args.heldout:
            heldout = pool[-args.heldout:]
            pool = pool[:-args.heldout]
        train_texts = pool

    for spk in range(args.speakers):
        root = os.path.join(args.out_dir, f"spk{spk}")
        os.makedirs(root, exist_ok=True)
        lines = []
        for i in range(args.utterances):
            text = train_texts[i % len(train_texts)]
            if args.style.startswith("melody"):
                tokens = text_to_sequence(text, cleaners)
                wav = melody_wav(
                    tokens, spk, sr,
                    variable_rate=args.style == "melody_var")
            else:
                dur = 1.0 + 0.08 * (i % 12)
                t = np.arange(int(dur * sr)) / sr
                f0 = 140 + 80 * spk + 10 * (i % 8)
                wav = (0.4 * np.sin(2 * np.pi * f0 * t)
                       + 0.1 * np.sin(2 * np.pi * 2 * f0 * t)
                       ).astype(np.float32)
            path = os.path.join(root, f"utt{i:03d}.wav")
            dsp.save_audio(wav, path, cfg.audio)
            lines.append(f"{path}|{text}")
        with open(os.path.join(root, "metadata.csv"), "w") as fh:
            fh.write("\n".join(lines))
        print(f"[*] {root}: {args.utterances} utterances ({args.style})")

    run_cfg = Config().replace(
        data=DataConfig(min_tokens=1, min_iters=1, max_iters=150,
                        bucket_size_tokens=32, bucket_size_frames=64,
                        batches_per_group=4,
                        store_waveform=args.store_waveform),
        train=TrainConfig(batch_size=args.batch_size, initial_phase_step=0,
                          checkpoint_interval=40, test_interval=40,
                          summary_interval=10))
    cfg_path = os.path.join(args.out_dir, "config.json")
    with open(cfg_path, "w") as fh:
        fh.write(run_cfg.to_json())
    print(f"[*] run config -> {cfg_path}")
    if heldout:
        with open(os.path.join(args.out_dir, "heldout.json"), "w") as fh:
            json.dump(heldout, fh, ensure_ascii=False, indent=2)
        print(f"[*] {len(heldout)} held-out eval sentences -> heldout.json")


if __name__ == "__main__":
    main()
