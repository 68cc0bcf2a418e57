"""Serving-side synthesis: batched greedy decode, attention trim, on-device
Griffin-Lim and int16 (or 8-bit mu-law) packing.

Counterpart of the JAX package's ``synth/synthesizer.py``.  One call of the
device program (:meth:`Synthesizer._vocode_chunk`) runs the decode, trims
each utterance at its attention end, vocodes the masked spectrograms and
packs the peak-normalized waveform with two extra rows (the frame ends and
the normalization denominator in dB x 100), so the host fetches one array.

Not in this slice (they raise ``NotImplementedError``): ``vocode="host"`` /
``"none"``, ``manual_attention_mode > 0``; ``synthesize_robust``,
``synthesize_long``, ``prewarm`` and sharded synthesis are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
import os
import warnings
import wave
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..dsp import chip as dsp_chip
from ..models.tacotron import Tacotron
from ..params import from_flax, init_random_, load_npz
from ..text import text_to_sequence
from ..text.symbols import EOS_ID, vocab_size_for

# Decode-step bucket ladder for length-adaptive serving (multiples of 50 up
# to the reference's 200-step decode cap).
STEP_LADDER = (50, 100, 150, 200)

# Decoder steps per input token, sized to the worst case the reference's
# corpus filter admits (796 frames at min_tokens = 50).
STEPS_PER_TOKEN = 4.0


def adaptive_max_steps(num_tokens: int, min_iters: int, max_iters: int,
                       steps_per_token: float = STEPS_PER_TOKEN,
                       ladder: Sequence[int] = STEP_LADDER) -> int:
    """Decode-step budget for ``num_tokens`` tokens: ``steps_per_token`` per
    token, clipped to [min_iters, max_iters], rounded up to the ladder."""
    need = int(np.ceil(steps_per_token * max(1, num_tokens)))
    need = min(max(need, min_iters), max_iters)
    for rung in ladder:
        if need <= rung <= max_iters:
            return rung
    return max_iters


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def mulaw_encode(x: torch.Tensor) -> torch.Tensor:
    """mu-law (mu=255) of ``x`` in [-1, 1] -> uint8 codes (128 = zero)."""
    x = torch.clamp(x, -1.0, 1.0)
    y = torch.sign(x) * torch.log1p(255.0 * torch.abs(x)) / math.log(256.0)
    return (torch.round(y * 127.0) + 128.0).to(torch.uint8)


def _mulaw_table() -> np.ndarray:
    y = (np.arange(256, dtype=np.float32) - 128.0) / 127.0
    x = np.sign(y) * (np.power(256.0, np.abs(y)) - 1.0) / 255.0
    return np.clip(x, -1.0, 1.0)


_MULAW_TABLE = _mulaw_table()


def mulaw_decode(codes: np.ndarray) -> np.ndarray:
    """Host-side inverse of :func:`mulaw_encode`: uint8 -> float32."""
    return _MULAW_TABLE[codes]


def attention_trim_frames(alignments: torch.Tensor,
                          input_lengths: torch.Tensor,
                          reduction_factor: int) -> torch.Tensor:
    """Per-utterance cut frame [N] from [N, T_in, T_dec] alignments, the
    reference's host loop (``synthesizer.py:242-263``) as tensor ops: walk
    the argmax path until it passes the last token or has sat on it
    min(5, visits) times."""
    N, T_in, T_dec = alignments.shape
    dev = alignments.device
    lengths = input_lengths.to(dev)
    row_ok = torch.arange(T_in, device=dev)[None, :, None] \
        < lengths[:, None, None]
    masked = torch.where(row_ok, alignments,
                         torch.full_like(alignments, float("-inf")))
    a = torch.argmax(masked, dim=1)                           # [N, T_dec]
    end_idx = torch.minimum(lengths - 1, a.max(dim=1).values)
    is_end = a == end_idx[:, None]
    max_counter = torch.clamp(is_end.sum(dim=1), max=5)
    cnt = torch.cumsum(is_end.to(torch.int64), dim=1)
    nxt = torch.cat([a[:, 1:], a[:, -1:]], dim=1)
    valid = (is_end & (nxt > end_idx[:, None])) | (cnt >= max_counter[:, None])
    valid[:, -1] = False  # the host loop stops before the last step
    first = torch.argmax(valid.to(torch.int64), dim=1)
    jdx = torch.where(valid.any(dim=1), first,
                      torch.full_like(first, T_dec - 1))
    return reduction_factor * jdx + 3


def frame_rms(audio: np.ndarray, frame_length: int, hop_length: int):
    """Frame matrix and per-frame RMS of a 1-D signal
    (``len(audio) >= frame_length``)."""
    n_frames = 1 + (len(audio) - frame_length) // hop_length
    idx = (np.arange(frame_length)[None, :]
           + hop_length * np.arange(n_frames)[:, None])
    frames = audio[idx]
    return frames, np.sqrt(np.mean(frames ** 2, axis=1))


def rms_db_below_peak(rms: np.ndarray) -> Optional[np.ndarray]:
    """Per-frame level in dB below the peak frame RMS (floored at -200 dB);
    None for an all-silent signal."""
    ref = float(rms.max()) if rms.size else 0.0
    if ref <= 0:
        return None
    return 20.0 * np.log10(np.maximum(rms / ref, 1e-10))


def trim_silence_db(audio: np.ndarray, top_db: float = 50.0,
                    frame_length: int = 5120,
                    hop_length: int = 256) -> np.ndarray:
    """Drop the trailing silence below ``top_db`` under the peak RMS."""
    if audio.size < frame_length:
        return audio
    _, rms = frame_rms(audio, frame_length, hop_length)
    db = rms_db_below_peak(rms)
    if db is None:
        return audio
    nonsilent = np.flatnonzero(db > -top_db)
    if nonsilent.size == 0:
        return audio
    end = min(len(audio),
              int(nonsilent[-1] + 1) * hop_length + frame_length)
    return audio[:end]


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: raise when CUDA is absent instead of
    falling back to the CPU; the CPU runs only when asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' (--device cpu) "
                "to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           f"available")
    return device


def _u16_rows(vals: torch.Tensor, width: int) -> torch.Tensor:
    """int [N] (0..65535) -> [2, width] uint8 lo/hi rows."""
    rows = torch.zeros((2, width), dtype=torch.uint8, device=vals.device)
    n = min(vals.shape[0], width)
    rows[0, :n] = (vals[:n] & 0xFF).to(torch.uint8)
    rows[1, :n] = ((vals[:n] >> 8) & 0xFF).to(torch.uint8)
    return rows


class Synthesizer:
    """Load once, synthesize many.  ``device=None`` runs on the card."""

    # serving-batch chunk of the vocoder (the JAX package's value)
    VOCODER_MAX_BATCH = 16

    def __init__(self, device=None):
        self.device = resolve_device(device)
        # fp32 parity with the reference: no TF32 in matmuls or cuDNN convs
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config: Optional[Config] = None
        self.model: Optional[Tacotron] = None

    # ------------------------------------------------------------------ load

    def _new_model(self, config: Config) -> Tacotron:
        self.config = config
        return Tacotron(config.model,
                        vocab_size=vocab_size_for(config.data.symbol_set))

    def _install(self, model: Tacotron) -> "Synthesizer":
        self.model = model.to(self.device).eval()
        return self

    def init_random(self, config: Config, seed: int = 0) -> "Synthesizer":
        """Fresh random weights drawn from ``seed`` (the same weights on
        every device)."""
        return self._install(init_random_(self._new_model(config), seed))

    def load_variables(self, variables, config: Config) -> "Synthesizer":
        """Weights from a flax variable tree (nested or flat, see
        ``params.py``)."""
        model = self._new_model(config)
        model.load_state_dict(from_flax(variables))
        return self._install(model)

    def load_npz(self, path: str, config: Config) -> "Synthesizer":
        """Weights from a flat ``.npz`` of ``/``-joined flax paths."""
        return self.load_variables(load_npz(path), config)

    def load(self, run_dir: str, step: Optional[int] = None
             ) -> "Synthesizer":
        """Weights and config of a run directory the port's trainer wrote
        (``config.json`` and ``checkpoints/<step>/variables.npz``): the
        checkpoint at ``step``, default the newest."""
        from ..train.checkpoint import checkpoint_path, load_run_config
        return self.load_npz(checkpoint_path(run_dir, step),
                             load_run_config(run_dir))

    def cleaner_names(self) -> List[str]:
        return list(self.config.data.cleaner_names())

    # ------------------------------------------------------- device program

    @torch.inference_mode()
    def _vocode_chunk(self, inputs, input_lengths, speaker_id, manual,
                      is_manual, max_steps: int, trim: bool, fast: bool,
                      wire: str):
        """Decode -> attention trim -> masked batched Griffin-Lim -> packed
        waveform (int16 rows + ends row + dB*100 denominator row, or the
        uint8 mu-law layout).  Returns (packed, alignments) on the device."""
        audio_cfg = self.config.audio
        if fast:
            audio_cfg = dataclasses.replace(
                audio_cfg, griffin_lim_iters=30, griffin_lim_momentum=0.99)
        r = self.config.model.reduction_factor
        out = self.model(inputs, input_lengths, speaker_id=speaker_id,
                         max_steps=max_steps, manual_alignments=manual,
                         is_manual=is_manual)
        linear = out["linear_outputs"]                 # [N, steps*r, F]
        aligns = out["alignments"]                     # [N, T_in, steps]
        N, n_frames, _ = linear.shape
        if trim:
            ends = torch.clamp(
                attention_trim_frames(aligns, input_lengths, r),
                min=r, max=n_frames)
        else:
            ends = torch.full((N,), n_frames, dtype=torch.int64,
                              device=linear.device)
        mask = (torch.arange(n_frames, device=linear.device)[None, :]
                < ends[:, None])[..., None]
        wavs = dsp_chip.batched_linear_to_waveform(linear * mask, audio_cfg)
        # per-utterance peak normalization before quantization
        peak = torch.amax(torch.abs(wavs), dim=1, keepdim=True)
        denom = torch.clamp(peak, min=0.01)
        denom_db = 20.0 * torch.log10(denom[:, 0])
        denom_q = torch.clamp(torch.round(denom_db * 100.0), -32767, 32767)
        S = wavs.shape[1]
        if wire == "mulaw8":
            wav_q = mulaw_encode(wavs / denom)
            packed = torch.cat(
                [wav_q, _u16_rows(ends, S),
                 _u16_rows(denom_q.to(torch.int64) + 32768, S)], dim=0)
            return packed, aligns
        wav_i16 = torch.clamp(wavs * (32767.0 / denom),
                              -32768, 32767).to(torch.int16)
        extra = torch.zeros((2, S), dtype=torch.int16, device=wavs.device)
        n = min(N, S)
        extra[0, :n] = ends[:n].to(torch.int16)
        extra[1, :n] = denom_q[:n].to(torch.int16)
        return torch.cat([wav_i16, extra], dim=0), aligns

    # ----------------------------------------------------------- synthesize

    def synthesize(self, texts: Optional[Sequence[str]] = None,
                   sequences: Optional[Sequence[Sequence[int]]] = None,
                   speaker_ids: Optional[Sequence[int]] = None,
                   max_steps: Optional[int] = None,
                   manual_alignments: Optional[np.ndarray] = None,
                   manual_attention_mode: int = 0,
                   attention_trim: bool = True,
                   librosa_trim: bool = True,
                   vocode: str = "chip",
                   token_bucket: int = 32,
                   return_alignments: bool = True,
                   fast_vocoder: bool = False,
                   wire_format: str = "int16",
                   ) -> Dict[str, List]:
        """texts -> waveforms.

        Returns ``wavs`` (float32 at true Griffin-Lim amplitude: the peak
        normalization of the wire is undone), ``alignments`` ([T_in, T_dec]
        each, cropped to the text), ``linear`` (None: the spectrograms stay
        on the device), ``sequences`` and ``ends`` (the trimmed frame count
        of each utterance).  ``max_steps=None`` picks the decode budget from
        the longest text (:func:`adaptive_max_steps`); ``fast_vocoder``
        runs 30 momentum-0.99 Griffin-Lim iterations instead of 60 classic
        ones; ``wire_format="mulaw8"`` packs 8-bit mu-law.
        """
        if self.model is None:
            raise RuntimeError("call init_random() or load_variables() first")
        if vocode not in ("chip", "host", "none"):
            raise ValueError(f"unknown vocode mode {vocode!r}")
        if vocode != "chip":
            raise NotImplementedError(
                f"vocode={vocode!r} is not ported yet; use vocode='chip'")
        if wire_format not in ("int16", "mulaw8"):
            raise ValueError(f"unknown wire_format {wire_format!r}")
        if manual_attention_mode > 0:
            raise NotImplementedError(
                "manual_attention_mode > 0 (post-hoc attention) is not "
                "ported yet")
        cfg = self.config
        dev = self.device
        if sequences is None:
            sequences = [text_to_sequence(t, self.cleaner_names(),
                                          symbol_set=cfg.data.symbol_set)
                         for t in texts]
        seq_lens = [len(s) for s in sequences]
        N = len(sequences)

        bucket = _round_up(max(seq_lens), token_bucket)
        inputs = np.zeros((N, bucket), np.int64)
        for i, s in enumerate(sequences):
            inputs[i, :len(s)] = s
        # lengths include the EOS token; sequences without one use their
        # true length
        has_eos = (inputs == EOS_ID).any(axis=1)
        input_lengths = np.where(
            has_eos, np.argmax(inputs == EOS_ID, axis=1) + 1,
            np.asarray(seq_lens)).astype(np.int64)

        adaptive = max_steps is None
        steps = (max_steps if max_steps is not None else
                 adaptive_max_steps(max(seq_lens), cfg.data.min_iters,
                                    cfg.model.max_iters,
                                    steps_per_token=cfg.model.steps_per_token))
        spk = None
        if cfg.model.num_speakers > 1:
            spk = (np.asarray(speaker_ids, np.int64)
                   if speaker_ids is not None else np.zeros((N,), np.int64))

        man = None
        is_manual = torch.tensor(manual_alignments is not None, device=dev)
        if manual_alignments is not None:
            # [N, T_in, T_dec] -> [N, T_dec, T_in], cropped/padded
            man = np.zeros((N, steps, bucket), np.float32)
            src = np.transpose(manual_alignments, (0, 2, 1))
            man[:, :min(steps, src.shape[1]), :min(bucket, src.shape[2])] = \
                src[:, :steps, :bucket]

        r = cfg.model.reduction_factor
        hop = cfg.audio.hop_length
        full_frames = steps * r

        def padded(arr, nb, fill, lo, hi):
            out = np.full((nb,) + arr.shape[1:], fill, arr.dtype)
            out[:hi - lo] = arr[lo:hi]
            return torch.from_numpy(out).to(dev)

        pending = []
        for lo in range(0, N, self.VOCODER_MAX_BATCH):
            hi = min(N, lo + self.VOCODER_MAX_BATCH)
            nb = 1 << (hi - lo - 1).bit_length()  # power-of-two chunk
            pending.append((lo, hi, self._vocode_chunk(
                padded(inputs, nb, 0, lo, hi),
                padded(input_lengths, nb, 1, lo, hi),
                None if spk is None else padded(spk, nb, 0, lo, hi),
                None if man is None else padded(man, nb, 0, lo, hi),
                is_manual, steps, attention_trim, fast_vocoder,
                wire_format)))
        fetched = [(lo, hi, packed.cpu().numpy(),
                    al.cpu().numpy() if return_alignments else None)
                   for lo, hi, (packed, al) in pending]

        wavs: List[np.ndarray] = []
        aligns: List[np.ndarray] = []
        all_ends: List[int] = []
        for lo, hi, packed, al in fetched:
            if wire_format == "mulaw8":
                wav_rows = mulaw_decode(packed[:-4])
                ends = (packed[-4].astype(np.int32)
                        | (packed[-3].astype(np.int32) << 8))
                denom_db = ((packed[-2].astype(np.int32)
                             | (packed[-1].astype(np.int32) << 8))
                            - 32768).astype(np.float32) / 100.0
                scale = 10.0 ** (denom_db / 20.0)
            else:
                wav_rows = packed[:-2]
                ends = packed[-2].astype(np.int32)
                scale = (10.0 ** (packed[-1].astype(np.float32) / 100.0
                                  / 20.0)) / 32767.0
            for i in range(hi - lo):
                all_ends.append(int(ends[i]))
                n_samples = min(wav_rows.shape[1], int(ends[i]) * hop)
                wavs.append(wav_rows[i, :n_samples].astype(np.float32)
                            * np.float32(scale[i]))
                if al is not None:
                    aligns.append(al[i, :seq_lens[lo + i], :])

        if librosa_trim:
            wavs = [trim_silence_db(w) for w in wavs]
        budget_hits = sum(e >= full_frames for e in all_ends)
        if adaptive and attention_trim and budget_hits \
                and steps < cfg.model.max_iters:
            warnings.warn(
                f"{budget_hits}/{N} utterance(s) consumed the entire "
                f"adaptive decode budget ({steps} steps at "
                f"{cfg.model.steps_per_token} steps/token) and may be "
                f"truncated; raise ModelConfig.steps_per_token or pass "
                f"max_steps explicitly", stacklevel=2)

        return {"wavs": wavs, "alignments": aligns, "linear": None,
                "sequences": list(sequences), "ends": all_ends}

    # ------------------------------------------------------------- save

    def save_results(self, results: Dict, out_dir: str,
                     prefix: str = "synth") -> List[str]:
        """Write each waveform as a peak-normalized 16-bit wav and each
        alignment as ``.npy`` beside it."""
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        aligns = results["alignments"] or [None] * len(results["wavs"])
        for i, (wav, align) in enumerate(zip(results["wavs"], aligns)):
            wav_path = os.path.join(out_dir, f"{prefix}_{i}.wav")
            save_wav(wav, wav_path, self.config.audio.sample_rate)
            if align is not None:
                np.save(wav_path[:-4] + "_alignment.npy", align)
            paths.append(wav_path)
        return paths


def save_wav(audio: np.ndarray, path: str, sample_rate: int) -> None:
    """Peak-normalize to int16 and write a mono wav."""
    audio = np.asarray(audio, dtype=np.float32)
    scaled = audio * (32767 / max(0.01, float(np.max(np.abs(audio)))
                                  if audio.size else 0.01))
    with wave.open(path, "wb") as fh:
        fh.setnchannels(1)
        fh.setsampwidth(2)
        fh.setframerate(sample_rate)
        fh.writeframes(scaled.astype("<i2").tobytes())
