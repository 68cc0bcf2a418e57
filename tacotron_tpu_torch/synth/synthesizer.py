"""Serving-side synthesis: batched greedy decode, attention trim, on-device
Griffin-Lim and int16 (or 8-bit mu-law) packing.

Counterpart of the JAX package's ``synth/synthesizer.py``.  One call of the
device program (:meth:`Synthesizer._vocode_chunk`) runs the decode, trims
each utterance at its attention end, vocodes the masked spectrograms and
packs the peak-normalized waveform with two extra rows (the frame ends and
the normalization denominator in dB x 100), so the host fetches one array.

``vocode="host"`` decodes on the device and inverts the fetched
spectrograms with the numpy Griffin-Lim of ``dsp/host.py``; ``"none"``
returns the spectrograms only.  ``manual_attention_mode`` re-decodes with
post-hoc manual alignments (:func:`posthoc_attention`),
:meth:`Synthesizer.synthesize_robust` retries the utterances that fail
:func:`attention_health`, and :meth:`Synthesizer.synthesize_long` splits a
text of any length (:func:`split_text`), decodes the chunks in one batched
call and stitches them with silence.  :meth:`Synthesizer.prewarm` captures
the device program as one CUDA graph per (token bucket, decode-step rung,
chunk size), the counterpart of the JAX package's compiled programs;
``synthesize`` replays a captured key.  Sharded synthesis is not ported
yet.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import itertools
import math
import os
import re
import threading
import warnings
import wave
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..dsp import chip as dsp_chip
from ..dsp import host as dsp_host
from ..models.tacotron import Tacotron
from ..ops.kernels.stamp import stamp
from ..params import from_flax, init_random_, load_npz
from ..text import text_to_sequence
from ..text.symbols import EOS_ID, vocab_size_for
from ..utils import trace
from ..utils.graphs import GraphSet, Graphed
from ..utils.plot import save_alignment_png

# Decode-step bucket ladder for length-adaptive serving (multiples of 50 up
# to the reference's 200-step decode cap).
STEP_LADDER = (50, 100, 150, 200)

# the unit id of a ``synthesize`` call's spans: its number in the process
_CALLS = itertools.count()

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


def prewarm_step_rungs(cfg, token_buckets: Sequence[int],
                       max_steps: Optional[int] = None) -> dict:
    """Decode-step rungs :meth:`Synthesizer.prewarm` must capture per token
    bucket: exactly the set :func:`adaptive_max_steps` can choose at serving
    time (same ``cfg.model.steps_per_token``).  Batches land in bucket ``b``
    only when their longest text exceeds the previous bucket, so rungs
    reachable only from shorter texts are excluded."""
    buckets = sorted(token_buckets)
    rungs = {}
    for i, bucket in enumerate(buckets):
        if max_steps is not None:
            rungs[bucket] = [max_steps]
            continue
        lo = buckets[i - 1] + 1 if i > 0 else 1
        rungs[bucket] = sorted({
            adaptive_max_steps(t, cfg.data.min_iters, cfg.model.max_iters,
                               steps_per_token=cfg.model.steps_per_token)
            for t in range(lo, bucket + 1)})
    return rungs


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


#: sentence-final punctuation (the longer stitch gap, and the primary split
#: points of :func:`split_text`)
_SENT_FINAL = ".!?"
#: split after sentence punctuation only when whitespace follows, so
#: decimals ("2.5를") and quoted punctuation never split; zero-width split
#: points drop no text
_SENT_SPLIT_RE = re.compile(r"(?<=[.!?])\s+")
#: secondary split points inside an oversized sentence
_CLAUSE_SPLIT_RE = re.compile(r"(?<=[,;:·])\s*")


def split_text(text: str, max_chunk_tokens: int,
               cleaners: Sequence[str],
               symbol_set: str = "korean") -> List[str]:
    """Split ``text`` into chunks of at most ``max_chunk_tokens`` frontend
    tokens (counted with :func:`text_to_sequence`), cutting at sentence
    boundaries first, then at clause punctuation, then at word boundaries,
    and last inside an unbroken run; consecutive short pieces are packed
    into one chunk."""

    def ntok(s: str) -> int:
        return len(text_to_sequence(s, list(cleaners), symbol_set=symbol_set))

    def atoms(s: str) -> List[str]:
        """Pieces of ``s`` that each fit the budget."""
        if ntok(s) <= max_chunk_tokens:
            return [s]
        out: List[str] = []
        clauses = [c for c in _CLAUSE_SPLIT_RE.split(s) if c.strip()]
        if len(clauses) == 1:
            clauses = s.split()
        for c in clauses:
            if ntok(c) <= max_chunk_tokens:
                out.append(c)
            else:  # single clause still too big: split on words
                def hard(word: str) -> List[str]:
                    """Character-level split of one over-budget word (URLs,
                    long digit strings, CJK without spaces), which the
                    decode-step cap would otherwise truncate."""
                    if ntok(word) <= max_chunk_tokens:
                        return [word]
                    parts: List[str] = []
                    acc = ""
                    for ch in word:
                        cand = acc + ch
                        if acc and ntok(cand) > max_chunk_tokens:
                            parts.append(acc)
                            acc = ch
                        else:
                            acc = cand
                    if acc:
                        parts.append(acc)
                    return parts

                words = [p for w in c.split() for p in hard(w)]
                cur = ""
                for w in words:
                    cand = (cur + " " + w).strip()
                    if cur and ntok(cand) > max_chunk_tokens:
                        out.append(cur)
                        cur = w
                    else:
                        cur = cand
                if cur:
                    out.append(cur)
        return out

    sentences = [s for s in _SENT_SPLIT_RE.split(text) if s.strip()]
    pieces: List[str] = []
    for s in sentences:
        pieces.extend(atoms(s.strip()))

    # greedy packing of consecutive pieces
    chunks: List[str] = []
    cur = ""
    for p in pieces:
        cand = (cur + " " + p).strip()
        if cur and ntok(cand) > max_chunk_tokens:
            chunks.append(cur)
            cur = p
        else:
            cur = cand
    if cur:
        chunks.append(cur)
    return chunks


def attention_trim_index(alignment: np.ndarray, seq_len: int,
                         reduction_factor: int) -> int:
    """Spectrogram-frame index to cut at, from the argmax path of one
    [T_in, T_dec] alignment (the reference's ``synthesizer.py:242-263``);
    :func:`attention_trim_frames` is the batched device version."""
    attention_argmax = alignment.argmax(0)  # [T_dec]
    end_idx = min(seq_len - 1, int(attention_argmax.max()))
    max_counter = min(int((attention_argmax == end_idx).sum()), 5)
    end_idx_counter = 0
    jdx = 0
    for jdx, attend_idx in enumerate(attention_argmax):
        if len(attention_argmax) > jdx + 1:
            if attend_idx == end_idx:
                end_idx_counter += 1
            if (attend_idx == end_idx
                    and attention_argmax[jdx + 1] > end_idx):
                break
            if end_idx_counter >= max_counter:
                break
        else:
            break
    return reduction_factor * jdx + 3


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


def trim_silence_db(audio: np.ndarray, top_db: float = 50.0,
                    frame_length: int = 5120,
                    hop_length: int = 256) -> np.ndarray:
    """Drop the trailing silence below ``top_db`` under the peak RMS."""
    if audio.size < frame_length:
        return audio
    _, rms = dsp_host.frame_rms(audio, frame_length, hop_length)
    db = dsp_host.rms_db_below_peak(rms)
    if db is None:
        return audio
    nonsilent = np.flatnonzero(db > -top_db)
    if nonsilent.size == 0:
        return audio
    end = min(len(audio),
              int(nonsilent[-1] + 1) * hop_length + frame_length)
    return audio[:end]


def posthoc_attention(alignments: np.ndarray, mode: int) -> np.ndarray:
    """Post-hoc manual-attention transforms of [N, T_in, T_dec] alignments
    (the reference's ``synthesizer.py:171-205``): 1 = argmax one-hot,
    2 = sharpen (power 2, renormalized over the input), 3 = prune (the
    shipped reference code for 3 equals 1)."""
    out = np.zeros_like(alignments)
    if mode in (1, 3):
        for i, al in enumerate(alignments):      # al: [T_in, T_dec]
            argmax = al.argmax(0)
            out[i][(argmax, np.arange(len(argmax)))] = 1.0
        return out
    if mode == 2:
        sq = alignments ** 2
        denom = np.maximum(sq.sum(axis=1, keepdims=True), 1e-8)
        return sq / denom
    raise ValueError(f"unknown manual_attention_mode {mode}")


def attention_health(alignment: np.ndarray,
                     coverage_threshold: float = 0.2,
                     min_coverage: float = 0.5,
                     min_focus: float = 0.25,
                     min_monotonicity: float = 0.6,
                     soft_monotonic: bool = False) -> Dict[str, float]:
    """Per-utterance diagnostics of one [T_in, T_dec] alignment (cropped to
    the true input length):

    - ``coverage``: the share of input tokens whose attention peaks above
      ``coverage_threshold`` (collapsed attention skips text);
    - ``focus``: the mean over decode steps of the largest weight (diffuse
      attention mumbles);
    - ``monotonicity``: the share of steps whose argmax moves back by at
      most 2 tokens;
    - ``path_coverage``: the share of input tokens the argmax path comes
      within 2 positions of.

    Two gate families: ``ok_sharpness`` (coverage, focus, monotonicity)
    and ``ok_soft_monotonic`` (path coverage, monotonicity), for
    soft-monotonic attention (``bah_mon``), whose weights are wide even when
    perfectly aligned.  ``ok`` is the family ``soft_monotonic`` selects,
    named by ``gate``; both verdicts are always reported, so comparisons
    across attention types see which bar each decode met.
    """
    alignment = np.asarray(alignment, np.float32)
    coverage = float((alignment.max(axis=1)
                      > coverage_threshold).mean())
    focus = float(alignment.max(axis=0).mean())
    path = alignment.argmax(axis=0)
    monotonicity = (1.0 if len(path) < 2 else
                    float((np.diff(path) >= -2).mean()))
    n_in = alignment.shape[0]
    visited = np.zeros(n_in, bool)
    for p in np.unique(path):
        visited[max(0, p - 2):p + 3] = True
    path_coverage = float(visited.mean())
    ok_soft = bool(path_coverage >= min_coverage
                   and monotonicity >= min_monotonicity)
    ok_sharp = bool(coverage >= min_coverage and focus >= min_focus
                    and monotonicity >= min_monotonicity)
    return {
        "ok": ok_soft if soft_monotonic else ok_sharp,
        "gate": "soft_monotonic" if soft_monotonic else "sharpness",
        "ok_sharpness": ok_sharp,
        "ok_soft_monotonic": ok_soft,
        "coverage": coverage,
        "focus": focus,
        "monotonicity": monotonicity,
        "path_coverage": path_coverage,
    }


def make_sharded_synthesis(config: Config, plan, max_steps: int):
    """Batched synthesis over the data axis of a mesh ``plan``: greedy
    decode and the Griffin-Lim vocoder, each rank on its block of rows, the
    counterpart of the JAX package's ``make_sharded_synthesis``.

    Returns ``fn(model, inputs, input_lengths, speaker_id) -> (wavs,
    alignments)``.  Every rank passes the global batch ([N, T_in] token ids,
    [N] lengths, [N] speaker ids or None) and the same ``model`` (weights
    placed by ``parallel.mesh.shard_params``); rank ``r`` of the data group
    decodes and vocodes row block ``r``, and an all-gather returns the
    global ``wavs`` [N, samples] and ``alignments`` [N, T_in, max_steps] on
    every rank (where JAX returns arrays sharded on the batch).  ``N`` must
    divide by the data axis.

    The engine rules are JAX's: ``griffin_lim_impl="auto"`` runs
    ``"matmul_half"`` and ``ola_impl="auto"`` the plain overlap-add
    (``"xla"``); ``"fused"`` raises; an explicit ``ola_impl="pallas"`` (the
    overlap-add kernel) or ``griffin_lim_impl="pallas"`` (the spectral-step
    kernel, with the overlap-add kernel) runs its kernel.  Without a
    process group the plan has no data group and one process runs every
    row."""
    audio_cfg = config.audio
    if audio_cfg.ola_impl == "auto":
        audio_cfg = dataclasses.replace(audio_cfg, ola_impl="xla")
    if audio_cfg.griffin_lim_impl == "auto":
        audio_cfg = dataclasses.replace(audio_cfg,
                                        griffin_lim_impl="matmul_half")
    elif audio_cfg.griffin_lim_impl == "fused":
        raise ValueError(
            "griffin_lim_impl='fused' (a Pallas kernel) is not validated "
            "under SPMD partitioning; use 'auto' or an XLA engine "
            "('matmul_half'/'matmul_bf16'/'fft') for sharded synthesis")
    shard = None if plan is None else plan.shard

    @torch.inference_mode()
    def fn(model, inputs, input_lengths, speaker_id):
        dev = next(model.parameters()).device
        rows = [None if x is None else torch.as_tensor(x).to(dev)
                for x in (inputs, input_lengths, speaker_id)]
        if shard is not None:
            if rows[0].shape[0] % shard.size:
                raise ValueError(
                    f"the global batch of {rows[0].shape[0]} does not "
                    f"divide over the data axis's {shard.size} ranks")
            rows = [None if x is None else shard.rows(x) for x in rows]
        ids, lengths, speakers = rows
        if config.model.num_speakers <= 1:
            speakers = None
        out = model(ids, lengths, speaker_id=speakers, max_steps=max_steps)
        wavs = dsp_chip.batched_linear_to_waveform(out["linear_outputs"],
                                                   audio_cfg)
        aligns = out["alignments"]
        if shard is not None:
            wavs, aligns = shard.all_gather(wavs), shard.all_gather(aligns)
        return wavs, aligns

    return fn


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
    # the fast vocoder's Griffin-Lim iterations and momentum (JAX's values)
    FAST_GRIFFIN_LIM_ITERS = 30
    FAST_GRIFFIN_LIM_MOMENTUM = 0.99

    @classmethod
    def fast_audio(cls, audio):
        """``audio`` with the fast vocoder's iterations and momentum."""
        return dataclasses.replace(
            audio, griffin_lim_iters=cls.FAST_GRIFFIN_LIM_ITERS,
            griffin_lim_momentum=cls.FAST_GRIFFIN_LIM_MOMENTUM)

    def __init__(self, device=None):
        self.device = resolve_device(device)
        # fp32 parity with the reference: no TF32 in matmuls or cuDNN
        # convs; bf16 products summed in float32, as XLA sums them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        torch.backends.cudnn.allow_tf32 = False
        self.config: Optional[Config] = None
        self.model: Optional[Tacotron] = None
        # (bucket, steps, manual, trim, fast, wire, chunk size) -> graph
        self._graphs: Dict[tuple, Graphed] = {}
        self._graph_set = GraphSet(self.device, owner="synth")
        # a graph's static buffers serve one call at a time
        self._graph_lock = threading.Lock()

    # ------------------------------------------------------------------ load

    def _new_model(self, config: Config) -> Tacotron:
        self.config = config
        return Tacotron(config.model,
                        vocab_size=vocab_size_for(config.data.symbol_set))

    def _install(self, model: Tacotron) -> "Synthesizer":
        self.model = model.to(self.device).eval()
        self._graphs.clear()  # captured on the previous model's weights
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
        """Weights and config of a run directory the port's trainer (or
        ``python -m tacotron_tpu_torch.compat import``) wrote
        (``config.json`` and ``checkpoints/<step>/variables.npz``): the
        checkpoint at ``step``, default the newest."""
        from ..train.checkpoint import checkpoint_path, load_run_config
        return self.load_npz(checkpoint_path(run_dir, step),
                             load_run_config(run_dir))

    def cleaner_names(self) -> List[str]:
        return list(self.config.data.cleaner_names())

    # ------------------------------------------------------- device program

    @torch.inference_mode()
    def _forward(self, inputs, input_lengths, speaker_id, manual, is_manual,
                 max_steps: int) -> Dict[str, torch.Tensor]:
        """The greedy decode alone: ``linear_outputs`` [N, steps*r, F],
        ``mel_outputs`` and ``alignments`` [N, T_in, steps] on the
        device."""
        return self.model(inputs, input_lengths, speaker_id=speaker_id,
                          max_steps=max_steps, manual_alignments=manual,
                          is_manual=is_manual)

    @torch.inference_mode()
    def _vocode_chunk(self, inputs, input_lengths, speaker_id, manual,
                      is_manual, max_steps: int, trim: bool, fast: bool,
                      wire: str):
        """Decode -> attention trim -> masked batched Griffin-Lim -> packed
        waveform (int16 rows + ends row + dB*100 denominator row, or the
        uint8 mu-law layout).  Returns (packed, alignments, stamps) on the
        device: ``stamps`` the clock (ns; ``ops/kernels/stamp.py``) in
        stream order before the decode, after the decode and post-net, and
        after the pack."""
        audio_cfg = (self.fast_audio(self.config.audio) if fast
                     else self.config.audio)
        r = self.config.model.reduction_factor
        stamps = torch.empty(3, dtype=torch.int64, device=inputs.device)
        stamp(stamps, 0)
        out = self._forward(inputs, input_lengths, speaker_id, manual,
                            is_manual, max_steps)
        stamp(stamps, 1)
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
        else:
            wav_i16 = torch.clamp(wavs * (32767.0 / denom),
                                  -32768, 32767).to(torch.int16)
            extra = torch.zeros((2, S), dtype=torch.int16,
                                device=wavs.device)
            n = min(N, S)
            extra[0, :n] = ends[:n].to(torch.int16)
            extra[1, :n] = denom_q[:n].to(torch.int16)
            packed = torch.cat([wav_i16, extra], dim=0)
        stamp(stamps, 2)
        return packed, aligns, stamps

    # -------------------------------------------------------------- prewarm

    def prewarm(self, token_buckets: Sequence[int] = (32, 64),
                batch_sizes: Sequence[int] = (1,),
                max_steps: Optional[int] = None,
                attention_trim: bool = True,
                fast_vocoder: bool = True,
                wire_format: str = "int16") -> int:
        """Capture the serving programs ahead of the first request: one CUDA
        graph of :meth:`_vocode_chunk` per (token bucket, decode-step rung,
        chunk size), on the zero inputs the JAX package compiles its
        programs on.  ``synthesize`` then replays a chunk whose key was
        captured, with its inputs copied into the graph's buffers, and runs
        any other chunk eagerly.  A server calls this before it takes
        requests, so a request pays the replay, not the host's launches of
        ~100 kernels a decoder step.  It captures while no other thread
        uses the card (a capture refuses their work), so a server calls it
        before its worker and HTTP threads start.

        With ``max_steps=None`` each token bucket gets every decode-step
        rung :func:`adaptive_max_steps` can choose for the texts that route
        to it (:func:`prewarm_step_rungs`).  ``batch_sizes`` are chunk
        sizes, powers of two as ``synthesize`` pads its chunks.  On the CPU
        the same keys are warmed up and called on their static buffers.
        :meth:`prewarm_args` gives the arguments that capture the programs
        of one ``synthesize`` call.

        Returns the number of programs (captured now or before)."""
        if self.model is None:
            raise RuntimeError("call init_random() or load_variables() first")
        if wire_format not in ("int16", "mulaw8"):
            raise ValueError(f"unknown wire_format {wire_format!r}")
        gc.collect()  # no graph may be freed inside a capture (utils/graphs)
        spk_on = self.config.model.num_speakers > 1
        n = 0
        buckets = sorted(token_buckets)
        rungs = prewarm_step_rungs(self.config, buckets, max_steps)
        for bucket in buckets:
            for steps in rungs[bucket]:
                for nb in batch_sizes:
                    key = (bucket, steps, False, bool(attention_trim),
                           bool(fast_vocoder), wire_format, nb)
                    if key not in self._graphs:
                        self._graphs[key] = self._graph_set.capture(
                            functools.partial(
                                self._vocode_chunk, max_steps=steps,
                                trim=attention_trim, fast=fast_vocoder,
                                wire=wire_format),
                            torch.zeros((nb, bucket), dtype=torch.int64),
                            torch.ones((nb,), dtype=torch.int64),
                            (torch.zeros((nb,), dtype=torch.int64)
                             if spk_on else None),
                            None, torch.tensor(False))
                    n += 1
        return n

    def prewarm_args(self, texts: Sequence[str],
                     max_steps: Optional[int] = None,
                     token_bucket: int = 32, attention_trim: bool = True,
                     fast_vocoder: bool = False,
                     wire_format: str = "int16") -> dict:
        """The :meth:`prewarm` arguments that capture the programs a
        ``synthesize`` call with these arguments replays: its token bucket,
        decode steps and chunk sizes.  (``fast_vocoder`` defaults as in
        ``synthesize``.)"""
        symbols = self.config.data.symbol_set
        seq_lens = [len(text_to_sequence(t, self.cleaner_names(),
                                         symbol_set=symbols)) for t in texts]
        bucket, steps = self._budget(seq_lens, max_steps, token_bucket)
        return dict(token_buckets=(bucket,),
                    batch_sizes=tuple(sorted({nb for _, _, nb in
                                              self._chunks(len(texts))})),
                    max_steps=steps, attention_trim=attention_trim,
                    fast_vocoder=fast_vocoder, wire_format=wire_format)

    def _budget(self, seq_lens: Sequence[int], max_steps: Optional[int],
                token_bucket: int) -> Tuple[int, int]:
        """(padded token length, decode steps) of a call: the longest text
        rounded up to ``token_bucket``, and ``max_steps`` or the adaptive
        budget of the longest text."""
        cfg = self.config
        steps = (max_steps if max_steps is not None else
                 adaptive_max_steps(max(seq_lens), cfg.data.min_iters,
                                    cfg.model.max_iters,
                                    steps_per_token=cfg.model.steps_per_token))
        return _round_up(max(seq_lens), token_bucket), steps

    def _chunks(self, n: int) -> List[Tuple[int, int, int]]:
        """(first, end, padded size) of each vocoder chunk of ``n``
        utterances: at most ``VOCODER_MAX_BATCH``, padded to a power of
        two."""
        out = []
        for lo in range(0, n, self.VOCODER_MAX_BATCH):
            hi = min(n, lo + self.VOCODER_MAX_BATCH)
            out.append((lo, hi, 1 << (hi - lo - 1).bit_length()))
        return out

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
                   collect_timings: bool = False,
                   wire_format: str = "int16",
                   ) -> Dict[str, List]:
        """texts -> waveforms.

        Returns ``wavs`` (float32 at true Griffin-Lim amplitude: the chip
        path undoes the peak normalization of its wire), ``alignments``
        ([T_in, T_dec] each, cropped to the text), ``linear``,
        ``sequences`` and ``ends`` (the trimmed frame count of each
        utterance).  ``max_steps=None`` picks the decode budget from the
        longest text (:func:`adaptive_max_steps`).

        ``vocode``: ``"chip"`` runs the whole chain on the device
        (``linear`` is None: the spectrograms stay there); ``"host"``
        fetches the trimmed spectrograms ([T_dec*r, F] each, in ``linear``)
        and inverts them with the numpy Griffin-Lim; ``"none"`` returns the
        spectrograms and empty waveforms.

        ``manual_attention_mode`` 1-3 decodes once for the alignments,
        applies :func:`posthoc_attention` and decodes again with them as
        manual alignments.  ``fast_vocoder`` (chip path) runs 30
        momentum-0.99 Griffin-Lim iterations instead of 60 classic ones;
        ``wire_format="mulaw8"`` (chip path) packs 8-bit mu-law.
        ``return_alignments=False`` (chip path) skips fetching the
        alignments.  A chip-path chunk whose key :meth:`prewarm` captured
        replays its graph, bit-equal to the eager call; the replays of
        concurrent calls take turns on the graphs' buffers.

        Every call records its phases as spans (``utils/trace.py``; their
        unit id the call's number in the process): ``synth.call`` around
        ``synth.frontend`` (text -> padded ids, budget), and on the chip
        path, per chunk, ``synth.copy_in`` (the padded inputs into a
        graph's static buffers) and ``synth.replay`` (the replay and the
        outputs' clones), then ``synth.fetch`` (``synth.device_wait``, a
        one-element fetch from the last chunk, which returns once every
        chunk's device work is done, and the bulk copy) and
        ``synth.unpack`` (unpack, trims, scaling).  A chunk without
        ``synth.copy_in`` and ``synth.replay`` ran eagerly: a capture miss.

        ``collect_timings=True`` (chip path) adds ``timings``, from those
        spans: the phases ``frontend_ms``, ``dispatch_ms`` (the device
        programs' launches: from the frontend's end to the last chunk
        launched), ``device_ms`` (the device wait), ``fetch_ms`` (the bulk
        copy), ``post_ms`` (``synth.unpack``) and ``total_ms``, which they
        sum to; ``copy_in_ms`` and ``replay_ms`` (summed over the chunks),
        ``decode_device_ms`` and ``vocoder_device_ms`` (the device's clock
        stamps of each chunk, :meth:`_vocode_chunk`, summed), ``chunks``
        and ``chunks_replayed``.
        """
        if self.model is None:
            raise RuntimeError("call init_random() or load_variables() first")
        with trace.span("synth.call", unit=next(_CALLS)) as call:
            with trace.span("synth.frontend") as frontend:
                if vocode not in ("chip", "host", "none"):
                    raise ValueError(f"unknown vocode mode {vocode!r}")
                if wire_format not in ("int16", "mulaw8"):
                    raise ValueError(f"unknown wire_format {wire_format!r}")
                if wire_format != "int16" and vocode != "chip":
                    raise ValueError("wire_format applies to the chip path "
                                     "only")
                cfg = self.config
                dev = self.device
                if sequences is None:
                    sequences = [text_to_sequence(
                        t, self.cleaner_names(),
                        symbol_set=cfg.data.symbol_set) for t in texts]
                seq_lens = [len(s) for s in sequences]
                N = len(sequences)
                call.attrs["texts"] = N

                adaptive = max_steps is None
                bucket, steps = self._budget(seq_lens, max_steps,
                                             token_bucket)
                inputs = np.zeros((N, bucket), np.int64)
                for i, s in enumerate(sequences):
                    inputs[i, :len(s)] = s
                # lengths include the EOS token; sequences without one use
                # their true length
                has_eos = (inputs == EOS_ID).any(axis=1)
                input_lengths = np.where(
                    has_eos, np.argmax(inputs == EOS_ID, axis=1) + 1,
                    np.asarray(seq_lens)).astype(np.int64)

                spk = None
                if cfg.model.num_speakers > 1:
                    spk = (np.asarray(speaker_ids, np.int64)
                           if speaker_ids is not None
                           else np.zeros((N,), np.int64))

                man = None
                is_manual = torch.tensor(manual_alignments is not None,
                                         device=dev)
                if manual_alignments is not None:
                    # [N, T_in, T_dec] -> [N, T_dec, T_in], cropped/padded
                    man = np.zeros((N, steps, bucket), np.float32)
                    src = np.transpose(manual_alignments, (0, 2, 1))
                    man[:, :min(steps, src.shape[1]),
                        :min(bucket, src.shape[2])] = \
                        src[:, :steps, :bucket]

            def on_device(arr):
                return None if arr is None else torch.from_numpy(arr).to(dev)

            if manual_attention_mode > 0:
                # first pass for the computed alignments only, then decode
                # again with their post-hoc transform as manual alignments
                out = self._forward(on_device(inputs),
                                    on_device(input_lengths),
                                    on_device(spk), on_device(man), is_manual,
                                    steps)
                new_man = posthoc_attention(out["alignments"].cpu().numpy(),
                                            manual_attention_mode)
                return self.synthesize(
                    sequences=sequences, speaker_ids=speaker_ids,
                    max_steps=steps, manual_alignments=new_man,
                    attention_trim=attention_trim, librosa_trim=librosa_trim,
                    vocode=vocode, token_bucket=token_bucket,
                    return_alignments=return_alignments,
                    fast_vocoder=fast_vocoder,
                    collect_timings=collect_timings, wire_format=wire_format)

            r = cfg.model.reduction_factor
            hop = cfg.audio.hop_length
            full_frames = steps * r
            wavs: List[np.ndarray] = []
            aligns: List[np.ndarray] = []
            all_ends: List[int] = []
            specs: Optional[List[np.ndarray]] = None
            copies: List[trace.Span] = []
            replays: List[trace.Span] = []

            if vocode == "chip":
                def padded(arr, nb, fill, lo, hi):
                    out = np.full((nb,) + arr.shape[1:], fill, arr.dtype)
                    out[:hi - lo] = arr[lo:hi]
                    return torch.from_numpy(out)

                pending = []
                chunks = self._chunks(N)
                call.attrs["chunks"] = len(chunks)
                for lo, hi, nb in chunks:
                    args = (padded(inputs, nb, 0, lo, hi),
                            padded(input_lengths, nb, 1, lo, hi),
                            None if spk is None
                            else padded(spk, nb, 0, lo, hi),
                            None if man is None
                            else padded(man, nb, 0, lo, hi),
                            is_manual)
                    key = (bucket, steps, man is not None,
                           bool(attention_trim), bool(fast_vocoder),
                           wire_format, nb)
                    graphed = self._graphs.get(key)
                    if graphed is None:
                        out = self._vocode_chunk(
                            *(None if a is None else a.to(dev)
                              for a in args),
                            steps, attention_trim, fast_vocoder, wire_format)
                    else:
                        # the next replay overwrites the graph's outputs
                        with self._graph_lock:
                            with trace.span("synth.copy_in") as copy_in:
                                graphed.copy_in(*args)
                            with trace.span("synth.replay") as replay:
                                out = tuple(t.clone()
                                            for t in graphed.replay())
                        copies.append(copy_in)
                        replays.append(replay)
                    pending.append((lo, hi, out))
                with trace.span("synth.fetch") as fetch:
                    with trace.span("synth.device_wait") as device_wait:
                        float(pending[-1][2][0][0, 0])
                    fetched = [(lo, hi, packed.cpu().numpy(),
                                al.cpu().numpy() if return_alignments
                                else None)
                               for lo, hi, (packed, al, _) in pending]
                    stamps = (torch.stack([out[2] for *_, out in pending])
                              .cpu().numpy() if collect_timings else None)
            else:
                out = self._forward(on_device(inputs),
                                    on_device(input_lengths),
                                    on_device(spk), on_device(man), is_manual,
                                    steps)
                # [N, bucket, T_dec] and [N, T_dec*r, F]
                alignments = out["alignments"].cpu().numpy()
                linear = out["linear_outputs"].cpu().numpy()
                specs = []
                for i in range(N):
                    spec = linear[i]
                    align = alignments[i, :seq_lens[i], :]
                    if attention_trim:
                        end = attention_trim_index(align, seq_lens[i], r)
                        spec = spec[:max(end, r)]
                    specs.append(spec)
                    aligns.append(align)
                    all_ends.append(len(spec))
                if vocode == "host":
                    wavs = [dsp_host.inv_spectrogram(spec.T, cfg.audio)
                            for spec in specs]
                else:
                    wavs = [np.zeros((0,), np.float32) for _ in specs]

            with trace.span("synth.unpack") as unpack:
                if vocode == "chip":
                    for lo, hi, packed, al in fetched:
                        if wire_format == "mulaw8":
                            wav_rows = mulaw_decode(packed[:-4])
                            ends = (packed[-4].astype(np.int32)
                                    | (packed[-3].astype(np.int32) << 8))
                            denom_db = ((packed[-2].astype(np.int32)
                                         | (packed[-1].astype(np.int32)
                                            << 8))
                                        - 32768).astype(np.float32) / 100.0
                            scale = 10.0 ** (denom_db / 20.0)
                        else:
                            wav_rows = packed[:-2]
                            ends = packed[-2].astype(np.int32)
                            scale = (10.0 ** (packed[-1].astype(np.float32)
                                              / 100.0 / 20.0)) / 32767.0
                        for i in range(hi - lo):
                            all_ends.append(int(ends[i]))
                            n_samples = min(wav_rows.shape[1],
                                            int(ends[i]) * hop)
                            wavs.append(
                                wav_rows[i, :n_samples].astype(np.float32)
                                * np.float32(scale[i]))
                            if al is not None:
                                aligns.append(al[i, :seq_lens[lo + i], :])

                if librosa_trim and vocode != "none":
                    wavs = [trim_silence_db(w) for w in wavs]
                budget_hits = sum(e >= full_frames for e in all_ends)
                if adaptive and attention_trim and budget_hits \
                        and steps < cfg.model.max_iters:
                    warnings.warn(
                        f"{budget_hits}/{N} utterance(s) consumed the "
                        f"entire adaptive decode budget ({steps} steps at "
                        f"{cfg.model.steps_per_token} steps/token) and may "
                        f"be truncated; raise ModelConfig.steps_per_token "
                        f"or pass max_steps explicitly", stacklevel=2)

        result = {"wavs": wavs, "alignments": aligns, "linear": specs,
                  "sequences": list(sequences), "ends": all_ends}
        if collect_timings and vocode == "chip":
            device_ms = device_wait.ms
            result["timings"] = {
                "frontend_ms": (frontend.end_ns - call.start_ns) / 1e6,
                "dispatch_ms": (fetch.start_ns - frontend.end_ns) / 1e6,
                "device_ms": device_ms,
                "fetch_ms": fetch.ms - device_ms,
                "post_ms": (unpack.end_ns - fetch.end_ns) / 1e6,
                "total_ms": (unpack.end_ns - call.start_ns) / 1e6,
                "copy_in_ms": sum(s.ms for s in copies),
                "replay_ms": sum(s.ms for s in replays),
                "decode_device_ms": float(
                    (stamps[:, 1] - stamps[:, 0]).sum()) / 1e6,
                "vocoder_device_ms": float(
                    (stamps[:, 2] - stamps[:, 1]).sum()) / 1e6,
                "chunks": len(pending),
                "chunks_replayed": len(replays),
            }
        return result

    def synthesize_robust(self, texts: Optional[Sequence[str]] = None,
                          sequences: Optional[Sequence[Sequence[int]]] = None,
                          speaker_ids: Optional[Sequence[int]] = None,
                          retry_mode: int = 1,
                          health_kwargs: Optional[Dict] = None,
                          **kwargs) -> Dict[str, List]:
        """:meth:`synthesize`, then :func:`attention_health` of each
        utterance's first-pass alignment, then one more ``synthesize`` of
        the failed utterances with the post-hoc transform
        (:func:`posthoc_attention`, ``retry_mode`` 1 = argmax one-hot,
        2 = sharpen) of their already fetched alignments as manual
        alignments.

        Adds ``attention_health`` (of the first pass) and ``retried`` (the
        re-decoded indices) to the result; ``retry_mode=0`` diagnoses
        without retrying.  ``soft_monotonic`` defaults to the model's
        attention being ``bah_mon``.  Alignments are always fetched.
        """
        kwargs.pop("return_alignments", None)
        if kwargs.get("manual_attention_mode"):
            raise ValueError(
                "manual_attention_mode conflicts with synthesize_robust's "
                "own retry pass; use plain synthesize() for a global "
                "manual-attention mode")
        res = self.synthesize(texts=texts, sequences=sequences,
                              speaker_ids=speaker_ids,
                              return_alignments=True, **kwargs)
        hk = dict(health_kwargs or {})
        # soft-monotonic attention never exhibits sharpness; judging it by
        # the sharpness gates would retry every healthy decode
        hk.setdefault("soft_monotonic",
                      self.config.model.attention_type == "bah_mon")
        health = [attention_health(al, **hk) for al in res["alignments"]]
        res["attention_health"] = health
        bad = [i for i, h in enumerate(health) if not h["ok"]]
        res["retried"] = bad if retry_mode else []
        if bad and retry_mode:
            bad_aligns = [res["alignments"][i] for i in bad]
            t_in = max(al.shape[0] for al in bad_aligns)
            t_dec = max(al.shape[1] for al in bad_aligns)
            man = np.zeros((len(bad), t_in, t_dec), np.float32)
            for j, al in enumerate(bad_aligns):
                man[j, :al.shape[0], :al.shape[1]] = al
            retry = self.synthesize(
                sequences=[res["sequences"][i] for i in bad],
                speaker_ids=(None if speaker_ids is None
                             else [speaker_ids[i] for i in bad]),
                manual_alignments=posthoc_attention(man, retry_mode),
                return_alignments=True, **kwargs)
            for j, i in enumerate(bad):
                for key in ("wavs", "alignments", "ends"):
                    res[key][i] = retry[key][j]
                if res["linear"] is not None:
                    res["linear"][i] = retry["linear"][j]
        return res

    # ------------------------------------------------- long-text stitching

    def synthesize_long(self, text: str, speaker_id: int = 0,
                        max_chunk_tokens: int = 120,
                        gap_sentence_ms: float = 180.0,
                        gap_clause_ms: float = 80.0,
                        fade_ms: float = 10.0,
                        robust: bool = True,
                        **kwargs) -> Dict:
        """A text of any length as one waveform: :func:`split_text` into
        chunks of at most ``max_chunk_tokens`` tokens, every chunk decoded
        in one batched call (through :meth:`synthesize_robust` when
        ``robust``), linear fades of ``fade_ms`` at every piece edge, and
        ``gap_sentence_ms`` of silence after sentence-final punctuation,
        ``gap_clause_ms`` after a mid-sentence split.

        Returns ``{"wav": float32 [T], "chunks": [str], "parts": <the
        synthesize result>}``.
        """
        cfg = self.config
        chunks = split_text(text, max_chunk_tokens, self.cleaner_names(),
                            symbol_set=cfg.data.symbol_set)
        if not chunks:
            raise ValueError("no synthesizable text after splitting")
        call = self.synthesize_robust if robust else self.synthesize
        res = call(texts=chunks,
                   speaker_ids=[speaker_id] * len(chunks), **kwargs)
        sr = cfg.audio.sample_rate
        # a trim can cut a chunk at a non-zero sample, which clicks against
        # the inserted silence and at the document's ends
        fade = int(sr * fade_ms / 1000.0)  # fade_ms=0 disables
        pieces: List[np.ndarray] = []
        for i, (chunk, wav) in enumerate(zip(chunks, res["wavs"])):
            wav = np.asarray(wav, np.float32)
            n = min(fade, len(wav))
            if n > 0:
                wav = wav.copy()
                wav[:n] *= np.linspace(0.0, 1.0, n, dtype=np.float32)
                wav[-n:] *= np.linspace(1.0, 0.0, n, dtype=np.float32)
            pieces.append(wav)
            if i == len(chunks) - 1:
                continue
            gap = (gap_sentence_ms if chunk.rstrip()[-1:] in _SENT_FINAL
                   else gap_clause_ms)
            pieces.append(np.zeros(int(sr * gap / 1000.0), np.float32))
        return {"wav": np.concatenate(pieces), "chunks": chunks,
                "parts": res}

    # ------------------------------------------------------------- save

    def save_results(self, results: Dict, out_dir: str,
                     prefix: str = "synth") -> List[str]:
        """Write each waveform as a peak-normalized 16-bit wav, and each
        alignment as ``.npy`` and as a PNG heatmap beside it (the PNG needs
        matplotlib; without it the first skip is logged and the rest of
        the call writes wavs and ``.npy`` only)."""
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        aligns = results["alignments"] or [None] * len(results["wavs"])
        plot = True
        for i, (wav, align, seq) in enumerate(zip(
                results["wavs"], aligns, results["sequences"])):
            wav_path = os.path.join(out_dir, f"{prefix}_{i}.wav")
            save_wav(wav, wav_path, self.config.audio.sample_rate)
            if align is not None:
                np.save(wav_path[:-4] + "_alignment.npy", align)
                plot = plot and save_alignment_png(
                    align, wav_path[:-4] + ".png", token_ids=seq,
                    input_length=len(seq))
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
