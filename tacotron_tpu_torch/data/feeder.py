"""Bucketed, host-sharded input pipeline: a copy of the JAX package's
``data/feeder.py`` (which imports the JAX ``Batch``), emitting the port's
:class:`~tacotron_tpu_torch.train.step.Batch` of numpy arrays.

The same seed gives the same numpy RNG stream, so the same batches in the
same order as the JAX feeder.  The corpus policy is the reference's
``DataFeeder`` (its ``datasets/datafeeder.py``):

- per-speaker ``.npz`` directory discovery, frame/token filtering
  (120..796 frames, >=min_tokens; ``datafeeder.py:27-76``), blacklist hook;
- speaker_id = index of the data dir (``datafeeder.py:107-108``);
- per-dataset sampling ratios with ``main_data_greedy_factor`` and the
  initial-phase greedy schedule (``datafeeder.py:110-125,222-232``), driven
  by ``start_step`` after a resume;
- groups of ``batches_per_group`` batches sorted by target length then
  shuffled (bucketing; ``datafeeder.py:234-237``);
- test split = last ``n_test`` files, repeated static batches
  (``datafeeder.py:67-70,180-193``).

Kept from the JAX package: token/frame axes pad up to multiples of
``bucket_size_tokens`` / ``bucket_size_frames`` (or the corpus max), each
process strides over every directory's file list, and a daemon thread keeps
a bounded queue of ready batches.  The filter scan reads each file's
``linear`` even in waveform mode, as the JAX scan does.  Each group's build
is a ``feeder.group`` span (``utils/trace.py``) with its ``batches``.
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass
from glob import glob
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..config import Config
from ..train.step import Batch
from ..utils import trace

PAD = 0


class CorpusFormatError(ValueError):
    """The corpus on disk lacks what the configured pipeline needs."""


def _round_up(x: int, multiple: int) -> int:
    r = x % multiple
    return x if r == 0 else x + multiple - r


@dataclass
class Example:
    tokens: np.ndarray
    loss_coeff: float
    mel: Optional[np.ndarray]
    linear: Optional[np.ndarray]
    speaker_id: int
    # waveform mode (TrainConfig.on_device_features): int16 samples are
    # shipped instead of spectrograms; frame count comes from the sample
    # count (same formula the builder's STFT used)
    wav: Optional[np.ndarray] = None
    hop_length: int = 0
    # row in the device-resident store (data/resident.py); -1 = streaming
    resident_index: int = -1

    @property
    def n_frames(self) -> int:
        if self.linear is not None:
            return self.linear.shape[0]
        return 1 + len(self.wav) // self.hop_length


def scan_data_dirs(data_dirs: Sequence[str], config: Config,
                   data_type: str, n_test: int,
                   rng: np.random.RandomState,
                   skip_filter: bool = False,
                   blacklists: Sequence[str] = (),
                   process_index: int = 0,
                   process_count: int = 1,
                   corpus_max: Optional[dict] = None,
                   length_records: Optional[list] = None
                   ) -> Dict[str, List[str]]:
    """Discover + filter per-dir npz paths and split train/test
    (reference ``get_path_dict``, ``datafeeder.py:27-76``).

    When ``corpus_max`` (a dict) is passed, records the corpus-wide maxima
    under keys ``tokens``/``frames`` for fixed-shape padding.  When
    ``length_records`` (a list) is passed, appends ``(n_tokens, n_frames)``
    per kept file, the raw material of :meth:`DataFeeder.bucket_shapes`
    (the scan reads the headers anyway, so this is free)."""
    dc, mc = config.data, config.model
    min_frames = mc.reduction_factor * dc.min_iters
    max_frames = mc.reduction_factor * dc.max_iters - mc.reduction_factor

    path_dict: Dict[str, List[str]] = {}
    for data_dir in data_dirs:
        paths = sorted(glob(os.path.join(data_dir, "*.npz")))
        if not skip_filter:
            kept = []
            for path in paths:
                if any(b in path for b in blacklists):
                    continue
                try:
                    with np.load(path) as data:
                        n_frame = data["linear"].shape[0]
                        n_tokens = len(data["tokens"])
                except Exception:
                    continue
                if (min_frames <= n_frame <= max_frames
                        and n_tokens >= dc.min_tokens):
                    kept.append(path)
                    if length_records is not None:
                        length_records.append((n_tokens, n_frame))
                    if corpus_max is not None:
                        corpus_max["tokens"] = max(
                            corpus_max.get("tokens", 0), n_tokens)
                        corpus_max["frames"] = max(
                            corpus_max.get("frames", 0), n_frame)
            paths = kept
        # Split on the sorted order, THEN shuffle the train subset (the
        # reference shuffled first, which leaked its held-out set into
        # training; the JAX package fixed that and so does the copy)
        if data_type == "train":
            paths = paths[:-n_test] if n_test else paths
            rng.shuffle(paths)
        elif data_type == "test":
            paths = paths[-n_test:]
        else:
            raise ValueError(f"unknown data_type: {data_type}")
        # per-host shard: disjoint stripes of each dir's list
        path_dict[data_dir] = paths[process_index::process_count]
    return path_dict


class DataFeeder:
    """Iterable over ready-to-shard :class:`Batch` pytrees of numpy arrays."""

    def __init__(self, data_dirs: Sequence[str], config: Config,
                 data_type: str = "train",
                 batch_size: Optional[int] = None,
                 n_test: Optional[int] = None,
                 seed: int = 123,
                 skip_filter: bool = False,
                 blacklists: Sequence[str] = (),
                 process_index: int = 0,
                 process_count: int = 1,
                 prefetch: int = 8,
                 start_step: int = 0):
        self.config = config
        self.data_type = data_type
        self.batch_size = batch_size or config.train.batch_size
        self.rng = np.random.RandomState(seed)
        self._step = start_step
        # on-device feature extraction: ship int16 waveforms, not
        # precomputed spectrograms (TrainConfig.on_device_features)
        self.emit_waveforms = config.train.on_device_features

        self.corpus_max: dict = {}
        self.length_records: list = []
        self.path_dict = scan_data_dirs(
            data_dirs, config, data_type,
            n_test if n_test is not None else self.batch_size,
            self.rng, skip_filter, blacklists, process_index, process_count,
            corpus_max=self.corpus_max, length_records=self.length_records)
        self.data_dirs = list(self.path_dict.keys())
        self.dir_to_id = {d: i for i, d in enumerate(self.data_dirs)}
        self._offsets = {d: 0 for d in self.data_dirs}

        for d, paths in self.path_dict.items():
            if not paths:
                raise ValueError(f"no usable .npz files in {d} "
                                 f"(data_type={data_type})")

        # per-dataset sampling weights (datafeeder.py:110-125)
        tc = config.train
        weights = {d: 1.0 for d in self.data_dirs}
        if tc.main_data_greedy_factor > 0:
            for main in tc.main_data:
                if not main:
                    continue
                for d in self.data_dirs:
                    if main in d:
                        weights[d] += tc.main_data_greedy_factor
        z = sum(weights.values())
        self.data_ratio = {d: w / z for d, w in weights.items()}

        self._queue: Optional[queue.Queue] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

        if data_type == "test":
            examples = []
            while len(examples) < self.batch_size:
                for d in self.data_dirs:
                    examples.append(self._next_example(d))
                    if len(examples) >= self.batch_size:
                        break
            self._static_batch = self._prepare_batch(examples)
        else:
            self._static_batch = None

    # ------------------------------------------------------------- examples

    def _load_path(self, path: str, data_dir: str) -> Optional[Example]:
        """Parse one ``.npz`` into an :class:`Example`; ``None`` for a
        corrupt file (skipped, ``datafeeder.py:260-267``), raises
        :class:`CorpusFormatError` for a config-level mismatch.
        Overridable hook: :class:`~.resident.ResidentDataFeeder` serves
        the same parse from its one-time in-memory preload."""
        try:
            with np.load(path) as data:
                if self.emit_waveforms:
                    if "wav" not in data:
                        raise CorpusFormatError(
                            f"{path} has no 'wav' key: "
                            "TrainConfig.on_device_features needs a "
                            "corpus built with "
                            "DataConfig.store_waveform")
                    return Example(
                        tokens=np.asarray(data["tokens"], np.int32),
                        loss_coeff=float(data["loss_coeff"])
                        if "loss_coeff" in data else 1.0,
                        mel=None, linear=None,
                        speaker_id=self.dir_to_id[data_dir],
                        wav=np.asarray(data["wav"], np.int16),
                        hop_length=self.config.audio.hop_length)
                return Example(
                    tokens=np.asarray(data["tokens"], np.int32),
                    loss_coeff=float(data["loss_coeff"])
                    if "loss_coeff" in data else 1.0,
                    mel=np.asarray(data["mel"], np.float32),
                    linear=np.asarray(data["linear"], np.float32),
                    speaker_id=self.dir_to_id[data_dir])
        except CorpusFormatError:
            raise  # a config error, not a corrupt file — surface it
        except Exception:
            return None

    def _next_example(self, data_dir: str) -> Example:
        paths = self.path_dict[data_dir]
        while True:
            if self._offsets[data_dir] >= len(paths):
                self._offsets[data_dir] = 0
                if self.data_type == "train":
                    self.rng.shuffle(paths)
            path = paths[self._offsets[data_dir]]
            self._offsets[data_dir] += 1
            example = self._load_path(path, data_dir)
            if example is not None:
                return example

    # --------------------------------------------------------------- groups

    def _choose_dir(self) -> str:
        """Initial-phase greedy main-data schedule (datafeeder.py:222-232)."""
        tc = self.config.train
        if (tc.initial_data_greedy and self._step < tc.initial_phase_step):
            for main in tc.main_data:
                if main:
                    for d in self.data_dirs:
                        if main in d:
                            return d
        dirs = self.data_dirs
        probs = [self.data_ratio[d] for d in dirs]
        return dirs[self.rng.choice(len(dirs), p=np.asarray(probs) / sum(probs))]

    def _make_group(self) -> List[Batch]:
        n = self.batch_size
        group_examples: List[Example] = []
        total = n * self.config.data.batches_per_group
        tc = self.config.train
        if self._step < tc.initial_phase_step:
            per_dir = max(1, total // len(self.data_dirs))
            for d in self.data_dirs:
                target = (self._choose_dir()
                          if tc.initial_data_greedy else d)
                group_examples.extend(
                    self._next_example(target) for _ in range(per_dir))
        else:
            for d in self.data_dirs:
                count = int(total * self.data_ratio[d])
                group_examples.extend(
                    self._next_example(d) for _ in range(count))
        # bucketing: sort by output length, chunk, shuffle batches
        group_examples.sort(key=lambda e: e.n_frames)
        batches = [group_examples[i:i + n]
                   for i in range(0, len(group_examples) - n + 1, n)]
        self.rng.shuffle(batches)
        return [self._prepare_batch(b) for b in batches]

    # -------------------------------------------------------------- padding

    def _prepare_batch(self, examples: List[Example]) -> Batch:
        if self.data_type == "train":
            self.rng.shuffle(examples)
        dc = self.config.data
        r = self.config.model.reduction_factor

        max_tokens = max(len(e.tokens) for e in examples)
        max_frames = max(e.n_frames for e in examples) + 1
        if dc.pad_to_corpus_max and self.corpus_max:
            # one static shape for the whole run
            max_tokens = max(max_tokens, self.corpus_max["tokens"])
            max_frames = max(max_frames, self.corpus_max["frames"] + 1)
        tok_len = _round_up(max(max_tokens, 1), dc.bucket_size_tokens)
        # +1 then round up to r, like the reference (_prepare_targets), then
        # up to the frame bucket for shape stability
        frame_len = _round_up(_round_up(max_frames, r),
                              max(dc.bucket_size_frames, r))

        n = len(examples)
        inputs = np.full((n, tok_len), PAD, np.int32)
        input_lengths = np.zeros((n,), np.int32)
        loss_coeff = np.zeros((n,), np.float32)
        speaker = np.zeros((n,), np.int32)
        target_lengths = np.zeros((n,), np.int32)
        for i, e in enumerate(examples):
            inputs[i, :len(e.tokens)] = e.tokens
            input_lengths[i] = len(e.tokens)
            loss_coeff[i] = e.loss_coeff
            speaker[i] = e.speaker_id
            target_lengths[i] = e.n_frames

        if self.emit_waveforms:
            # ship int16 samples; the train step extracts features on
            # device (dsp.chip.features_from_waveform).  (frame_len - 1)
            # * hop samples yield exactly frame_len STFT frames; the
            # zero-padded tail produces exactly-0.0 normalized frames,
            # the same padding value the precomputed targets use.
            hop = self.config.audio.hop_length
            wavs = np.zeros((n, (frame_len - 1) * hop), np.int16)
            for i, e in enumerate(examples):
                wavs[i, :len(e.wav)] = e.wav
            return Batch(inputs=inputs, input_lengths=input_lengths,
                         loss_coeff=loss_coeff, mel_targets=None,
                         linear_targets=None, speaker_id=speaker,
                         target_lengths=target_lengths, waveforms=wavs)

        mel = np.zeros((n, frame_len, examples[0].mel.shape[1]), np.float32)
        linear = np.zeros((n, frame_len, examples[0].linear.shape[1]),
                          np.float32)
        for i, e in enumerate(examples):
            mel[i, :e.n_frames] = e.mel
            linear[i, :e.n_frames] = e.linear
        return Batch(inputs=inputs, input_lengths=input_lengths,
                     loss_coeff=loss_coeff, mel_targets=mel,
                     linear_targets=linear, speaker_id=speaker,
                     target_lengths=target_lengths)

    # ---------------------------------------------------------- bucket ladder

    def bucket_shapes(self) -> List[tuple]:
        """The set of ``(tok_len, frame_len)`` padded batch shapes this
        corpus can produce.

        A batch's token axis pads to ``round_up(max tokens)`` and its frame
        axis to ``round_up(round_up(max frames + 1, r), frame_bucket)`` —
        both maxima over the batch, so every batch shape is a pair of
        *per-example* bucket values attained by possibly different
        examples.  A pair ``(T, F)`` is therefore reachable iff some
        example attains token bucket ``T`` with frame bucket <= ``F`` AND
        some example attains frame bucket ``F`` with token bucket <= ``T``
        (token and frame lengths are strongly correlated, so the full
        toks x frames cross product holds shapes that never occur).  Returns
        the reachable pairs, sorted; with ``pad_to_corpus_max`` this
        collapses to the single corpus-max shape.  Empty when the filter
        scan was skipped (no length records)."""
        dc = self.config.data
        r = self.config.model.reduction_factor
        fb = max(dc.bucket_size_frames, r)

        def tok_bucket(n_tokens: int) -> int:
            return _round_up(max(n_tokens, 1), dc.bucket_size_tokens)

        def frame_bucket(n_frames: int) -> int:
            return _round_up(_round_up(n_frames + 1, r), fb)

        if dc.pad_to_corpus_max and self.corpus_max:
            return [(tok_bucket(self.corpus_max["tokens"]),
                     frame_bucket(self.corpus_max["frames"]))]
        if not self.length_records:
            return []
        pairs = {(tok_bucket(t), frame_bucket(f))
                 for t, f in self.length_records}
        toks = sorted({t for t, _ in pairs})
        frames = sorted({f for _, f in pairs})
        reachable = []
        for T in toks:
            min_f_at_t = min(f for t, f in pairs if t == T)
            for F in frames:
                if F >= min_f_at_t and any(
                        t <= T and f == F for t, f in pairs):
                    reachable.append((T, F))
        return sorted(reachable)

    # ------------------------------------------------------------ iteration

    def batches(self) -> Iterator[Batch]:
        """Unbounded batch stream (static repeats for test feeders)."""
        while True:
            if self._static_batch is not None:
                self._step += 1
                yield self._static_batch
                continue
            # .npz loads, sort and padding, on the thread that iterates
            with trace.span("feeder.group") as group:
                made = self._make_group()
                group.attrs["batches"] = len(made)
            for batch in made:
                self._step += 1
                yield batch

    # ------------------------------------------------------------- prefetch

    def start(self, prefetch: int = 8) -> "DataFeeder":
        """Spawn the background producer thread."""
        if self._thread is not None:
            return self
        self._queue = queue.Queue(maxsize=prefetch)
        self._stop.clear()

        def producer():
            try:
                for batch in self.batches():
                    while not self._stop.is_set():
                        try:
                            self._queue.put(batch, timeout=0.5)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
            except BaseException as e:  # propagate to consumer
                self._error = e

        self._thread = threading.Thread(target=producer, daemon=True)
        self._thread.start()
        return self

    def get(self, timeout: float = 60.0) -> Batch:
        if self._queue is None:
            raise RuntimeError("call start() before get()")
        while True:
            if self._error is not None:
                raise self._error
            try:
                return self._queue.get(timeout=0.5)
            except queue.Empty:
                timeout -= 0.5
                if timeout <= 0:
                    raise TimeoutError("feeder produced no batch in time")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
