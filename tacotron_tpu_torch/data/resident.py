"""Device-resident corpus training: the corpus goes to the card's memory
once, and every training batch is gathered there by index from a small host
index array.  A copy of the JAX package's ``data/resident.py``.

Batch composition is exactly the :class:`~.feeder.DataFeeder` pipeline (the
same shuffles from the same rng stream, the same ratio and greedy-phase
policy, the same shapes) over a one-time in-memory preload; only the big
per-example tensors (waveforms, or mel and linear spectrograms) are gathered
on the device.  Resident mode therefore forces
``DataConfig.pad_to_corpus_max``: every example is stored at the corpus-max
bucket shape, so one gather serves every batch.

Single process only: a multi-process run shards the corpus by files, so
each process's store and index space would differ.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..train.step import Batch
from .feeder import PAD, DataFeeder, Example


class ResidentDataFeeder(DataFeeder):
    """DataFeeder whose queue carries ``(small_batch, indices)`` and whose
    big tensors are gathered from a one-time device upload.

    ``small_batch`` is a :class:`Batch` with ``mel_targets`` /
    ``linear_targets`` / ``waveforms`` set to None; ``indices`` is the
    int32 resident-store row per batch element (in final batch order).
    Call :meth:`upload` once, then :meth:`assemble` per step.
    """

    def __init__(self, data_dirs, config: Config, data_type: str = "train",
                 **kwargs):
        if data_type != "train":
            raise ValueError("ResidentDataFeeder is train-only (the test "
                             "feeder's one static batch gains nothing)")
        if kwargs.get("process_count", 1) > 1:
            raise ValueError(
                "device_resident_corpus is single-process only: several "
                "processes stripe the corpus by files, so their stores "
                "would diverge; use the streaming DataFeeder there")
        if kwargs.get("skip_filter", False):
            raise ValueError("device_resident_corpus needs the filter scan "
                             "(it derives the store shape from the corpus "
                             "maxima); drop skip_path_filter")
        # resident storage pads every example to the corpus max, so every
        # batch has the corpus-max bucket shape
        config = config.replace(data=dataclasses.replace(
            config.data, pad_to_corpus_max=True))
        self._cache: Dict[str, Example] = {}
        self.examples: List[Example] = []
        super().__init__(data_dirs, config, data_type=data_type, **kwargs)

        # one-time preload: parse every scanned path with the base parser;
        # corrupt files are dropped from the path lists up front (the
        # streaming feeder skips them per epoch instead)
        for d in self.data_dirs:
            kept = []
            for path in self.path_dict[d]:
                example = DataFeeder._load_path(self, path, d)
                if example is None:
                    continue
                example.resident_index = len(self.examples)
                self.examples.append(example)
                self._cache[path] = example
                kept.append(path)
            self.path_dict[d] = kept
            if not kept:
                raise ValueError(f"no loadable .npz files in {d}")

        limit = config.train.resident_corpus_max_bytes
        if self.resident_nbytes() > limit:
            raise ValueError(
                f"resident corpus needs {self.resident_nbytes() / 2**20:.0f}"
                f" MiB padded (> resident_corpus_max_bytes = "
                f"{limit / 2**20:.0f} MiB); raise the limit if it fits "
                f"device memory, or use the streaming DataFeeder")

    # ------------------------------------------------------------ store

    def _store_shape(self) -> Tuple[int, int]:
        """(tok_len, frame_len): the corpus-max padded bucket shape every
        example is stored (and every batch emitted) at."""
        [(tok_len, frame_len)] = self.bucket_shapes()
        return tok_len, frame_len

    def resident_nbytes(self) -> int:
        n = len(self.examples)
        _, frame_len = self._store_shape()
        if self.emit_waveforms:
            return n * (frame_len - 1) * self.config.audio.hop_length * 2
        mel_d = self.examples[0].mel.shape[1]
        lin_d = self.examples[0].linear.shape[1]
        return n * frame_len * (mel_d + lin_d) * 4

    def host_store(self) -> Dict[str, np.ndarray]:
        """The stacked, corpus-max-padded big tensors (host numpy)."""
        n = len(self.examples)
        _, frame_len = self._store_shape()
        if self.emit_waveforms:
            hop = self.config.audio.hop_length
            wavs = np.zeros((n, (frame_len - 1) * hop), np.int16)
            for e in self.examples:
                wavs[e.resident_index, :len(e.wav)] = e.wav
            return {"waveforms": wavs}
        mel = np.zeros((n, frame_len, self.examples[0].mel.shape[1]),
                       np.float32)
        linear = np.zeros((n, frame_len, self.examples[0].linear.shape[1]),
                          np.float32)
        for e in self.examples:
            mel[e.resident_index, :e.n_frames] = e.mel
            linear[e.resident_index, :e.n_frames] = e.linear
        return {"mel_targets": mel, "linear_targets": linear}

    def upload(self, device) -> Dict[str, torch.Tensor]:
        """Copy the store to ``device`` once; returns the device store."""
        return {k: torch.from_numpy(v).to(device)
                for k, v in self.host_store().items()}

    def assemble(self, store: Dict[str, torch.Tensor], small: Batch,
                 indices: torch.Tensor) -> Batch:
        """One on-device gather per big tensor -> the full :class:`Batch`
        (``small`` and ``indices`` already on the store's device)."""
        return small._replace(**{k: v.index_select(0, indices.long())
                                 for k, v in store.items()})

    # --------------------------------------------------- feeder overrides

    def _load_path(self, path: str, data_dir: str) -> Optional[Example]:
        return self._cache.get(path)

    def _prepare_batch(self, examples: List[Example]):
        """Small fields exactly as the base builds them (same single rng
        shuffle, same corpus-max static shape — kept in lockstep with
        ``DataFeeder._prepare_batch``); big tensors become indices."""
        if self.data_type == "train":
            self.rng.shuffle(examples)
        tok_len, frame_len = self._store_shape()

        n = len(examples)
        inputs = np.full((n, tok_len), PAD, np.int32)
        input_lengths = np.zeros((n,), np.int32)
        loss_coeff = np.zeros((n,), np.float32)
        speaker = np.zeros((n,), np.int32)
        target_lengths = np.zeros((n,), np.int32)
        indices = np.zeros((n,), np.int32)
        for i, e in enumerate(examples):
            inputs[i, :len(e.tokens)] = e.tokens
            input_lengths[i] = len(e.tokens)
            loss_coeff[i] = e.loss_coeff
            speaker[i] = e.speaker_id
            target_lengths[i] = e.n_frames
            indices[i] = e.resident_index
        small = Batch(inputs=inputs, input_lengths=input_lengths,
                      loss_coeff=loss_coeff, mel_targets=None,
                      linear_targets=None, speaker_id=speaker,
                      target_lengths=target_lengths, waveforms=None)
        return small, indices
