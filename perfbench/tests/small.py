"""Cells of BENCHMARK.json cut to widths a CPU test can run: every width
divided by 8, a 512-point STFT, a few texts a call, batch 4.  The cut
touches only the in-memory copies."""

from __future__ import annotations

import types
from pathlib import Path

import torch

from perfbench import core

CPU = torch.device("cpu")


def shrink(cfg: dict) -> None:
    m = cfg["model"]
    for k in ("embedding_size", "enc_rnn_size", "attention_size",
              "attention_state_size", "dec_rnn_size", "post_rnn_size",
              "enc_bank_channel_size", "post_bank_channel_size",
              "speaker_embedding_size"):
        m[k] = max(2, m[k] // 8)
    m.update(enc_prenet_sizes=[32, 16], enc_proj_sizes=[16, 16],
             dec_prenet_sizes=[32, 16], post_proj_sizes=[32, 80],
             enc_bank_size=4, post_bank_size=4, num_freq=257)
    cfg["audio"].update(num_freq=257, frame_length_ms=20.0,
                        frame_shift_ms=5.0)
    cfg["train"]["batch_size"] = 4
    cfg["data"]["batches_per_group"] = 2


def cell(name: str, **traffic) -> core.Cell:
    c = core.find_cell(name)
    shrink(c.config["config"])
    if c.kind == "offline":
        c.traffic.update(texts_per_call=4, check_sample=3, trace_seconds=0.3)
    else:
        c.traffic.update(utterances_per_speaker=10, frames=[120, 240],
                         frames_median=160, trace_seconds=0.3)
    c.traffic.update(traffic)
    return c


def args(seed: int = 2 ** 31 + 17, seconds: float = 0.5, trace: int = 0,
         control: bool = False):
    return types.SimpleNamespace(seed=seed, seconds=seconds, trace=trace,
                                 control=control)


def run(c: core.Cell, a, tmp_path: Path):
    """The cell's driver on the CPU; a training corpus goes under
    ``tmp_path``."""
    drv = core.driver(c.kind)
    if c.kind == "train":
        drv.ROOT = tmp_path
    return drv.run(c, a, CPU)
