"""Attention mechanisms for the decoder (the five ``attention_type`` options
of the reference, ``models/tacotron.py:132-152``).

- ``bah_mon``: Bahdanau monotonic attention, parallel mode with no sigmoid
  noise (Raffel et al. 2017), the default;
- ``bah`` / ``bah_norm``: softmax Bahdanau attention, optionally with the
  weight-normalized score;
- ``luong`` / ``luong_scaled``: multiplicative attention.

Each module scores one decode step.  The one-time key projection of the
encoder memory lives in the model, outside the decode loop.  No mechanism
masks padded memory positions, as in the reference.

Each mechanism computes in its query's dtype with its parameters cast at
use, as the JAX modules do, down to the monotonic recurrence's log-space
cumulative product in bfloat16; its cumulative sums add in float32 and
round each output once, on the CPU and the card alike.  The normalized
Bahdanau score keeps JAX's promotion: its weight vector is float32, so
the score and the alignments are float32 whatever the query's dtype.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .cast import Linear, cast


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum along the last axis, added in float32."""
    return torch.cumsum(x, dim=-1, dtype=torch.float32).to(x.dtype)


def safe_exclusive_cumprod(x: torch.Tensor) -> torch.Tensor:
    """Exclusive cumprod along the last axis, taken in log space."""
    logs = torch.log(torch.clamp(x, 1e-10, 1.0))
    cums = _cumsum(logs)
    exclusive = torch.cat([torch.zeros_like(cums[..., :1]), cums[..., :-1]],
                          dim=-1)
    return torch.exp(exclusive)


def monotonic_alignments(p_choose: torch.Tensor,
                         previous: torch.Tensor) -> torch.Tensor:
    """alpha_i = p_i prod_{j<i}(1-p_j) sum_{k<=i} prev_k / prod_{j<k}(1-p_j)"""
    cumprod_1mp = safe_exclusive_cumprod(1.0 - p_choose)
    return p_choose * cumprod_1mp * _cumsum(
        previous / torch.clamp(cumprod_1mp, 1e-10, 1.0))


class BahdanauMonotonicAttention(nn.Module):
    def __init__(self, query_size: int, num_units: int):
        super().__init__()
        self.query_layer = Linear(query_size, num_units, bias=False)
        self.attention_v = nn.Parameter(torch.empty(num_units, 1))
        self.score_bias = nn.Parameter(torch.zeros(()))

    def forward(self, query, keys, previous_alignments):
        """query [N, H], keys [N, T, U], previous [N, T] -> [N, T]."""
        dtype = query.dtype
        processed = self.query_layer(query)
        score = (torch.tanh(keys + processed[:, None, :])
                 @ cast(self.attention_v, dtype)).squeeze(-1)
        p_choose = torch.sigmoid(score + cast(self.score_bias, dtype))
        return monotonic_alignments(p_choose, previous_alignments)


class BahdanauAttention(nn.Module):
    def __init__(self, query_size: int, num_units: int,
                 normalize: bool = False):
        super().__init__()
        self.normalize = normalize
        self.query_layer = Linear(query_size, num_units, bias=False)
        self.attention_v = nn.Parameter(torch.empty(num_units, 1))
        if normalize:
            self.attention_g = nn.Parameter(
                torch.tensor(math.sqrt(1.0 / num_units)))
            self.attention_b = nn.Parameter(torch.zeros(num_units))

    def forward(self, query, keys, previous_alignments):
        dtype = query.dtype
        processed = self.query_layer(query)
        if self.normalize:
            v = self.attention_v[:, 0]
            vn = (cast(self.attention_g, dtype) * v
                  / torch.linalg.vector_norm(v).to(dtype))
            hidden = torch.tanh(keys + processed[:, None, :]
                                + cast(self.attention_b, dtype))
            score = torch.einsum("ntu,u->nt", hidden.to(vn.dtype), vn)
        else:
            score = (torch.tanh(keys + processed[:, None, :])
                     @ cast(self.attention_v, dtype)).squeeze(-1)
        return torch.softmax(score, dim=-1)


class LuongAttention(nn.Module):
    def __init__(self, scale: bool = False):
        super().__init__()
        self.scale = scale
        if scale:
            self.attention_g = nn.Parameter(torch.ones(()))

    def forward(self, query, keys, previous_alignments):
        score = torch.einsum("nu,ntu->nt", query, keys)
        if self.scale:
            score = cast(self.attention_g, query.dtype) * score
        return torch.softmax(score, dim=-1)


def initial_alignments(attention_type: str, batch: int, length: int,
                       device=None, dtype=torch.float32) -> torch.Tensor:
    """A Dirac at encoder position 0 for monotonic attention, zeros for the
    memoryless softmax mechanisms."""
    out = torch.zeros((batch, length), device=device, dtype=dtype)
    if attention_type == "bah_mon":
        out[:, 0] = 1.0
    return out


def make_attention(attention_type: str, query_size: int,
                   num_units: int) -> nn.Module:
    if attention_type == "bah_mon":
        return BahdanauMonotonicAttention(query_size, num_units)
    if attention_type == "bah":
        return BahdanauAttention(query_size, num_units, False)
    if attention_type == "bah_norm":
        return BahdanauAttention(query_size, num_units, True)
    if attention_type == "luong":
        return LuongAttention(False)
    if attention_type == "luong_scaled":
        return LuongAttention(True)
    raise ValueError(f"Unknown attention type: {attention_type}")
