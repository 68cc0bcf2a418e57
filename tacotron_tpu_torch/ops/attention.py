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

Tacotron 2's location-sensitive attention (:class:`LocationSensitiveAttention`,
Chorowski et al. 2015 as NVIDIA's Tacotron 2 has it) is the one mechanism
whose state is more than the previous alignment: it also carries the
cumulative alignment, and it masks padded memory positions.

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
import torch.nn.functional as F
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


class _ConvKernel(nn.Module):
    """A bias-free convolution's ``weight`` [out, in, width]."""

    def __init__(self, out_channels: int, in_channels: int, width: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               width))


class LocationSensitiveAttention(nn.Module):
    """``v . tanh(W q + U f + keys)`` over the memory positions, padding
    masked, then a softmax, where ``f`` are ``filters`` location features:
    a width-``width`` convolution (zero-padded to the same length, no
    bias) over the previous and the cumulative alignment.  Parameters as
    NVIDIA's ``Attention``: ``query_layer`` [A, Q], ``location_conv``
    [filters, 2, width], ``location_dense`` [A, filters] and ``v`` [1, A],
    all without biases; the memory's ``memory_layer`` keys are made once a
    decode, outside this module's step."""

    def __init__(self, query_size: int, num_units: int, filters: int,
                 width: int):
        super().__init__()
        if width % 2 != 1:
            raise ValueError(f"the location convolution's width must be "
                             f"odd, got {width}")
        self.query_layer = Linear(query_size, num_units, bias=False)
        self.location_conv = _ConvKernel(filters, 2, width)
        self.location_dense = Linear(filters, num_units, bias=False)
        self.v = Linear(num_units, 1, bias=False)

    def forward(self, query: torch.Tensor, keys: torch.Tensor,
                previous: torch.Tensor, cumulative: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
        """query [N, Q], keys [N, T, A], previous and cumulative [N, T],
        valid [N, T] (bool) -> alignments [N, T]."""
        weight = self.location_conv.weight
        features = F.conv1d(torch.stack([previous, cumulative], dim=1),
                            weight, padding=weight.shape[-1] // 2)
        processed = (self.query_layer(query)[:, None, :]
                     + self.location_dense(features.transpose(1, 2)) + keys)
        energies = self.v(torch.tanh(processed))[..., 0]
        return torch.softmax(
            energies.masked_fill(~valid, float("-inf")), dim=-1)


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
