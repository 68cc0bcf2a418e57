"""Tacotron building blocks: prenet, highway, conv bank, CBHG.

Counterparts of the JAX package's ``models/modules.py``, in PyTorch's
idiom.  Activations keep the JAX layout [N, T, C] at every public function;
the convolutions transpose to [N, C, T] around ``F.conv1d``.

- The K-way conv bank is one wide convolution: each width-k kernel is
  zero-embedded in a width-K kernel at the offset that reproduces its own
  TF SAME alignment, and the K outputs form one [K*C] channel block.
- TF SAME padding puts ``(w-1)//2`` on the left and the rest on the right,
  which for even widths differs from PyTorch's symmetric padding, so every
  convolution and the max pool pad explicitly.
- BatchNorm follows the activation, with TF's eps 1e-3; in training mode
  it normalizes with the batch's statistics and moves the running ones as
  flax does (momentum 0.99, the biased variance).
- Dropout draws its masks from the ``torch.Generator`` the caller passes,
  so a train step's masks are a function of that generator's seed alone.
- In a bfloat16 model (``ModelConfig.compute_dtype``) every layer computes
  in its input's dtype with its parameters cast at use (``ops/cast.py``);
  BatchNorm takes its statistics and normalizes in float32 and returns its
  input's dtype, and dropout draws its uniforms in float32, so one
  generator drops the same units in either dtype.
- Under data parallelism (a ``DataShard`` of ``parallel/collectives.py``
  passed as ``shard``) both act on the global batch, as the JAX step's
  one program does: BatchNorm's statistics are sums over every rank's rows,
  and dropout draws the global batch's mask and keeps this rank's rows, so
  N ranks compute what one process computes on their rows concatenated.
- The CBHG's bidirectional GRU runs each direction's whole recurrence as
  one ``ops/kernels/gru.py::gru_sequence`` (K4 on the card, its plain scan
  on the CPU) where the call needs no gradient and the carry is float32:
  synthesis and evaluation.  Training (the gradient) and a bfloat16 carry
  (``BiGRU``'s per-step rounding) keep ``ops/rnn.py::BiGRU``'s scan.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cast import Linear, cast, conv1d
from ..ops.kernels.gru import bigru_from_params
from ..ops.rnn import BiGRU


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            shard=None) -> torch.Tensor:
    """flax ``nn.Dropout``: zero each element with probability ``rate`` and
    scale the kept ones by ``1 / (1 - rate)``; the uniform draws come from
    ``generator`` (on ``x``'s device).  With a ``shard`` the draws cover
    the global batch (``shard.size`` times ``x``'s rows) and this rank
    keeps its rows of them."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training mode needs a torch.Generator")
    shape = tuple(x.shape)
    if shard is not None:
        shape = (shape[0] * shard.size,) + shape[1:]
    keep = torch.rand(shape, generator=generator, device=x.device,
                      dtype=torch.float32) >= rate
    if shard is not None:
        keep = shard.rows(keep)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class Prenet(nn.Module):
    """Dense-ReLU-Dropout stack; dropout is active only in training mode and
    draws from the ``generator`` passed to :meth:`forward`."""

    def __init__(self, input_size: int, layer_sizes: Sequence[int],
                 dropout_rate: float):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.num_layers = len(layer_sizes)
        sizes = [input_size] + list(layer_sizes)
        for i in range(len(layer_sizes)):
            self.add_module(f"dense_{i + 1}", Linear(sizes[i], sizes[i + 1]))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                shard=None) -> torch.Tensor:
        for i in range(self.num_layers):
            x = F.relu(getattr(self, f"dense_{i + 1}")(x))
            if self.training:
                x = dropout(x, self.dropout_rate, generator, shard)
        return x


class HighwayNet(nn.Module):
    """H*T + x*(1-T); the transform gate's bias is initialized to -1."""

    def __init__(self, dim: int):
        super().__init__()
        self.H = Linear(dim, dim)
        self.T = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.H(x))
        t = torch.sigmoid(self.T(x))
        return h * t + x * (1.0 - t)


def tf_same_pad_offset(kernel_width: int, bank_width: int) -> int:
    """Offset that embeds a width-k SAME conv inside a width-K SAME conv."""
    return (bank_width - 1) // 2 - (kernel_width - 1) // 2


def _conv_same(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """TF SAME stride-1 conv1d in ``x``'s dtype: x [N, T, C_in], weight
    [C_out, C_in, w]."""
    width = weight.shape[-1]
    pad_left = (width - 1) // 2
    xt = F.pad(x.transpose(1, 2), (pad_left, width - 1 - pad_left))
    return conv1d(xt, weight, bias).transpose(1, 2)


class ConvBank(nn.Module):
    """Fused K-way convolution bank producing [N, T, K*channels].
    ``kernel_k`` is [channels, in, k] (PyTorch's conv layout)."""

    def __init__(self, in_features: int, bank_size: int, channels: int):
        super().__init__()
        self.bank_size = bank_size
        for k in range(1, bank_size + 1):
            self.register_parameter(
                f"kernel_{k}",
                nn.Parameter(torch.empty(channels, in_features, k)))
        self.bias = nn.Parameter(torch.zeros(bank_size * channels))

    def fused_kernel(self, dtype: torch.dtype = torch.float32
                     ) -> torch.Tensor:
        K = self.bank_size
        blocks = []
        for k in range(1, K + 1):
            offset = tf_same_pad_offset(k, K)
            blocks.append(F.pad(cast(getattr(self, f"kernel_{k}"), dtype),
                                (offset, K - offset - k)))
        return torch.cat(blocks, dim=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_same(x, self.fused_kernel(x.dtype), self.bias)


class Conv1d(nn.Module):
    """SAME-padded conv1d with TF's padding split; weight [out, in, width]."""

    def __init__(self, in_features: int, features: int, width: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features, width))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_same(x, self.weight, self.bias)


class BatchNorm(nn.Module):
    """BatchNorm over the last axis with TF's eps 1e-3, in flax's order:
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias``.

    Training mode follows flax's ``nn.BatchNorm`` (its ``_compute_stats``):
    the statistics run over every axis but the last, padded positions
    included; ``var = max(0, E[x^2] - E[x]^2)`` (the biased variance); and
    the running statistics move as ``0.99 * running + 0.01 * batch``.
    As flax's (``force_float32_reductions``), the statistics are taken in
    float32 from a bfloat16 input, the normalization runs in float32 with
    the float32 parameters and statistics, and the output is cast to the
    input's dtype, in both modes.
    ``F.batch_norm`` would put the unbiased variance into ``running_var``
    and compute the variance another way, so this is written out.

    With a ``shard`` (training mode) the per-channel mean and mean of
    squares are summed over the data group through a differentiable
    all-reduce and divided by its size: flax's statistics over the global
    batch, and the same running statistics on every rank.  ``SyncBatchNorm``
    would compute another variance and keep the unbiased one."""

    EPS = 1e-3
    MOMENTUM = 0.99

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        # one float32 copy of x feeds the statistics and the normalization,
        # so their gradients, which nearly cancel, add up in float32
        xf = x.float()
        if not self.training:
            mul = torch.rsqrt(self.running_var + self.EPS) * self.weight
            return ((xf - self.running_mean) * mul + self.bias).to(x.dtype)
        axes = tuple(range(x.dim() - 1))
        mean = xf.mean(dim=axes)
        mean_sq = (xf * xf).mean(dim=axes)
        if shard is not None:
            # every rank's batch has one shape, so the mean of the ranks'
            # means is the global batch's (and one rank's is its own)
            moments = shard.sum(torch.stack([mean, mean_sq])) / shard.size
            mean, mean_sq = moments[0], moments[1]
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.MOMENTUM
            self.running_mean.copy_(m * self.running_mean
                                    + (1.0 - m) * mean.detach())
            self.running_var.copy_(m * self.running_var
                                   + (1.0 - m) * var.detach())
        mul = torch.rsqrt(var + self.EPS) * self.weight
        return ((xf - mean) * mul + self.bias).to(x.dtype)


def max_pool_same(x: torch.Tensor, width: int) -> torch.Tensor:
    """Width-``width`` stride-1 SAME max pool over time of [N, T, C]: pads
    ``(width-1)//2`` on the left and the rest on the right with -inf."""
    pad_left = (width - 1) // 2
    xt = F.pad(x.transpose(1, 2), (pad_left, width - 1 - pad_left),
               value=float("-inf"))
    return F.max_pool1d(xt, width, stride=1).transpose(1, 2)


class CBHG(nn.Module):
    """Conv-Bank + Highway + GRU block.  ``before_highway`` and
    ``rnn_init_state`` are the Deep Voice 2 speaker injection sites."""

    def __init__(self, in_features: int, bank_size: int,
                 bank_channel_size: int, maxpool_width: int,
                 highway_depth: int, rnn_size: int,
                 proj_sizes: Sequence[int], proj_width: int):
        super().__init__()
        if proj_sizes[-1] != in_features:
            raise ValueError(
                f"the last projection ({proj_sizes[-1]}) must equal the "
                f"input width ({in_features}) for the residual add")
        self.maxpool_width = maxpool_width
        self.num_proj = len(proj_sizes)
        self.highway_depth = highway_depth
        self.conv_bank = ConvBank(in_features, bank_size, bank_channel_size)
        self.bank_bn = BatchNorm(bank_size * bank_channel_size)
        prev = bank_size * bank_channel_size
        for idx, size in enumerate(proj_sizes):
            self.add_module(f"proj_{idx + 1}", Conv1d(prev, size, proj_width))
            self.add_module(f"proj_{idx + 1}_bn", BatchNorm(size))
            prev = size
        if in_features != rnn_size:
            self.highway_dim_fix = Linear(in_features, rnn_size)
        else:
            self.highway_dim_fix = None
        for idx in range(highway_depth):
            self.add_module(f"highway_{idx + 1}", HighwayNet(rnn_size))
        self.bigru = BiGRU(rnn_size, rnn_size)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor],
                before_highway: Optional[torch.Tensor] = None,
                rnn_init_state: Optional[torch.Tensor] = None,
                shard=None) -> torch.Tensor:
        conv = self.bank_bn(F.relu(self.conv_bank(x)), shard)
        proj = max_pool_same(conv, self.maxpool_width)
        for idx in range(self.num_proj):
            proj = getattr(self, f"proj_{idx + 1}")(proj)
            if idx != self.num_proj - 1:
                proj = F.relu(proj)
            proj = getattr(self, f"proj_{idx + 1}_bn")(proj, shard)

        highway_input = proj + x
        if before_highway is not None:
            highway_input = highway_input + before_highway[:, None, :]
        if self.highway_dim_fix is not None:
            highway_input = self.highway_dim_fix(highway_input)
        for idx in range(self.highway_depth):
            highway_input = getattr(self, f"highway_{idx + 1}")(highway_input)
        carry = highway_input if rnn_init_state is None else rnn_init_state
        if not torch.is_grad_enabled() and carry.dtype == torch.float32:
            return bigru_from_params(self.bigru, highway_input.float(),
                                     lengths, rnn_init_state)
        return self.bigru(highway_input, lengths, rnn_init_state)


class Embed(nn.Module):
    """Lookup table with the flax parameter name ``embedding``; ``init_std``
    is the stddev of its truncated-normal initializer."""

    def __init__(self, num_embeddings: int, features: int, init_std: float):
        super().__init__()
        self.init_std = init_std
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.embedding)
