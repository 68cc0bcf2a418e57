"""GRU cells and length-aware bidirectional recurrences.

Gate conventions follow the TF1 ``GRUCell`` that the reference trained with
(and that the JAX package keeps), which is not ``torch.nn.GRU``'s:

    [r, u] = sigmoid(W_g [x, h] + b_g)      (b_g initialized to 1)
    c      = tanh(W_c [x, r * h] + b_c)
    h'     = u * h + (1 - u) * c

The input halves of both products do not depend on the carry, so a sequence
computes them for every step at once and the Python time loop only does the
carry halves.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class GRUCell(nn.Module):
    """TF1-convention GRU cell; parameters ``gates`` and ``candidate`` are
    Dense layers over the concatenation ``[x, h]``."""

    def __init__(self, input_size: int, features: int):
        super().__init__()
        self.input_size = input_size
        self.features = features
        self.gates = nn.Linear(input_size + features, 2 * features)
        self.candidate = nn.Linear(input_size + features, features)

    def forward(self, carry: torch.Tensor, inputs: torch.Tensor) -> torch.Tensor:
        """One step: carry [N, H], inputs [N, D] -> new carry [N, H]."""
        gates = torch.sigmoid(self.gates(torch.cat([inputs, carry], -1)))
        r, u = gates.chunk(2, dim=-1)
        c = torch.tanh(self.candidate(torch.cat([inputs, r * carry], -1)))
        return u * carry + (1.0 - u) * c

    def input_projections(self, xs: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Input halves of both products for a whole sequence [N, T, D]."""
        d = self.input_size
        gx = F.linear(xs, self.gates.weight[:, :d], self.gates.bias)
        cx = F.linear(xs, self.candidate.weight[:, :d], self.candidate.bias)
        return gx, cx

    def step_projected(self, carry: torch.Tensor, gx: torch.Tensor,
                       cx: torch.Tensor) -> torch.Tensor:
        """One step from precomputed input projections (``gx``, ``cx`` [N, *])."""
        d = self.input_size
        gates = torch.sigmoid(gx + carry @ self.gates.weight[:, d:].T)
        r, u = gates.chunk(2, dim=-1)
        c = torch.tanh(cx + (r * carry) @ self.candidate.weight[:, d:].T)
        return u * carry + (1.0 - u) * c


def reverse_sequence(xs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Per-example time reversal of the first ``lengths[i]`` steps of
    [N, T, ...]; padding stays in place at the tail (tf.reverse_sequence)."""
    T = xs.shape[1]
    t = torch.arange(T, device=xs.device)[None, :]
    lengths = lengths.to(xs.device)[:, None]
    idx = torch.where(t < lengths, lengths - 1 - t, t)          # [N, T]
    idx = idx.reshape(idx.shape + (1,) * (xs.dim() - 2)).expand_as(xs)
    return torch.gather(xs, 1, idx)


class BiGRU(nn.Module):
    """Bidirectional GRU with optional per-example lengths and initial state.

    With ``lengths``, the carry is held past each sequence's end and the
    output there is zero (``dynamic_rnn(sequence_length=...)``); the backward
    direction runs over the per-example reversed sequence, so one [N, T]
    mask serves both.  Without ``lengths`` (the post-net) the whole sequence
    is flipped.  ``initial_state`` is the concatenated [fw, bw] state.
    """

    def __init__(self, input_size: int, features: int):
        super().__init__()
        self.features = features
        self.fw = GRUCell(input_size, features)
        self.bw = GRUCell(input_size, features)

    def forward(self, xs: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                initial_state: Optional[torch.Tensor] = None) -> torch.Tensor:
        N, T, _ = xs.shape
        if initial_state is not None:
            h_fw, h_bw = initial_state.chunk(2, dim=-1)
        else:
            h_fw = xs.new_zeros((N, self.features))
            h_bw = xs.new_zeros((N, self.features))

        if lengths is None:
            xs_rev = torch.flip(xs, dims=[1])
            mask = None
        else:
            xs_rev = reverse_sequence(xs, lengths)
            t = torch.arange(T, device=xs.device)
            mask = (t[None, :] < lengths.to(xs.device)[:, None]).to(xs.dtype)

        gx_f, cx_f = self.fw.input_projections(xs)
        gx_b, cx_b = self.bw.input_projections(xs_rev)
        ys_fw, ys_bw = [], []
        for i in range(T):
            new_fw = self.fw.step_projected(h_fw, gx_f[:, i], cx_f[:, i])
            new_bw = self.bw.step_projected(h_bw, gx_b[:, i], cx_b[:, i])
            if mask is None:
                h_fw, h_bw = new_fw, new_bw
                ys_fw.append(new_fw)
                ys_bw.append(new_bw)
            else:
                m = mask[:, i, None]
                h_fw = h_fw * (1 - m) + new_fw * m
                h_bw = h_bw * (1 - m) + new_bw * m
                ys_fw.append(new_fw * m)
                ys_bw.append(new_bw * m)
        ys_fw = torch.stack(ys_fw, dim=1)
        ys_bw = torch.stack(ys_bw, dim=1)
        if lengths is None:
            return torch.cat([ys_fw, torch.flip(ys_bw, dims=[1])], dim=-1)
        return torch.cat([ys_fw, reverse_sequence(ys_bw, lengths)], dim=-1)
