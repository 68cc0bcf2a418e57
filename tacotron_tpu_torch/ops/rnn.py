"""GRU and LSTM cells and length-aware bidirectional recurrences.

Gate conventions follow the TF1 ``GRUCell`` that the reference trained with
(and that the JAX package keeps), which is not ``torch.nn.GRU``'s:

    [r, u] = sigmoid(W_g [x, h] + b_g)      (b_g initialized to 1)
    c      = tanh(W_c [x, r * h] + b_c)
    h'     = u * h + (1 - u) * c

The input halves of both products do not depend on the carry, so a sequence
computes them for every step at once and the Python time loop only does the
carry halves.

The carry is kept in the compute dtype (the carry's dtype decides, as in
JAX).  In bfloat16 the split products are taken in float32 from the
bfloat16 operands and their sum is rounded to bfloat16 once a step, as
JAX's one product over ``[x, h]`` is rounded; the bias is added after that
rounding, in bfloat16, as JAX's ``Dense`` adds it; the step's elementwise
math then runs in bfloat16.  In float32 the biases ride in the input
projections.

The LSTM cells (Tacotron 2, ``models/tacotron2.py``) follow
``torch.nn.LSTMCell``, as NVIDIA's Tacotron 2 does: the gates
``W_i x + b_i + W_h h + b_h`` split as (input, forget, cell, output),

    c' = sigmoid(f) * c + sigmoid(i) * tanh(g)
    h' = sigmoid(o) * tanh(c')

in float32 only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .cast import Linear, add_bias, cast


class GRUCell(nn.Module):
    """TF1-convention GRU cell; parameters ``gates`` and ``candidate`` are
    Dense layers over the concatenation ``[x, h]``."""

    def __init__(self, input_size: int, features: int):
        super().__init__()
        self.input_size = input_size
        self.features = features
        self.gates = Linear(input_size + features, 2 * features)
        self.candidate = Linear(input_size + features, features)

    def forward(self, carry: torch.Tensor, inputs: torch.Tensor) -> torch.Tensor:
        """One step: carry [N, H], inputs [N, D] -> new carry [N, H]."""
        gates = torch.sigmoid(self.gates(torch.cat([inputs, carry], -1)))
        r, u = gates.chunk(2, dim=-1)
        c = torch.tanh(self.candidate(torch.cat([inputs, r * carry], -1)))
        return u * carry + (1.0 - u) * c

    def input_projections(self, xs: torch.Tensor,
                          dtype: Optional[torch.dtype] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Input halves of both products for a whole sequence [N, T, D] in
        float32, from the operands in ``dtype`` (the carry's; default
        ``xs``'s); in float32 with the biases (below it
        :meth:`step_projected` adds them after the rounding)."""
        d = self.input_size
        dtype = dtype or xs.dtype

        def half(layer):
            return F.linear(xs.to(dtype).float(),
                            cast(layer.weight, dtype)[:, :d].float(),
                            layer.bias if dtype == torch.float32 else None)

        return half(self.gates), half(self.candidate)

    def carry_weights(self, dtype: torch.dtype
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Carry halves of both weights, transposed, in float32 from their
        values in ``dtype`` (the carry's): made once a sequence."""
        d = self.input_size
        return (cast(self.gates.weight, dtype)[:, d:].float().T,
                cast(self.candidate.weight, dtype)[:, d:].float().T)

    def step_projected(self, carry: torch.Tensor, gx: torch.Tensor,
                       cx: torch.Tensor,
                       weights: Optional[Tuple[torch.Tensor,
                                               torch.Tensor]] = None
                       ) -> torch.Tensor:
        """One step from the input projections (``gx``, ``cx`` [N, *]) and
        :meth:`carry_weights` (made here when not given)."""
        dtype = carry.dtype
        wg, wc = weights or self.carry_weights(dtype)
        bg = bc = None
        if dtype != torch.float32:
            bg, bc = self.gates.bias, self.candidate.bias
        gates = torch.sigmoid(add_bias((gx + carry.float() @ wg).to(dtype),
                                       bg))
        r, u = gates.chunk(2, dim=-1)
        c = torch.tanh(add_bias((cx + (r * carry).float() @ wc).to(dtype),
                                bc))
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
            mask = (t[None, :] < lengths.to(xs.device)[:, None]).to(h_fw.dtype)

        dtype = h_fw.dtype
        gx_f, cx_f = self.fw.input_projections(xs, dtype)
        gx_b, cx_b = self.bw.input_projections(xs_rev, dtype)
        w_f, w_b = self.fw.carry_weights(dtype), self.bw.carry_weights(dtype)
        ys_fw, ys_bw = [], []
        for i in range(T):
            new_fw = self.fw.step_projected(h_fw, gx_f[:, i], cx_f[:, i], w_f)
            new_bw = self.bw.step_projected(h_bw, gx_b[:, i], cx_b[:, i], w_b)
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


class LSTMCell(nn.Module):
    """``torch.nn.LSTMCell``'s cell; parameters ``input`` [4H, D] and
    ``hidden`` [4H, H], Dense layers with biases (``weight_ih``/``bias_ih``
    and ``weight_hh``/``bias_hh`` there)."""

    def __init__(self, input_size: int, features: int):
        super().__init__()
        self.features = features
        self.input = Linear(input_size, 4 * features)
        self.hidden = Linear(features, 4 * features)

    def forward(self, x: torch.Tensor, state: Tuple[torch.Tensor, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One step: x [N, D], state (h, c) [N, H] -> (h', c')."""
        return torch.lstm_cell(x, state, self.input.weight,
                               self.hidden.weight, self.input.bias,
                               self.hidden.bias)


def lstm_gates(gates: torch.Tensor, c: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h', c') from the summed gate pre-activations [..., 4H]."""
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


class BiLSTM(nn.Module):
    """Both directions of an LSTM over each row's first ``lengths[i]``
    steps, as ``pack_padded_sequence`` runs ``torch.nn.LSTM``: each
    direction starts from zeros, the backward one at the row's last valid
    step, and the outputs past a row's end are 0.  The input products of
    a whole sequence are one product per direction; the two directions'
    carries step together as one batched product a step."""

    def __init__(self, input_size: int, features: int):
        super().__init__()
        self.features = features
        self.fw = LSTMCell(input_size, features)
        self.bw = LSTMCell(input_size, features)

    def forward(self, xs: torch.Tensor, lengths: torch.Tensor
                ) -> torch.Tensor:
        """xs [N, T, D], lengths [N] -> [N, T, 2H] (forward, backward)."""
        N, T, _ = xs.shape
        H = self.features
        lengths = lengths.to(xs.device)
        gx = torch.stack([
            self.fw.input(xs) + self.fw.hidden.bias,
            self.bw.input(reverse_sequence(xs, lengths)) + self.bw.hidden.bias,
        ]).permute(2, 0, 1, 3).contiguous()                  # [T, 2, N, 4H]
        w = torch.stack([self.fw.hidden.weight.T, self.bw.hidden.weight.T])
        h = xs.new_zeros((2, N, H))
        c = xs.new_zeros((2, N, H))
        ys = []
        for t in range(T):
            h, c = lstm_gates(torch.baddbmm(gx[t], h, w), c)
            ys.append(h)
        ys = torch.stack(ys, dim=2)                          # [2, N, T, H]
        mask = (torch.arange(T, device=xs.device)[None, :]
                < lengths[:, None])[..., None].to(xs.dtype)
        return torch.cat([ys[0], reverse_sequence(ys[1], lengths)],
                         dim=-1) * mask
