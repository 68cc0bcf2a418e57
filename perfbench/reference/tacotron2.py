"""Plain PyTorch reference of Tacotron 2 for inference (Shen et al. 2018,
arXiv:1712.05884 section 2, at NVIDIA/tacotron2's ``model.py`` and
``hparams.py``), written from the paper and that implementation.

It reads the variables by their paths (``families/tacotron2.py``), runs
batched and in float32 with TF32 off, and spells every product out as one
matrix product (``mm``), the convolutions as unfold + ``mm``, so that
``precision="tf32"`` rounds the operands of every product to TF32 for the
benchmark's control.  Nothing here comes from the program under test.

Greedy inference (``infer``), r frames a step from a zero frame, the last
one fed back: the encoder's convolutions (BatchNorm on the running
statistics, eps 1e-5; inputs zeroed past each text's end) and a BiLSTM
over each text's valid tokens; per step the prenet with its inference
dropout (the keep rule below), the attention LSTM over [prenet, context],
location-sensitive attention over the previous and the cumulative
alignment (padding masked, softmax), the decoder LSTM over [attention
state, context], the frames and the stop logit from [decoder state,
context]; the residual post-net (tanh on all but the last convolution);
then the mel frames to the normalized linear spectrogram the vocoder reads,
through the pseudo-inverse of the Slaney mel filterbank.  LSTM gates are
``torch.nn.LSTMCell``'s: (input, forget, cell, output).

The prenet's keep masks, over unsigned 32-bit integers (held in int64,
each product of a 32-bit value taken in 16-bit halves): ``fmix`` is the
lowbias32 finalizer (``x ^= x >> 16; x *= 0x7feb352d; x ^= x >> 15; x *=
0x846ca68b; x ^= x >> 16``), ``mix(a, b) = fmix(a ^ fmix(b ^
0x9e3779b9))``; a text's key is ``k = mix(sum_i mix(id_i, i), n)`` over its
n unpadded ids, and unit u of layer l at step t is kept when
``mix(mix(mix(k, t), l), u) >= floor(rate * 2**32)``, scaled by ``1 /
(1 - rate)``, at the rate 0.5 that NVIDIA's ``Prenet.forward`` hard-codes.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from .tacotron import _TF32MatMul

BN_EPS = 1e-5
PRENET_DROPOUT = 0.5
M32 = 0xFFFFFFFF


def _times(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` from ``x``'s 16-bit halves."""
    low, high = x & 0xFFFF, x >> 16
    return (low * c + (((high * c) & 0xFFFF) << 16)) & M32


def _fmix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _times(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _times(x, 0x846CA68B)
    return x ^ (x >> 16)


def _mix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _fmix(a ^ _fmix(b ^ 0x9E3779B9))


def keep_masks(ids, steps: int, sizes):
    """One text's scaled keep masks, per prenet layer [steps, units]
    (float32), from its unpadded ``ids``."""
    rate = PRENET_DROPOUT
    n = len(ids)
    i64 = dict(dtype=torch.int64)
    terms = _mix(torch.tensor(ids, **i64), torch.arange(n, **i64))
    k = _mix(terms.sum() & M32, torch.tensor(n, **i64))
    per_step = _mix(k, torch.arange(steps, **i64))
    out = []
    for layer, units in enumerate(sizes):
        per_layer = _mix(per_step, torch.tensor(layer, **i64))
        z = _mix(per_layer[:, None], torch.arange(units, **i64))
        keep = z >= math.floor(rate * 2 ** 32)
        out.append(keep.to(torch.float32) / (1.0 - rate))
    return out


def _hz_to_mel(f: torch.Tensor) -> torch.Tensor:
    log = 15.0 + torch.log(torch.clamp(f, min=1000.0) / 1000.0) / (
        math.log(6.4) / 27.0)
    return torch.where(f >= 1000.0, log, f / (200.0 / 3))


def _mel_to_hz(m: torch.Tensor) -> torch.Tensor:
    log = 1000.0 * torch.exp(math.log(6.4) / 27.0
                             * (torch.clamp(m, min=15.0) - 15.0))
    return torch.where(m >= 15.0, log, m * (200.0 / 3))


def mel_basis(sample_rate: int, n_fft: int, n_mels: int) -> torch.Tensor:
    """librosa's default filterbank (Slaney scale and area), [n_mels,
    n_fft / 2 + 1], computed in float64 and returned in float32."""
    f64 = dict(dtype=torch.float64)
    freqs = torch.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1, **f64)
    top = _hz_to_mel(torch.tensor(sample_rate / 2.0, **f64))
    edges = _mel_to_hz(torch.linspace(0.0, float(top), n_mels + 2, **f64))
    widths = edges[1:] - edges[:-1]
    lower = (freqs[None, :] - edges[:-2, None]) / widths[:-1, None]
    upper = (edges[2:, None] - freqs[None, :]) / widths[1:, None]
    weights = torch.clamp(torch.minimum(lower, upper), min=0.0)
    weights = weights * (2.0 / (edges[2:] - edges[:-2]))[:, None]
    return weights.to(torch.float32)


class Reference:
    """The graph over ``variables`` (flat paths -> tensors) for the model
    section ``m`` and the audio section ``audio`` (the mel -> linear
    stage)."""

    def __init__(self, variables: Dict[str, torch.Tensor], m: dict,
                 audio: dict, precision: str = "float32"):
        if precision not in ("float32", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.v = variables
        self.m = m
        self.audio = audio
        self.precision = precision
        n_fft = (m["num_freq"] - 1) * 2
        basis = mel_basis(audio["sample_rate"], n_fft, m["num_mels"])
        device = next(iter(variables.values())).device
        self.inv_basis = torch.linalg.pinv(basis.double()).to(
            torch.float32).T.contiguous().to(device)        # [n_mels, F]

    # ------------------------------------------------------------ primitives

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "tf32":
            return _TF32MatMul.apply(a, b)
        return a @ b

    def p(self, path: str) -> torch.Tensor:
        return self.v["params/" + path]

    def dense(self, path: str, x: torch.Tensor) -> torch.Tensor:
        y = self.mm(x, self.p(path + "/kernel"))
        bias = self.v.get(f"params/{path}/bias")
        return y if bias is None else y + bias

    def conv(self, x: torch.Tensor, path: str) -> torch.Tensor:
        """Same-length convolution of [N, T, C] by the [w, C, C_out]
        kernel at ``path`` (odd w, (w - 1) / 2 zeros each side)."""
        kernel = self.p(path + "/kernel")
        w, cin, cout = kernel.shape
        xp = F.pad(x, (0, 0, w // 2, w // 2))
        cols = xp.unfold(1, w, 1).transpose(2, 3)          # [N, T, w, C]
        N, T = cols.shape[:2]
        y = self.mm(cols.reshape(N, T, w * cin), kernel.reshape(w * cin,
                                                                 cout))
        bias = self.v.get(f"params/{path}/bias")
        return y if bias is None else y + bias

    def batchnorm(self, path: str, x: torch.Tensor) -> torch.Tensor:
        scale = self.p(path + "/BatchNorm_0/scale")
        bias = self.p(path + "/BatchNorm_0/bias")
        key = "batch_stats/" + path + "/BatchNorm_0/"
        return ((x - self.v[key + "mean"])
                * (torch.rsqrt(self.v[key + "var"] + BN_EPS) * scale) + bias)

    def lstm(self, path: str, x: torch.Tensor, h: torch.Tensor,
             c: torch.Tensor):
        gates = self.dense(path + "/input", x) + self.dense(path + "/hidden",
                                                            h)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c

    # --------------------------------------------------------------- graph

    def encoder(self, inputs, lengths) -> torch.Tensor:
        m = self.m
        N, T = inputs.shape
        live = torch.arange(T, device=inputs.device)[None, :] \
            < lengths[:, None]                                   # [N, T]
        x = self.p("char_embedding/embedding")[inputs]
        for i in range(1, m["t2_enc_conv_num"] + 1):
            x = torch.where(live[..., None], x, torch.zeros_like(x))
            x = F.relu(self.batchnorm(f"encoder/convs/conv_{i}_bn",
                                      self.conv(x, f"encoder/convs/conv_{i}")))
        H = m["t2_enc_lstm_size"]
        out = x.new_zeros((N, T, 2 * H))
        for d, order in (("fw", range(T)), ("bw", range(T - 1, -1, -1))):
            h = x.new_zeros((N, H))
            c = x.new_zeros((N, H))
            for t in order:
                nh, nc = self.lstm(f"encoder/lstm/{d}", x[:, t], h, c)
                on = live[:, t, None]
                h = torch.where(on, nh, h)
                c = torch.where(on, nc, c)
                half = slice(0, H) if d == "fw" else slice(H, 2 * H)
                out[:, t, half] = torch.where(on, nh, torch.zeros_like(nh))
        return out

    def attention(self, query, memory_keys, prev, cum, live):
        features = self.conv(torch.stack([prev, cum], dim=-1),
                             "decoder/attention/location_conv")   # [N, T, f]
        hidden = torch.tanh(
            self.mm(query, self.p("decoder/attention/query_layer/kernel"))
            [:, None, :]
            + self.mm(features,
                      self.p("decoder/attention/location_dense/kernel"))
            + memory_keys)
        energies = self.mm(hidden,
                           self.p("decoder/attention/v/kernel"))[..., 0]
        return torch.softmax(energies.masked_fill(~live, float("-inf")),
                             dim=-1)

    @torch.no_grad()
    def infer(self, inputs, input_lengths, speaker_id,
              num_steps: int) -> Dict[str, torch.Tensor]:
        """Greedy decode of ``num_steps`` steps; ``alignments`` [N, T_in,
        steps], ``mel_outputs`` and ``linear_outputs`` [N, T, M / F],
        ``stop_logits`` [N, steps] and ``spec_moments`` [N, 2] (float64:
        the linear spectrogram's sum and sum of squares)."""
        if speaker_id is not None:
            raise ValueError("the Tacotron 2 reference is single-speaker")
        m, audio = self.m, self.audio
        M, r = m["num_mels"], m["reduction_factor"]
        N, T_in = inputs.shape
        dev = inputs.device
        lengths = input_lengths.to(dev)
        live = torch.arange(T_in, device=dev)[None, :] < lengths[:, None]
        memory = self.encoder(inputs, lengths)
        keys = self.mm(memory, self.p("decoder/memory_layer/kernel"))
        sizes = m["dec_prenet_sizes"]
        rows = [keep_masks(inputs[i, :int(lengths[i])].tolist(), num_steps,
                           sizes) for i in range(N)]
        masks = [torch.stack([row[l] for row in rows], 1).to(dev)
                 for l in range(len(sizes))]
        A, D = m["t2_attention_lstm_size"], m["t2_decoder_lstm_size"]
        att_h, att_c = memory.new_zeros((N, A)), memory.new_zeros((N, A))
        dec_h, dec_c = memory.new_zeros((N, D)), memory.new_zeros((N, D))
        align = memory.new_zeros((N, T_in))
        cum = memory.new_zeros((N, T_in))
        context = memory.new_zeros((N, memory.shape[-1]))
        frame = memory.new_zeros((N, M))
        frames, gates, aligns = [], [], []
        for t in range(num_steps):
            x = frame
            for l in range(len(sizes)):
                x = F.relu(self.dense(f"decoder/prenet/dense_{l + 1}", x)) \
                    * masks[l][t]
            att_h, att_c = self.lstm("decoder/attention_rnn",
                                     torch.cat([x, context], -1), att_h,
                                     att_c)
            align = self.attention(att_h, keys, align, cum, live)
            cum = cum + align
            context = self.mm(align[:, None, :], memory)[:, 0]
            dec_h, dec_c = self.lstm("decoder/decoder_rnn",
                                     torch.cat([att_h, context], -1), dec_h,
                                     dec_c)
            out = torch.cat([dec_h, context], -1)
            frames.append(self.dense("decoder/frame_projection", out))
            gates.append(self.dense("decoder/gate_layer", out)[:, 0])
            aligns.append(align)
            frame = frames[-1][:, -M:]
        mel = torch.stack(frames, 1).reshape(N, num_steps * r, M)
        post = mel
        n_post = m["t2_postnet_conv_num"]
        for i in range(1, n_post + 1):
            post = self.batchnorm(f"postnet/conv_{i}_bn",
                                  self.conv(post, f"postnet/conv_{i}"))
            if i < n_post:
                post = torch.tanh(post)
        mel = mel + post
        # mel -> linear: dB -> amplitude, the pseudo-inverse, dB less the
        # reference level, normalized
        lo = audio["min_level_db"]
        amp = torch.pow(10.0, (torch.clamp(mel, 0.0, 1.0) * -lo + lo) * 0.05)
        mag = torch.clamp(self.mm(amp, self.inv_basis), min=1e-10)
        db = 20.0 * torch.log10(torch.clamp(mag, min=1e-5)) \
            - audio["ref_level_db"]
        linear = torch.clamp((db - lo) / -lo, 0.0, 1.0)
        lin64 = linear.double()
        return {"alignments": torch.stack(aligns, 2),
                "mel_outputs": mel,
                "linear_outputs": linear,
                "stop_logits": torch.stack(gates, 1),
                "spec_moments": torch.stack(
                    [lin64.sum(dim=(1, 2)), (lin64 * lin64).sum(dim=(1, 2))],
                    dim=1)}
