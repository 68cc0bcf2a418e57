"""Tacotron 2 (Shen et al. 2018, "Natural TTS Synthesis by Conditioning
WaveNet on Mel Spectrogram Predictions", arXiv:1712.05884, section 2) in
PyTorch, for inference, at the widths of NVIDIA/tacotron2's ``hparams.py``
(``ModelConfig`` with ``architecture="tacotron2"``):

- a symbol embedding (``embedding_size``, 512);
- the encoder: ``t2_enc_conv_num`` convolutions (512 channels, width 5),
  each with BatchNorm and ReLU, then a BiLSTM (256 a direction) over each
  text's valid tokens;
- the decoder, one step a frame at r = 1: the prenet (``dec_prenet_sizes``,
  2 x 256, ReLU, bias-free), whose dropout stays on at inference; an
  attention LSTM (1024) over [prenet, context]; location-sensitive
  attention (``attention_size`` 128; 32 filters of width 31 over the
  previous and the cumulative alignment; padding masked); a decoder LSTM
  (1024) over [attention state, context]; the frame projection and the
  stop gate's logit from [decoder state, context];
- the post-net: 5 convolutions (512 channels, width 5) with BatchNorm, tanh
  on all but the last, added to the decoder's frames.

The decoder starts from a zero frame, zero states, context and
alignments, and feeds back the last frame it made.  BatchNorm uses its
running statistics (eps 1e-5, ``torch.nn.BatchNorm1d``'s, as NVIDIA's).
The model then turns its mel frames into the normalized linear spectrogram
that the vocoder reads (``dsp.chip.mel_to_linear``: the pseudo-inverse of
the mel filterbank), for Griffin-Lim in WaveNet's place.

Padded tokens: every convolution's input is zeroed past each text's end
(NVIDIA's convolutions see the pad symbol's embedding there), the BiLSTM
runs over the valid tokens only and attention masks the rest, so a text's
outputs do not depend on its bucket or its row.

Prenet dropout at inference, reproducible without random state.  Unit
``u`` of prenet layer ``l`` (from 0) at decoder step ``t`` is kept when
``z >= floor(rate * 2**32)`` and a kept unit is scaled by
``1 / (1 - rate)``, with ``rate`` = :data:`PRENET_DROPOUT`, where, over
unsigned 32-bit integers,

    fmix(x)   = x ^= x >> 16; x *= 0x7feb352d; x ^= x >> 15;
                x *= 0x846ca68b; x ^= x >> 16          (each product mod 2**32)
    mix(a, b) = fmix(a ^ fmix(b ^ 0x9e3779b9))
    k         = mix(sum_i mix(id_i, i) mod 2**32, n)    the text's n ids
    z         = mix(mix(mix(k, t), l), u)

over the text's unpadded ids ``id_0 .. id_{n-1}`` (EOS included).  So the
same text gets the same masks, and the same audio, in any row, chunk or
call.  :func:`prenet_keep_masks` computes every step's masks at once, on
the device, at the start of a decode.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..config import AudioConfig, ModelConfig
from ..dsp import chip as dsp_chip
from ..ops.attention import LocationSensitiveAttention
from ..ops.cast import Linear
from ..ops.rnn import BiLSTM, LSTMCell
from ..text.symbols import VOCAB_SIZE
from .modules import BatchNorm, Conv1d, Embed

_M32 = 0xFFFFFFFF

#: the prenet's dropout rate, on at inference (NVIDIA/tacotron2 hard-codes
#: p=0.5 in ``Prenet.forward``; it is no ``hparams.py`` setting)
PRENET_DROPOUT = 0.5


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32): the product of
    the low 31 bits of ``c`` fits int64, and ``x * 2**31 mod 2**32`` is
    ``x``'s lowest bit at bit 31."""
    low = (x * (c & 0x7FFFFFFF)) & _M32
    if c >> 31:
        low = (low + ((x & 1) << 31)) & _M32
    return low


def fmix(x: torch.Tensor) -> torch.Tensor:
    """The 32-bit finalizer of the module docstring, on int64 tensors that
    hold unsigned 32-bit values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def mix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fmix(a ^ fmix(b ^ 0x9E3779B9))


def text_keys(inputs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The key ``k`` [N] of each row's first ``lengths`` ids [N, T]."""
    positions = torch.arange(inputs.shape[1], device=inputs.device)
    lengths = lengths.to(inputs.device)
    terms = mix(inputs.long(), positions[None, :])
    terms = torch.where(positions[None, :] < lengths[:, None], terms,
                        torch.zeros_like(terms))
    return mix(terms.sum(dim=1) & _M32, lengths.long())


def prenet_keep_masks(inputs: torch.Tensor, lengths: torch.Tensor,
                      steps: int, sizes: Sequence[int]) -> List[torch.Tensor]:
    """Per prenet layer, the scaled keep mask [steps, N, units] of every
    decoder step (float32: 0 or ``1 / (1 - rate)``), by the rule of the
    module docstring."""
    dev = inputs.device
    rate = PRENET_DROPOUT
    k = text_keys(inputs, lengths)                                    # [N]
    t = torch.arange(steps, device=dev, dtype=torch.int64)
    per_step = mix(k[None, :], t[:, None])                      # [steps, N]
    threshold = math.floor(rate * 2 ** 32)
    scale = 1.0 / (1.0 - rate)
    masks = []
    for layer, units in enumerate(sizes):
        per_layer = mix(per_step, torch.full_like(per_step, layer))
        u = torch.arange(units, device=dev, dtype=torch.int64)
        z = mix(per_layer[..., None], u)                  # [steps, N, units]
        masks.append((z >= threshold).to(torch.float32) * scale)
    return masks


class BatchNorm1d(BatchNorm):
    """The port's BatchNorm at ``torch.nn.BatchNorm1d``'s eps."""

    EPS = 1e-5


class ConvStack(nn.Module):
    """``conv_i`` and ``conv_i_bn`` for i = 1..n, each convolution
    zero-padded to the same length; ``activation`` after every BatchNorm,
    or after all but the last (``last_linear``)."""

    def __init__(self, sizes: Sequence[int], width: int, activation,
                 last_linear: bool):
        super().__init__()
        self.activation = activation
        self.last_linear = last_linear
        self.num = len(sizes) - 1
        for i in range(self.num):
            self.add_module(f"conv_{i + 1}",
                            Conv1d(sizes[i], sizes[i + 1], width))
            self.add_module(f"conv_{i + 1}_bn", BatchNorm1d(sizes[i + 1]))

    def forward(self, x: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [N, T, C]; ``valid`` [N, T, 1] zeroes each input past its
        row's end."""
        for i in range(self.num):
            if valid is not None:
                x = x * valid
            x = getattr(self, f"conv_{i + 1}_bn")(
                getattr(self, f"conv_{i + 1}")(x))
            if not (self.last_linear and i == self.num - 1):
                x = self.activation(x)
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        C = cfg.t2_enc_conv_channels
        sizes = [cfg.embedding_size] + [C] * cfg.t2_enc_conv_num
        self.convs = ConvStack(sizes, cfg.t2_enc_conv_width, F.relu, False)
        self.lstm = BiLSTM(C, cfg.t2_enc_lstm_size)

    def forward(self, embedded: torch.Tensor, lengths: torch.Tensor
                ) -> torch.Tensor:
        """[N, T, E] -> memory [N, T, 2 * lstm size], 0 past each end."""
        T = embedded.shape[1]
        valid = (torch.arange(T, device=embedded.device)[None, :]
                 < lengths.to(embedded.device)[:, None])[..., None]
        return self.lstm(self.convs(embedded, valid.to(embedded.dtype)),
                         lengths)


class Prenet(nn.Module):
    """Bias-free Dense-ReLU layers ``dense_i``, each unit scaled by its
    keep mask."""

    def __init__(self, input_size: int, sizes: Sequence[int]):
        super().__init__()
        self.num = len(sizes)
        dims = [input_size] + list(sizes)
        for i in range(self.num):
            self.add_module(f"dense_{i + 1}",
                            Linear(dims[i], dims[i + 1], bias=False))

    def forward(self, x: torch.Tensor, masks: Sequence[torch.Tensor]
                ) -> torch.Tensor:
        for i in range(self.num):
            x = F.relu(getattr(self, f"dense_{i + 1}")(x)) * masks[i]
        return x


class Decoder(nn.Module):
    """One decoder step; the parameters sit under the name ``decoder``."""

    def __init__(self, cfg: ModelConfig, memory_dim: int):
        super().__init__()
        A, D = cfg.t2_attention_lstm_size, cfg.t2_decoder_lstm_size
        self.num_mels = cfg.num_mels
        self.prenet = Prenet(cfg.num_mels, cfg.dec_prenet_sizes)
        self.attention_rnn = LSTMCell(cfg.dec_prenet_sizes[-1] + memory_dim,
                                      A)
        self.attention = LocationSensitiveAttention(
            A, cfg.attention_size, cfg.t2_location_filters,
            cfg.t2_location_width)
        self.memory_layer = Linear(memory_dim, cfg.attention_size,
                                   bias=False)
        self.decoder_rnn = LSTMCell(A + memory_dim, D)
        self.frame_projection = Linear(D + memory_dim,
                                       cfg.num_mels * cfg.reduction_factor)
        self.gate_layer = Linear(D + memory_dim, 1)

    def forward(self, memory: torch.Tensor, keys: torch.Tensor,
                valid: torch.Tensor, masks: Sequence[torch.Tensor],
                steps: int):
        """The greedy loop: (frames [N, steps, M * r], stop logits
        [N, steps], alignments [N, T_in, steps])."""
        N, T_in, C = memory.shape
        zeros = memory.new_zeros
        att = (zeros((N, self.attention_rnn.features)),) * 2
        dec = (zeros((N, self.decoder_rnn.features)),) * 2
        align = cumulative = zeros((N, T_in))
        context = zeros((N, C))
        frame = zeros((N, self.num_mels))
        frames, gates, aligns = [], [], []
        for t in range(steps):
            x = self.prenet(frame, [m[t] for m in masks])
            att = self.attention_rnn(torch.cat([x, context], dim=-1), att)
            align = self.attention(att[0], keys, align, cumulative, valid)
            cumulative = cumulative + align
            context = torch.bmm(align[:, None, :], memory)[:, 0]
            dec = self.decoder_rnn(torch.cat([att[0], context], dim=-1), dec)
            out = torch.cat([dec[0], context], dim=-1)
            frames.append(self.frame_projection(out))
            gates.append(self.gate_layer(out))
            aligns.append(align)
            frame = frames[-1][:, -self.num_mels:]
        return (torch.stack(frames, 1), torch.cat(gates, 1),
                torch.stack(aligns, 2))


class Tacotron2(nn.Module):
    """Encoder, decoder loop, post-net and the mel -> linear stage."""

    def __init__(self, cfg: ModelConfig, audio: AudioConfig,
                 vocab_size: int = VOCAB_SIZE):
        super().__init__()
        if cfg.architecture != "tacotron2":
            raise ValueError(f"Tacotron2 built from a config whose "
                             f"architecture is {cfg.architecture!r}")
        if (audio.num_mels, audio.num_freq) != (cfg.num_mels, cfg.num_freq):
            raise ValueError("the model's num_mels / num_freq must be the "
                             "audio's")
        self.cfg = cfg
        self.audio = audio
        memory_dim = 2 * cfg.t2_enc_lstm_size
        self.char_embedding = Embed(vocab_size, cfg.embedding_size,
                                    math.sqrt(2.0 / (vocab_size
                                                     + cfg.embedding_size)))
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg, memory_dim)
        C = cfg.t2_postnet_channels
        self.postnet = ConvStack(
            [cfg.num_mels] + [C] * (cfg.t2_postnet_conv_num - 1)
            + [cfg.num_mels], cfg.t2_postnet_width, torch.tanh, True)

    @torch.no_grad()
    def forward(self, inputs: torch.Tensor, input_lengths: torch.Tensor,
                speaker_id: Optional[torch.Tensor] = None,
                max_steps: Optional[int] = None,
                manual_alignments: Optional[torch.Tensor] = None,
                is_manual: Optional[torch.Tensor] = None,
                mark: Optional[Callable[[int], None]] = None
                ) -> Dict[str, torch.Tensor]:
        """Greedy decode of ``max_steps`` steps (default ``max_iters``).
        Returns ``mel_outputs`` [N, T, M] (after the post-net),
        ``linear_outputs`` [N, T, F], ``alignments`` [N, T_in, steps] and
        ``stop_logits`` [N, steps] (T = steps * r).  ``mark(1)`` is called
        after the encoder and ``mark(2)`` after the decoder loop (the
        chunk's device stamps).  ``speaker_id`` and ``is_manual`` are the
        synthesizer's arguments, unused here; manual alignments are
        Tacotron's and raise."""
        cfg = self.cfg
        if self.training:
            raise RuntimeError("Tacotron2 runs inference only (eval mode)")
        if manual_alignments is not None:
            raise ValueError("manual alignments are Tacotron's; Tacotron 2 "
                             "decodes with its own attention only")
        steps = max_steps if max_steps is not None else cfg.max_iters
        N, T_in = inputs.shape
        lengths = input_lengths.to(inputs.device)
        memory = self.encoder(self.char_embedding(inputs), lengths)
        if mark is not None:
            mark(1)
        valid = (torch.arange(T_in, device=inputs.device)[None, :]
                 < lengths[:, None])
        masks = prenet_keep_masks(inputs, lengths, steps, cfg.dec_prenet_sizes)
        frames, stop_logits, alignments = self.decoder(
            memory, self.decoder.memory_layer(memory), valid, masks, steps)
        if mark is not None:
            mark(2)
        mel = frames.reshape(N, steps * cfg.reduction_factor, cfg.num_mels)
        mel = mel + self.postnet(mel)
        return {"mel_outputs": mel,
                "linear_outputs": dsp_chip.mel_to_linear(mel, self.audio),
                "alignments": alignments,
                "stop_logits": stop_logits}


#: the layers NVIDIA's ``LinearNorm`` initializes with tanh's gain
TANH_LAYERS = ("decoder.memory_layer", "decoder.attention.query_layer",
               "decoder.attention.location_dense")


def xavier_gain(name: str, cfg: ModelConfig) -> float:
    """The xavier-uniform gain (``torch.nn.init.calculate_gain``) NVIDIA's
    ``LinearNorm`` / ``ConvNorm`` give the layer ``name``: ReLU's for the
    encoder's convolutions, tanh's for the attention's query, memory and
    location layers and for the post-net's convolutions but the last, 1
    for the rest (sigmoid's, the gate's, is 1 too)."""
    if name.startswith("encoder.convs.conv_"):
        return math.sqrt(2.0)
    if name.startswith("postnet.conv_"):
        last = f"postnet.conv_{cfg.t2_postnet_conv_num}"
        return 1.0 if name == last else 5.0 / 3.0
    return 5.0 / 3.0 if name in TANH_LAYERS else 1.0


@torch.no_grad()
def init_random_(model: Tacotron2, seed: int = 0) -> Tacotron2:
    """NVIDIA/tacotron2's initialization, drawn on the CPU from ``seed`` in
    module order: xavier-uniform for the Dense layers and convolutions
    (the gain of :func:`xavier_gain`), their biases PyTorch's default
    (uniform within 1 / sqrt(fan_in)); the LSTMs PyTorch's default
    (uniform within 1 / sqrt(units), biases too); the embedding uniform
    within sqrt(3) * sqrt(2 / (symbols + width)); BatchNorm identity."""
    gen = torch.Generator().manual_seed(seed)

    def uniform(param, limit):
        u = torch.rand(param.shape, generator=gen, dtype=torch.float32)
        param.copy_(((2.0 * u - 1.0) * limit).to(param.device))

    for name, module in model.named_modules():
        if isinstance(module, LSTMCell):
            limit = 1.0 / math.sqrt(module.features)
            for p in (module.input.weight, module.hidden.weight,
                      module.input.bias, module.hidden.bias):
                uniform(p, limit)
        elif isinstance(module, (Linear, Conv1d)) and \
                not name.endswith((".input", ".hidden")):
            w = module.weight
            fan_in = w.shape[1] * (w.shape[2] if w.dim() == 3 else 1)
            fan_out = w.shape[0] * (w.shape[2] if w.dim() == 3 else 1)
            uniform(w, xavier_gain(name, model.cfg)
                    * math.sqrt(6.0 / (fan_in + fan_out)))
            if module.bias is not None:
                uniform(module.bias, 1.0 / math.sqrt(fan_in))
        elif name == "decoder.attention.location_conv":
            w = module.weight
            fan_in, fan_out = w.shape[1] * w.shape[2], w.shape[0] * w.shape[2]
            uniform(w, math.sqrt(6.0 / (fan_in + fan_out)))
        elif isinstance(module, Embed):
            uniform(module.embedding, math.sqrt(3.0) * module.init_std)
        elif isinstance(module, BatchNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
            module.running_mean.zero_()
            module.running_var.fill_(1.0)
    return model
