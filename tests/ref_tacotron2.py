"""A plain PyTorch Tacotron 2 for inference, the second witness of
``tacotron_tpu_torch/models/tacotron2.py`` in the CPU tests.

Written from the paper (arXiv:1712.05884 section 2) and NVIDIA/tacotron2's
``model.py``, with ``torch.nn.LSTM`` / ``torch.nn.LSTMCell`` for the
recurrences and ``F.conv1d`` for the convolutions, in float32 with TF32
off.  It decodes one text at a time, unpadded (so no padding or masking
enters it), from the flat ``params/...`` / ``batch_stats/...`` variables of
the port's layout.  It imports nothing of the port and nothing of JAX.

The prenet's inference dropout keeps unit u of layer l at step t when
``mix(mix(mix(k, t), l), u) >= floor(rate * 2**32)`` over 32-bit unsigned
integers, with ``fmix`` the lowbias32 finalizer, ``mix(a, b) = fmix(a ^
fmix(b ^ 0x9e3779b9))`` and the text's key ``k = mix(sum_i mix(id_i, i),
n)`` over its n ids, and ``rate`` is 0.5 (NVIDIA's ``Prenet.forward``
hard-codes it); here in numpy ``uint64`` arithmetic masked to 32 bits.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

M32 = np.uint64(0xFFFFFFFF)
PRENET_DROPOUT = 0.5


def fmix(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.uint64) & M32
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(0x7FEB352D)) & M32
    x ^= x >> np.uint64(15)
    x = (x * np.uint64(0x846CA68B)) & M32
    x ^= x >> np.uint64(16)
    return x


def mix(a, b) -> np.ndarray:
    return fmix(np.asarray(a, np.uint64)
                ^ fmix(np.asarray(b, np.uint64) ^ np.uint64(0x9E3779B9)))


def keep_masks(ids: Sequence[int], steps: int, sizes: Sequence[int]):
    """Per prenet layer the scaled keep mask [steps, units] of one text."""
    rate = PRENET_DROPOUT
    n = len(ids)
    total = int(mix(np.asarray(ids), np.arange(n)).sum()) & 0xFFFFFFFF
    k = mix(total, n)
    per_step = mix(k, np.arange(steps))
    threshold = math.floor(rate * 2 ** 32)
    out = []
    for layer, units in enumerate(sizes):
        z = mix(mix(per_step, layer)[:, None], np.arange(units))
        out.append(np.where(z >= threshold, 1.0 / (1.0 - rate),
                            0.0).astype(np.float32))
    return out


def mel_basis(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """librosa.filters.mel's defaults (Slaney mel scale and area)."""
    def to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f < 1000.0, 3.0 * f / 200.0,
                        15.0 + 27.0 * np.log(np.maximum(f, 1e-10) / 1000.0)
                        / np.log(6.4))

    def to_hz(mel):
        mel = np.asarray(mel, np.float64)
        return np.where(mel < 15.0, 200.0 * mel / 3.0,
                        1000.0 * np.exp(np.log(6.4) * (mel - 15.0) / 27.0))

    fft = np.linspace(0, sr / 2.0, 1 + n_fft // 2)
    pts = to_hz(np.linspace(to_mel(0.0), to_mel(sr / 2.0), n_mels + 2))
    w = np.zeros((n_mels, len(fft)))
    for i in range(n_mels):
        up = (fft - pts[i]) / (pts[i + 1] - pts[i])
        down = (pts[i + 2] - fft) / (pts[i + 2] - pts[i + 1])
        w[i] = np.maximum(0.0, np.minimum(up, down)) * 2.0 / (pts[i + 2]
                                                              - pts[i])
    return w.astype(np.float32)


class Tacotron2Reference:
    """``infer(inputs, lengths, speaker, steps)`` over a padded batch,
    each row decoded alone."""

    def __init__(self, variables: Dict[str, np.ndarray], m: dict,
                 audio: dict):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.v = {k: torch.as_tensor(np.asarray(a, np.float32))
                  for k, a in variables.items()}
        self.m, self.audio = m, audio
        n_fft = (m["num_freq"] - 1) * 2
        basis = mel_basis(audio["sample_rate"], n_fft, m["num_mels"])
        self.inv_basis = torch.as_tensor(
            np.linalg.pinv(basis.astype(np.float64)).astype(np.float32))

    def p(self, path):
        return self.v["params/" + path]

    def linear(self, path, x):
        bias = self.v.get(f"params/{path}/bias")
        return F.linear(x, self.p(path + "/kernel").T, bias)

    def conv_bn(self, path, x):
        """[1, C, T] -> conv (same length) -> BatchNorm (eps 1e-5)."""
        kernel = self.p(path + "/kernel").permute(2, 1, 0)
        y = F.conv1d(x, kernel, self.v.get(f"params/{path}/bias"),
                     padding=kernel.shape[-1] // 2)
        bn = path + "_bn/BatchNorm_0/"
        return F.batch_norm(y, self.v["batch_stats/" + bn + "mean"],
                            self.v["batch_stats/" + bn + "var"],
                            self.p(bn + "scale"), self.p(bn + "bias"),
                            training=False, eps=1e-5)

    def cell(self, path) -> torch.nn.LSTMCell:
        din, hidden4 = self.p(path + "/input/kernel").shape
        cell = torch.nn.LSTMCell(din, hidden4 // 4)
        with torch.no_grad():
            cell.weight_ih.copy_(self.p(path + "/input/kernel").T)
            cell.weight_hh.copy_(self.p(path + "/hidden/kernel").T)
            cell.bias_ih.copy_(self.p(path + "/input/bias"))
            cell.bias_hh.copy_(self.p(path + "/hidden/bias"))
        return cell

    def bilstm(self, x):
        """[1, n, C] -> [1, n, 2H] through ``torch.nn.LSTM``."""
        H = self.p("encoder/lstm/fw/hidden/kernel").shape[0]
        lstm = torch.nn.LSTM(x.shape[-1], H, batch_first=True,
                             bidirectional=True)
        with torch.no_grad():
            for suffix, d in (("", "fw"), ("_reverse", "bw")):
                base = f"encoder/lstm/{d}"
                getattr(lstm, "weight_ih_l0" + suffix).copy_(
                    self.p(base + "/input/kernel").T)
                getattr(lstm, "weight_hh_l0" + suffix).copy_(
                    self.p(base + "/hidden/kernel").T)
                getattr(lstm, "bias_ih_l0" + suffix).copy_(
                    self.p(base + "/input/bias"))
                getattr(lstm, "bias_hh_l0" + suffix).copy_(
                    self.p(base + "/hidden/bias"))
        return lstm(x)[0]

    @torch.no_grad()
    def one(self, ids, steps):
        m = self.m
        n = len(ids)
        x = self.p("char_embedding/embedding")[torch.as_tensor(ids)].T[None]
        for i in range(1, m["t2_enc_conv_num"] + 1):
            x = F.relu(self.conv_bn(f"encoder/convs/conv_{i}", x))
        memory = self.bilstm(x.transpose(1, 2))[0]            # [n, 2H]
        keys = self.linear("decoder/memory_layer", memory)    # [n, A]
        masks = keep_masks(ids, steps, m["dec_prenet_sizes"])
        att_cell = self.cell("decoder/attention_rnn")
        dec_cell = self.cell("decoder/decoder_rnn")
        att = (torch.zeros(1, att_cell.hidden_size),) * 2
        dec = (torch.zeros(1, dec_cell.hidden_size),) * 2
        prev, cum = torch.zeros(n), torch.zeros(n)
        context = torch.zeros(1, memory.shape[1])
        frame = torch.zeros(1, m["num_mels"])
        loc = self.p("decoder/attention/location_conv/kernel").permute(2, 1, 0)
        mels, gates, aligns = [], [], []
        for t in range(steps):
            h = frame
            for l, mask in enumerate(masks):
                h = F.relu(self.linear(f"decoder/prenet/dense_{l + 1}", h)) \
                    * torch.as_tensor(mask[t])
            att = att_cell(torch.cat([h, context], 1), att)
            f = F.conv1d(torch.stack([prev, cum])[None], loc,
                         padding=loc.shape[-1] // 2)[0].T      # [n, filters]
            e = self.linear("decoder/attention/v", torch.tanh(
                self.linear("decoder/attention/query_layer", att[0])
                + self.linear("decoder/attention/location_dense", f)
                + keys))[:, 0]
            prev = torch.softmax(e, 0)
            cum = cum + prev
            context = (prev @ memory)[None]
            dec = dec_cell(torch.cat([att[0], context], 1), dec)
            out = torch.cat([dec[0], context], 1)
            mels.append(self.linear("decoder/frame_projection", out)[0])
            gates.append(self.linear("decoder/gate_layer", out)[0, 0])
            aligns.append(prev)
            frame = mels[-1][None, -m["num_mels"]:]
        mel = torch.stack(mels).reshape(-1, m["num_mels"])     # [T, M]
        y = mel.T[None]
        n_post = m["t2_postnet_conv_num"]
        for i in range(1, n_post + 1):
            y = self.conv_bn(f"postnet/conv_{i}", y)
            if i < n_post:
                y = torch.tanh(y)
        mel = mel + y[0].T
        a = self.audio
        amp = 10.0 ** ((mel.clamp(0, 1) * -a["min_level_db"]
                        + a["min_level_db"]) / 20.0)
        mag = torch.clamp(amp @ self.inv_basis.T, min=1e-10)
        db = 20.0 * torch.log10(mag.clamp(min=1e-5)) - a["ref_level_db"]
        linear = ((db - a["min_level_db"]) / -a["min_level_db"]).clamp(0, 1)
        l64 = linear.double()
        return {"alignments": torch.stack(aligns, 1), "mel_outputs": mel,
                "linear_outputs": linear, "stop_logits": torch.stack(gates),
                "spec_moments": torch.stack([l64.sum(), (l64 * l64).sum()])}

    def infer(self, inputs, input_lengths, speaker_id, num_steps: int
              ) -> Dict[str, torch.Tensor]:
        """``alignments`` [N, T_in, steps] (0 past each text), the rest
        stacked by row."""
        if speaker_id is not None:
            raise ValueError("single-speaker")
        rows = [self.one(inputs[i, :int(input_lengths[i])].tolist(),
                         num_steps) for i in range(inputs.shape[0])]
        out = {k: torch.stack([r[k] for r in rows])
               for k in rows[0] if k != "alignments"}
        out["alignments"] = torch.stack([
            F.pad(r["alignments"], (0, 0, 0, inputs.shape[1]
                                    - r["alignments"].shape[0]))
            for r in rows])
        return out
