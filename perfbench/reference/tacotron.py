"""Plain PyTorch reference of the Tacotron / Deep Voice 2 graph, its losses
and its optimizer, written from the reference TensorFlow graph
(``models/tacotron.py``, ``models/modules.py``, ``models/rnn_wrappers.py``
of the TF1 implementation) and its hyperparameters.

It reads the variables by their flax paths (``weights.py``), runs batched
and in float32, and spells every product out as one matrix product
(``mm``), so that ``precision="tf32"`` rounds the operands of every product
to TF32 (10 mantissa bits) for the benchmark's control.  Nothing here comes
from the program under test.

Greedy inference (``infer``): dropout off, BatchNorm on the running
statistics, the last of the r frames of each step fed back.  Teacher-forced
training (``train_forward``): the prenets' dropout draws its uniforms from
a ``torch.Generator`` in graph order (the encoder prenet's two layers, then
the decoder prenet's two layers step by step), and every BatchNorm
normalizes by the batch's statistics (padded positions included) and moves
its running statistics by 0.01.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-3
BN_MOMENTUM = 0.99


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value (10 mantissa
    bits)."""
    bits = x.detach().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """``a @ b`` with the operands of the product and of both gradient
    products rounded to TF32, sums in float32."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, grad):
        ra, rb = ctx.saved_tensors
        g = round_tf32(grad)
        ga = g @ rb.transpose(-1, -2)
        gb = ra.transpose(-1, -2) @ g
        # sum the gradient of a broadcast operand over its leading axes
        while gb.dim() > rb.dim():
            gb = gb.sum(0)
        while ga.dim() > ra.dim():
            ga = ga.sum(0)
        return ga, gb


class Reference:
    """The graph over ``variables`` (flat flax paths -> tensors) for the
    configuration's ``model`` section ``m``."""

    def __init__(self, variables: Dict[str, torch.Tensor], m: dict,
                 precision: str = "float32"):
        if precision not in ("float32", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.v = variables
        self.m = m
        self.precision = precision

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

    def gru(self, path: str, h: torch.Tensor, x: torch.Tensor
            ) -> torch.Tensor:
        gates = torch.sigmoid(self.dense(path + "/gates",
                                         torch.cat([x, h], -1)))
        r, u = gates.chunk(2, dim=-1)
        c = torch.tanh(self.dense(path + "/candidate",
                                  torch.cat([x, r * h], -1)))
        return u * h + (1.0 - u) * c

    def conv_same(self, x: torch.Tensor, kernel: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
        """TF SAME cross-correlation of [N, T, C] with a [w, C, C_out]
        kernel: (w - 1) // 2 zeros on the left, the rest on the right."""
        w, cin, cout = kernel.shape
        left = (w - 1) // 2
        xp = F.pad(x, (0, 0, left, w - 1 - left))
        cols = xp.unfold(1, w, 1).transpose(2, 3)       # [N, T, w, C]
        N, T = cols.shape[:2]
        return self.mm(cols.reshape(N, T, w * cin),
                       kernel.reshape(w * cin, cout)) + bias

    def batchnorm(self, path: str, x: torch.Tensor,
                  stats: Optional[dict]) -> torch.Tensor:
        """Inference (``stats`` None) or training, where the new running
        statistics go into ``stats``."""
        scale = self.p(path + "/BatchNorm_0/scale")
        bias = self.p(path + "/BatchNorm_0/bias")
        key = "batch_stats/" + path + "/BatchNorm_0/"
        if stats is None:
            mean, var = self.v[key + "mean"], self.v[key + "var"]
        else:
            mean = x.mean(dim=(0, 1))
            var = torch.clamp((x * x).mean(dim=(0, 1)) - mean * mean,
                              min=0.0)
            stats[key + "mean"] = (BN_MOMENTUM * self.v[key + "mean"]
                                   + (1.0 - BN_MOMENTUM) * mean.detach())
            stats[key + "var"] = (BN_MOMENTUM * self.v[key + "var"]
                                  + (1.0 - BN_MOMENTUM) * var.detach())
        return (x - mean) * (torch.rsqrt(var + BN_EPS) * scale) + bias

    def prenet(self, path: str, x: torch.Tensor, n_layers: int,
               gen: Optional[torch.Generator]) -> torch.Tensor:
        rate = self.m["dropout_prob"]
        for i in range(n_layers):
            x = F.relu(self.dense(f"{path}/dense_{i + 1}", x))
            if gen is not None and rate > 0.0:
                keep = torch.rand(tuple(x.shape), generator=gen,
                                  device=x.device) >= rate
                x = torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
        return x

    def bigru(self, path: str, xs: torch.Tensor,
              lengths: Optional[torch.Tensor],
              init: Optional[torch.Tensor]) -> torch.Tensor:
        """Both directions over [N, T, D]; with ``lengths`` each row runs
        over its own length and its outputs past it are 0."""
        N, T, _ = xs.shape
        units = self.p(path + "/fw/candidate/kernel").shape[-1]
        if init is None:
            h_fw = xs.new_zeros((N, units))
            h_bw = xs.new_zeros((N, units))
        else:
            h_fw, h_bw = init[:, :units], init[:, units:]
        fw, bw = [], [None] * T
        for t in range(T):
            new = self.gru(path + "/fw", h_fw, xs[:, t])
            if lengths is None:
                h_fw = new
                fw.append(new)
            else:
                live = (t < lengths)[:, None]
                h_fw = torch.where(live, new, h_fw)
                fw.append(torch.where(live, new, torch.zeros_like(new)))
        for t in range(T - 1, -1, -1):
            new = self.gru(path + "/bw", h_bw, xs[:, t])
            if lengths is None:
                h_bw = new
                bw[t] = new
            else:
                live = (t < lengths)[:, None]
                h_bw = torch.where(live, new, h_bw)
                bw[t] = torch.where(live, new, torch.zeros_like(new))
        return torch.cat([torch.stack(fw, 1), torch.stack(bw, 1)], dim=-1)

    def cbhg(self, path: str, x: torch.Tensor, lengths, bank_size: int,
             n_proj: int, highway_depth: int, before_highway=None,
             rnn_init=None, stats: Optional[dict] = None) -> torch.Tensor:
        branches = []
        bank_bias = self.p(path + "/conv_bank/bias")
        C = bank_bias.shape[0] // bank_size
        for k in range(1, bank_size + 1):
            branches.append(self.conv_same(
                x, self.p(f"{path}/conv_bank/kernel_{k}"),
                bank_bias[(k - 1) * C:k * C]))
        conv = self.batchnorm(path + "/bank_bn",
                              F.relu(torch.cat(branches, -1)), stats)
        # width-2 SAME max pool: x[t] against x[t + 1], -inf past the end
        nxt = torch.cat([conv[:, 1:], torch.full_like(conv[:, :1],
                                                      float("-inf"))], 1)
        proj = torch.maximum(conv, nxt)
        for i in range(1, n_proj + 1):
            proj = self.conv_same(proj, self.p(f"{path}/proj_{i}/kernel"),
                                  self.p(f"{path}/proj_{i}/bias"))
            if i != n_proj:
                proj = F.relu(proj)
            proj = self.batchnorm(f"{path}/proj_{i}_bn", proj, stats)
        hw = proj + x
        if before_highway is not None:
            hw = hw + before_highway[:, None, :]
        if f"params/{path}/highway_dim_fix/kernel" in self.v:
            hw = self.dense(path + "/highway_dim_fix", hw)
        for d in range(1, highway_depth + 1):
            h = F.relu(self.dense(f"{path}/highway_{d}/H", hw))
            t = torch.sigmoid(self.dense(f"{path}/highway_{d}/T", hw))
            hw = h * t + hw * (1.0 - t)
        return self.bigru(path + "/bigru", hw, lengths, rnn_init)

    def attention(self, query, keys, previous):
        """Bahdanau monotonic attention (Raffel et al. 2017, parallel
        mode, TF's safe cumprod)."""
        processed = self.mm(query, self.p("decoder/attention/query_layer/"
                                          "kernel"))
        score = self.mm(torch.tanh(keys + processed[:, None, :]),
                        self.p("decoder/attention/attention_v"))[..., 0]
        p_choose = torch.sigmoid(score + self.p("decoder/attention/"
                                                "score_bias"))
        logs = torch.log(torch.clamp(1.0 - p_choose, 1e-10, 1.0))
        cums = torch.cumsum(logs, dim=-1)
        cumprod = torch.exp(torch.cat([torch.zeros_like(cums[:, :1]),
                                       cums[:, :-1]], -1))
        return p_choose * cumprod * torch.cumsum(
            previous / torch.clamp(cumprod, 1e-10, 1.0), dim=-1)

    # --------------------------------------------------------------- graph

    def speaker(self, speaker_id):
        m = self.m
        if m["num_speakers"] <= 1:
            return None
        embed = self.p("speaker_embedding/embedding")[speaker_id]

        def site(name):
            return F.softsign(self.dense("deep_" + name, embed))

        return {"before_highway": site("before_highway"),
                "encoder_rnn_init": site("encoder_rnn_init"),
                "attention_rnn_init": site("attention_rnn_init"),
                "decoder_rnn_inits": [site(f"decoder_rnn_init_{i + 1}")
                                      for i in range(m["dec_layer_num"])]}

    def _run(self, inputs, input_lengths, speaker_id, num_steps: int,
             decoder_inputs, gen, stats) -> Dict[str, torch.Tensor]:
        m = self.m
        r, M = m["reduction_factor"], m["num_mels"]
        cond = self.speaker(speaker_id)
        embedded = self.p("char_embedding/embedding")[inputs]
        pre = self.prenet("encoder_prenet", embedded,
                          len(m["enc_prenet_sizes"]), gen)
        memory = self.cbhg(
            "encoder_cbhg", pre, input_lengths, m["enc_bank_size"],
            len(m["enc_proj_sizes"]), m["enc_highway_depth"],
            None if cond is None else cond["before_highway"],
            None if cond is None else cond["encoder_rnn_init"], stats)
        N, T_in, D = memory.shape
        keys = self.mm(memory, self.p("attention_memory_layer/kernel"))
        attn_state = (memory.new_zeros((N, m["attention_state_size"]))
                      if cond is None else cond["attention_rnn_init"])
        dec_states = ([memory.new_zeros((N, m["dec_rnn_size"]))
                       for _ in range(m["dec_layer_num"])]
                      if cond is None else list(cond["decoder_rnn_inits"]))
        context = memory.new_zeros((N, D))
        align = memory.new_zeros((N, T_in))
        align[:, 0] = 1.0
        frame = memory.new_zeros((N, M))
        frames_all, aligns_all = [], []
        for t in range(num_steps):
            x = frame if decoder_inputs is None else decoder_inputs[:, t]
            pre = self.prenet("decoder/prenet", torch.cat([x, context], -1),
                              len(m["dec_prenet_sizes"]), gen)
            attn_state = self.gru("decoder/attention_rnn", attn_state, pre)
            align = self.attention(attn_state, keys, align)
            context = torch.einsum("nt,ntd->nd", align, memory)
            h = self.dense("decoder/decoder_input_projection",
                           torch.cat([attn_state, context], -1))
            for i in range(m["dec_layer_num"]):
                dec_states[i] = self.gru(f"decoder/decoder_rnn_{i + 1}",
                                         dec_states[i], h)
                h = h + dec_states[i]
            frames = self.dense("decoder/frame_projection", h)
            frame = frames[:, -M:]
            frames_all.append(frames)
            aligns_all.append(align)
        mel = torch.stack(frames_all, 1).reshape(N, num_steps * r, M)
        post = self.cbhg("post_cbhg", mel, None, m["post_bank_size"],
                         len(m["post_proj_sizes"]), m["post_highway_depth"],
                         stats=stats)
        return {"mel_outputs": mel,
                "linear_outputs": self.dense("linear_projection", post),
                "alignments": torch.stack(aligns_all, 2)}  # [N, T_in, T_dec]

    @torch.no_grad()
    def infer(self, inputs, input_lengths, speaker_id,
              num_steps: int) -> Dict[str, torch.Tensor]:
        """Greedy decode of ``num_steps`` steps."""
        return self._run(inputs, input_lengths, speaker_id, num_steps, None,
                         None, None)

    def train_forward(self, inputs, input_lengths, speaker_id, mel_targets,
                      gen: torch.Generator
                      ) -> Tuple[Dict[str, torch.Tensor], dict]:
        """Teacher-forced training forward; returns (outputs, the moved
        running statistics)."""
        r = self.m["reduction_factor"]
        taken = mel_targets[:, r - 1::r, :]
        decoder_inputs = torch.cat([torch.zeros_like(taken[:, :1]),
                                    taken[:, :-1]], 1)
        stats: dict = {}
        out = self._run(inputs, input_lengths, speaker_id,
                        decoder_inputs.shape[1], decoder_inputs, gen, stats)
        return out, stats


def l1_loss(out: Dict[str, torch.Tensor], mel_targets, linear_targets,
            loss_coeff, target_lengths, r: int) -> torch.Tensor:
    """L1 on mel and linear spectrograms, each weighted per utterance, both
    means over the frames the reference pads a batch to:
    round_up(max(target_lengths) + 1, r), at most the padded length."""
    n_pad = mel_targets.shape[1]
    ref_len = min(n_pad, -(-(int(target_lengths.max()) + 1) // r) * r)
    coeff = loss_coeff[:, None, None]
    N = mel_targets.shape[0]

    def mean(x):
        return x[:, :ref_len].sum() / (N * ref_len * x.shape[-1])

    mel_l1 = torch.abs(mel_targets - out["mel_outputs"])
    lin_l1 = torch.abs(linear_targets - out["linear_outputs"])
    return mean(mel_l1 * coeff) + mean(lin_l1 * coeff)


class Adam:
    """Global-norm clip, then Adam, then the Noam warmup schedule
    ``lr * ws**0.5 * min(t * ws**-1.5, t**-0.5)`` at t = count + 1: the
    reference's optimizer (``train.py``) with its hyperparameters."""

    def __init__(self, t: dict, params: Dict[str, torch.Tensor]):
        self.clip = t["grad_clip_norm"]
        self.b1, self.b2 = t["adam_beta1"], t["adam_beta2"]
        self.lr0 = t["initial_learning_rate"]
        self.warmup = t["warmup_steps_fresh"]
        if t["decay_learning_rate_mode"] != 0:
            raise ValueError("the benchmark's reference runs the Noam "
                             "schedule (decay_learning_rate_mode 0)")
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Updates ``params`` in place; returns the clipped gradients."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        scale = 1.0 if float(norm) < self.clip else self.clip / float(norm)
        t = float(self.count + 1)
        lr = self.lr0 * self.warmup ** 0.5 * min(t * self.warmup ** -1.5,
                                                 t ** -0.5)
        clipped = {}
        for k, p in params.items():
            g = grads[k] * scale
            clipped[k] = g
            self.m[k] = self.b1 * self.m[k] + (1.0 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1.0 - self.b2) * g * g
            m_hat = self.m[k] / (1.0 - self.b1 ** t)
            v_hat = self.v[k] / (1.0 - self.b2 ** t)
            p -= lr * m_hat / (torch.sqrt(v_hat) + 1e-8)
        self.count += 1
        return clipped
