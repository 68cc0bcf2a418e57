"""The model's variables, laid out and drawn by the benchmark.

``variable_spec(model)`` lists every variable of the Tacotron / Deep Voice 2
graph under its flax path (``params/...`` and ``batch_stats/...``) with its
shape and initializer, from the configuration's ``model`` section alone.
``make_variables(model, seed, device)`` draws them on ``device`` from one
``torch.Generator`` seeded with ``seed``, in two calls (one normal draw, one
uniform draw, each split into the leaves): dense kernels normal with
stddev sqrt(1 / fan_in), convolution kernels uniform with limit
sqrt(3 / fan_avg), embeddings normal at the table's stddev, all normals cut
at 2 stddev; GRU gate biases 1, highway transform biases -1, other biases 0,
BatchNorm identity.  Both the program and the reference are given these
variables.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from .frontend import VOCAB_SIZE

Spec = List[Tuple[str, Tuple[int, ...], tuple]]


def variable_spec(m: dict, vocab_size: int = VOCAB_SIZE) -> Spec:
    out: Spec = []

    def dense(path, din, dout, bias=True, bias_value=0.0):
        out.append((f"params/{path}/kernel", (din, dout), ("normal",
                    math.sqrt(1.0 / din))))
        if bias:
            out.append((f"params/{path}/bias", (dout,), ("const",
                        bias_value)))

    def gru(path, din, units):
        dense(f"{path}/gates", din + units, 2 * units, bias_value=1.0)
        dense(f"{path}/candidate", din + units, units)

    def bn(path, c):
        out.append((f"params/{path}/BatchNorm_0/scale", (c,), ("const", 1.0)))
        out.append((f"params/{path}/BatchNorm_0/bias", (c,), ("const", 0.0)))
        out.append((f"batch_stats/{path}/BatchNorm_0/mean", (c,),
                    ("const", 0.0)))
        out.append((f"batch_stats/{path}/BatchNorm_0/var", (c,),
                    ("const", 1.0)))

    def conv(path, width, cin, cout):
        out.append((f"params/{path}/kernel", (width, cin, cout),
                    ("uniform", math.sqrt(3.0 / ((cin * width + cout * width)
                                                 / 2.0)))))
        out.append((f"params/{path}/bias", (cout,), ("const", 0.0)))

    def embed(path, n, d, std):
        out.append((f"params/{path}/embedding", (n, d), ("normal_std", std)))

    def cbhg(path, cin, K, C, proj_sizes, proj_width, highway_depth, units):
        for k in range(1, K + 1):
            out.append((f"params/{path}/conv_bank/kernel_{k}", (k, cin, C),
                        ("uniform", math.sqrt(3.0 / ((cin * k + C * k)
                                                    / 2.0)))))
        out.append((f"params/{path}/conv_bank/bias", (K * C,),
                    ("const", 0.0)))
        bn(f"{path}/bank_bn", K * C)
        prev = K * C
        for i, size in enumerate(proj_sizes):
            conv(f"{path}/proj_{i + 1}", proj_width, prev, size)
            bn(f"{path}/proj_{i + 1}_bn", size)
            prev = size
        if cin != units:
            dense(f"{path}/highway_dim_fix", cin, units)
        for i in range(highway_depth):
            dense(f"{path}/highway_{i + 1}/H", units, units)
            dense(f"{path}/highway_{i + 1}/T", units, units, bias_value=-1.0)
        gru(f"{path}/bigru/fw", units, units)
        gru(f"{path}/bigru/bw", units, units)

    memory = 2 * m["enc_rnn_size"]
    embed("char_embedding", vocab_size, m["embedding_size"], 0.5)
    din = m["embedding_size"]
    for i, size in enumerate(m["enc_prenet_sizes"]):
        dense(f"encoder_prenet/dense_{i + 1}", din, size)
        din = size
    cbhg("encoder_cbhg", m["enc_prenet_sizes"][-1], m["enc_bank_size"],
         m["enc_bank_channel_size"], m["enc_proj_sizes"], m["enc_proj_width"],
         m["enc_highway_depth"], m["enc_rnn_size"])
    dense("attention_memory_layer", memory, m["attention_size"], bias=False)
    din = m["num_mels"] + memory
    for i, size in enumerate(m["dec_prenet_sizes"]):
        dense(f"decoder/prenet/dense_{i + 1}", din, size)
        din = size
    gru("decoder/attention_rnn", m["dec_prenet_sizes"][-1],
        m["attention_state_size"])
    if m["attention_type"] != "bah_mon":
        raise ValueError("the benchmark's reference runs 'bah_mon' attention")
    out.append(("params/decoder/attention/attention_v",
                (m["attention_size"], 1),
                ("normal", math.sqrt(1.0 / m["attention_size"]))))
    out.append(("params/decoder/attention/score_bias", (), ("const", 0.0)))
    dense("decoder/attention/query_layer", m["attention_state_size"],
          m["attention_size"], bias=False)
    dense("decoder/decoder_input_projection",
          m["attention_state_size"] + memory, m["dec_rnn_size"])
    for i in range(m["dec_layer_num"]):
        gru(f"decoder/decoder_rnn_{i + 1}", m["dec_rnn_size"],
            m["dec_rnn_size"])
    dense("decoder/frame_projection", m["dec_rnn_size"],
          m["num_mels"] * m["reduction_factor"])
    cbhg("post_cbhg", m["num_mels"], m["post_bank_size"],
         m["post_bank_channel_size"], m["post_proj_sizes"],
         m["post_proj_width"], m["post_highway_depth"], m["post_rnn_size"])
    dense("linear_projection", 2 * m["post_rnn_size"], m["num_freq"])
    if m["num_speakers"] > 1:
        if m["model_type"] != "deepvoice" or m["speaker_embedding_size"] < 2:
            raise ValueError("the benchmark's reference runs single-speaker "
                             "or 'deepvoice' models with a shared embedding")
        E = m["speaker_embedding_size"]
        embed("speaker_embedding", m["num_speakers"], E, 0.5)
        sites = [("before_highway", m["enc_prenet_sizes"][-1]),
                 ("encoder_rnn_init", memory),
                 ("attention_rnn_init", m["attention_state_size"])] + [
            (f"decoder_rnn_init_{i + 1}", m["dec_rnn_size"])
            for i in range(m["dec_layer_num"])]
        for site, width in sites:
            dense(f"deep_{site}", E, width)
    return out


def count_parameters(m: dict) -> int:
    """Trainable parameters (the ``params`` collection)."""
    return sum(math.prod(shape) for path, shape, _ in variable_spec(m)
               if path.startswith("params/"))


def make_variables(m: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every variable of :func:`variable_spec` on ``device``, drawn from
    ``seed`` in one normal and one uniform draw."""
    spec = variable_spec(m)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    n_normal = sum(math.prod(s) for _, s, init in spec
                   if init[0] in ("normal", "normal_std"))
    n_uniform = sum(math.prod(s) for _, s, init in spec
                    if init[0] == "uniform")
    normal = torch.randn(n_normal, generator=gen, device=device).clamp_(
        -2.0, 2.0)
    uniform = torch.rand(n_uniform, generator=gen, device=device) * 2.0 - 1.0
    out: Dict[str, torch.Tensor] = {}
    i_n = i_u = 0
    for path, shape, init in spec:
        n = math.prod(shape)
        if init[0] in ("normal", "normal_std"):
            # the cut at 2 stddev leaves 0.8796 of the stddev
            std = init[1] / (0.87962566103423978 if init[0] == "normal"
                             else 1.0)
            out[path] = (normal[i_n:i_n + n] * std).reshape(shape)
            i_n += n
        elif init[0] == "uniform":
            out[path] = (uniform[i_u:i_u + n] * init[1]).reshape(shape)
            i_u += n
        else:
            out[path] = torch.full(shape, float(init[1]), device=device)
    return out
