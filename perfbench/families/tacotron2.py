"""Tacotron 2 (Shen et al. 2018, arXiv:1712.05884 section 2, at
NVIDIA/tacotron2's ``hparams.py`` widths): the model family of the
configuration files whose ``family`` is ``tacotron2``.

- ``variable_spec`` / ``make_variables``: the program's variable layout
  (the port's ``/``-joined paths) with NVIDIA's initializers, drawn from
  the seed in one uniform draw: xavier-uniform for the Dense layers and
  convolutions at ``torch.nn.init.calculate_gain``'s gain (ReLU for the
  encoder's convolutions, tanh for the attention's query, memory and
  location layers and all but the last post-net convolution, 1 for the
  rest), their biases uniform within 1 / sqrt(fan_in); the LSTMs uniform
  within 1 / sqrt(units); the embedding uniform within sqrt(3) *
  sqrt(2 / (symbols + width)); BatchNorm identity.
- ``reference``: ``reference/tacotron2.py``, whose mel -> linear stage
  takes the audio section that this family's configuration files share.
- ``decode_budget``: ``steps_per_token`` a token within [min_iters,
  max_iters], rounded up to the frame ladder (200, 400, 600, 800 frames)
  over r, else ``max_iters``.
- ``forward_flops`` and ``decoder_step_flops``: matrix-product FLOPs
  (1 multiply-add = 2), elementwise work left out; ``decoder_step_bytes``:
  the float32 weights a decoder step reads.
- ``SAMPLE_FIELDS``: each sampled utterance's ``stop_logits`` and
  ``spec_moments``, read by ``field_gaps``.

No ``TRAIN_REFERENCE``: the program trains Tacotron only.
"""

from __future__ import annotations

import json
import math
from typing import Dict, List

import numpy as np
import torch

from perfbench import core
from perfbench.reference.frontend import VOCAB_SIZE
from perfbench.reference.tacotron2 import Reference

__all__ = ["SAMPLE_FIELDS", "decode_budget", "decoder_step_bytes",
           "decoder_step_flops", "field_gaps", "forward_flops", "frames_per_step",
           "make_variables", "reference", "variable_spec"]

#: the decode-budget rungs in frames
FRAME_LADDER = (200, 400, 600, 800)
#: the audio keys the mel -> linear stage reads
AUDIO_KEYS = ("sample_rate", "min_level_db", "ref_level_db")
SAMPLE_FIELDS = ("stop_logits", "spec_moments")
#: the layers a decoder step runs (the memory layer runs once a decode)
STEP_LAYERS = ("decoder/prenet/", "decoder/attention_rnn/",
               "decoder/attention/", "decoder/decoder_rnn/",
               "decoder/frame_projection/", "decoder/gate_layer/")

TANH = 5.0 / 3.0
RELU = math.sqrt(2.0)


def variable_spec(m: dict, vocab_size: int = VOCAB_SIZE):
    """(path, shape, uniform limit or ("const", value)) of every
    variable."""
    out = []

    def xavier(path, fan_in, fan_out, shape, gain, bias):
        out.append((f"params/{path}/kernel", shape,
                    gain * math.sqrt(6.0 / (fan_in + fan_out))))
        if bias:
            out.append((f"params/{path}/bias", (shape[-1],),
                        1.0 / math.sqrt(fan_in)))

    def dense(path, din, dout, gain=1.0, bias=True):
        xavier(path, din, dout, (din, dout), gain, bias)

    def conv(path, width, cin, cout, gain, bias=True):
        xavier(path, cin * width, cout * width, (width, cin, cout), gain,
               bias)

    def bn(path, c):
        for leaf, value in (("scale", 1.0), ("bias", 0.0)):
            out.append((f"params/{path}/BatchNorm_0/{leaf}", (c,),
                        ("const", value)))
        for leaf, value in (("mean", 0.0), ("var", 1.0)):
            out.append((f"batch_stats/{path}/BatchNorm_0/{leaf}", (c,),
                        ("const", value)))

    def lstm(path, din, units):
        limit = 1.0 / math.sqrt(units)
        for name, fan in (("input", din), ("hidden", units)):
            out.append((f"params/{path}/{name}/kernel", (fan, 4 * units),
                        limit))
            out.append((f"params/{path}/{name}/bias", (4 * units,), limit))

    E, C = m["embedding_size"], m["t2_enc_conv_channels"]
    out.append(("params/char_embedding/embedding", (vocab_size, E),
                math.sqrt(3.0) * math.sqrt(2.0 / (vocab_size + E))))
    cin = E
    for i in range(1, m["t2_enc_conv_num"] + 1):
        conv(f"encoder/convs/conv_{i}", m["t2_enc_conv_width"], cin, C, RELU)
        bn(f"encoder/convs/conv_{i}_bn", C)
        cin = C
    H = m["t2_enc_lstm_size"]
    for d in ("fw", "bw"):
        lstm(f"encoder/lstm/{d}", C, H)
    mem, att = 2 * H, m["attention_size"]
    A, D = m["t2_attention_lstm_size"], m["t2_decoder_lstm_size"]
    din = m["num_mels"]
    for i, size in enumerate(m["dec_prenet_sizes"]):
        dense(f"decoder/prenet/dense_{i + 1}", din, size, bias=False)
        din = size
    lstm("decoder/attention_rnn", din + mem, A)
    dense("decoder/attention/query_layer", A, att, TANH, bias=False)
    conv("decoder/attention/location_conv", m["t2_location_width"], 2,
         m["t2_location_filters"], 1.0, bias=False)
    dense("decoder/attention/location_dense", m["t2_location_filters"], att,
          TANH, bias=False)
    dense("decoder/attention/v", att, 1, bias=False)
    dense("decoder/memory_layer", mem, att, TANH, bias=False)
    lstm("decoder/decoder_rnn", A + mem, D)
    dense("decoder/frame_projection", D + mem,
          m["num_mels"] * m["reduction_factor"])
    dense("decoder/gate_layer", D + mem, 1)
    P, n = m["t2_postnet_channels"], m["t2_postnet_conv_num"]
    sizes = [m["num_mels"]] + [P] * (n - 1) + [m["num_mels"]]
    for i in range(1, n + 1):
        conv(f"postnet/conv_{i}", m["t2_postnet_width"], sizes[i - 1],
             sizes[i], TANH if i < n else 1.0)
        bn(f"postnet/conv_{i}_bn", sizes[i])
    return out


def make_variables(m: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every variable of :func:`variable_spec` on ``device``, drawn from
    ``seed`` in one uniform draw."""
    spec = variable_spec(m)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    n = sum(math.prod(shape) for _, shape, init in spec
            if not isinstance(init, tuple))
    u = torch.rand(n, generator=gen, device=device) * 2.0 - 1.0
    out, i = {}, 0
    for path, shape, init in spec:
        if isinstance(init, tuple):
            out[path] = torch.full(shape, float(init[1]), device=device)
            continue
        k = math.prod(shape)
        out[path] = (u[i:i + k] * init).reshape(shape)
        i += k
    return out


def audio_section() -> dict:
    """The audio keys of the mel -> linear stage, as every configuration
    file of this family states them (they must agree)."""
    found = set()
    for path in sorted((core.HERE / "configs").glob("*.json")):
        config = core.load_json(path)
        if config.get("family") == "tacotron2":
            audio = config["config"]["audio"]
            found.add(json.dumps({k: audio[k] for k in AUDIO_KEYS},
                                 sort_keys=True))
    if len(found) != 1:
        raise SystemExit(f"perfbench: the tacotron2 configurations state "
                         f"{len(found)} audio sections ({sorted(found)}); "
                         f"the reference reads one")
    return json.loads(found.pop())


def reference(variables, model: dict, precision: str) -> Reference:
    """The plain graph over ``variables`` at ``precision`` (``float32``
    or ``tf32``)."""
    return Reference(variables, model, audio_section(), precision)


def decode_budget(cfg: dict, n_tokens: int) -> int:
    m = cfg["model"]
    r = m["reduction_factor"]
    need = int(math.ceil(m["steps_per_token"] * max(1, n_tokens)))
    need = min(max(need, cfg["data"]["min_iters"]), m["max_iters"])
    for frames in FRAME_LADDER:
        rung = -(-frames // r)
        if need <= rung <= m["max_iters"]:
            return rung
    return m["max_iters"]


def frames_per_step(model: dict) -> int:
    return model["reduction_factor"]


def _lstm_flops(rows: int, din: int, units: int) -> float:
    return 2.0 * rows * (din + units) * 4 * units


def decoder_step_flops(m: dict, rows: int, t_in: int) -> float:
    """Matrix-product FLOPs of one decoder step over ``rows`` rows and
    ``t_in`` memory positions: the prenet, the attention LSTM, the query,
    the location convolution and its projection, the scores' ``v``, the
    context, the decoder LSTM, the frames and the gate."""
    mem, att = 2 * m["t2_enc_lstm_size"], m["attention_size"]
    A, D = m["t2_attention_lstm_size"], m["t2_decoder_lstm_size"]
    filters = m["t2_location_filters"]
    prenet, din = 0.0, m["num_mels"]
    for size in m["dec_prenet_sizes"]:
        prenet += 2.0 * rows * din * size
        din = size
    attention = (2.0 * rows * A * att
                 + 2.0 * rows * t_in * 2 * m["t2_location_width"] * filters
                 + 2.0 * rows * t_in * filters * att
                 + 2.0 * rows * t_in * att
                 + 2.0 * rows * t_in * mem)
    out = 2.0 * rows * (D + mem) * (m["num_mels"] * m["reduction_factor"]
                                    + 1)
    return (prenet + _lstm_flops(rows, din + mem, A) + attention
            + _lstm_flops(rows, A + mem, D) + out)


def decoder_step_bytes(m: dict) -> float:
    """Bytes one decoder step must read at least: every float32 weight of
    :data:`STEP_LAYERS` once, whatever the rows.  At hparams.py widths that
    is 72.8 MB, 71.4 MB of it the two LSTMs'.  The step reads them in the
    same order every step, a cycle larger than the 50 MB L2, so none is
    counted as held there."""
    layers = tuple("params/" + layer for layer in STEP_LAYERS)
    return 4.0 * sum(math.prod(shape) for path, shape, _ in variable_spec(m)
                     if path.startswith(layers))


def forward_flops(model: dict, batch: int, t_in: int, t_out: int) -> float:
    """Matrix-product FLOPs of one greedy forward over ``t_in`` tokens and
    ``t_out`` frames: the encoder (convolutions, BiLSTM, the attention's
    memory keys), ``t_out / r`` decoder steps, the post-net and mel ->
    linear."""
    m = model
    rows = batch * t_in
    E, C = m["embedding_size"], m["t2_enc_conv_channels"]
    w, H = m["t2_enc_conv_width"], m["t2_enc_lstm_size"]
    encoder = 0.0
    cin = E
    for _ in range(m["t2_enc_conv_num"]):
        encoder += 2.0 * rows * w * cin * C
        cin = C
    encoder += 2 * _lstm_flops(rows, C, H)
    encoder += 2.0 * rows * 2 * H * m["attention_size"]
    steps = t_out // m["reduction_factor"]
    decoder = steps * decoder_step_flops(m, batch, t_in)
    frames = batch * t_out
    P, n = m["t2_postnet_channels"], m["t2_postnet_conv_num"]
    sizes = [m["num_mels"]] + [P] * (n - 1) + [m["num_mels"]]
    postnet = sum(2.0 * frames * m["t2_postnet_width"] * a * b
                  for a, b in zip(sizes, sizes[1:]))
    to_linear = 2.0 * frames * m["num_mels"] * m["num_freq"]
    return encoder + decoder + postnet + to_linear


def field_gaps(items: List[dict], rows: List[dict]) -> Dict[str, float]:
    """``stop_gap``: the widest gap between the program's stop logits and
    the reference's over every sampled utterance and step; ``spec_gap``:
    the widest relative gap of the vocoder input's two moments (sum, sum
    of squares).  An utterance whose fields have other shapes than the
    reference's reads infinity."""
    stop, spec = 0.0, 0.0
    for item, row in zip(items, rows):
        s = np.asarray(item["stop_logits"], np.float64)
        s_ref = row["stop_logits"].double().numpy()
        mo = np.asarray(item["spec_moments"], np.float64)
        mo_ref = row["spec_moments"].double().numpy()
        if s.shape != s_ref.shape or mo.shape != mo_ref.shape:
            return {"stop_gap": float("inf"), "spec_gap": float("inf")}
        stop = max(stop, float(np.abs(s - s_ref).max()))
        spec = max(spec, float((np.abs(mo - mo_ref)
                                / np.maximum(np.abs(mo_ref), 1e-30)).max()))
    return {"stop_gap": stop, "spec_gap": spec}
