"""Analytic FLOP, byte and sequential-step model of the train step: the
counterpart of ``tacotron_tpu/train/roofline.py``, with the H100's peaks.

A matmul-FLOP model built from the config (every dense, convolution, GRU
and attention contraction of ``models/tacotron.py``), a memory-byte model
(parameter and optimizer traffic plus the major activations), and the
count of *sequential* loop iterations, which binds this model at small
batch: the per-layer products at batch 16 are far too small to fill the
card, so a step is bound by its chain of small kernels, not by FLOPs or
bytes.

Conventions: 1 MAC = 2 FLOPs; backward = 2x forward matmul FLOPs (one
matmul each for the input and the weight gradient), total = 3x forward;
elementwise, BatchNorm and softmax FLOPs are left out (well under 1 %).
The model counts the work a forward of ``t_in`` tokens and ``t_out``
frames does, whatever card runs it; only the peaks below are the card's.
"""

from __future__ import annotations

from typing import Dict

from ..config import Config

# Published peaks of one NVIDIA H100 SXM5 80GB (dense): float32 outside the
# tensor cores, the rate of the port's float32 training (TF32 is off), and
# HBM3 bandwidth.
H100_FP32_PEAK_TFLOPS = 67.0
H100_HBM_GB_S = 3350.0


def _gru_macs(in_dim: int, units: int) -> int:
    """One GRUCell step: gates [in+u -> 2u] + candidate [in+u -> u]."""
    return (in_dim + units) * 2 * units + (in_dim + units) * units


def forward_flops(config: Config, batch: int, t_in: int,
                  t_out: int) -> Dict[str, float]:
    """Matmul FLOPs of one teacher-forced forward, by component."""
    m = config.model
    r = m.reduction_factor
    steps = t_out // r
    B = batch

    def dense(rows, din, dout):
        return 2.0 * rows * din * dout

    comp: Dict[str, float] = {}

    # encoder prenet (embedding lookup is gather, ~0 FLOPs)
    rows = B * t_in
    din = m.embedding_size
    enc_prenet = 0.0
    for dout in m.enc_prenet_sizes:
        enc_prenet += dense(rows, din, dout)
        din = dout
    comp["enc_prenet"] = enc_prenet

    # encoder CBHG
    cin = m.enc_prenet_sizes[-1]
    K, C = m.enc_bank_size, m.enc_bank_channel_size
    bank = sum(dense(rows, k * cin, C) for k in range(1, K + 1))
    proj = 0.0
    pin = K * C
    for pout in m.enc_proj_sizes:
        proj += dense(rows, m.enc_proj_width * pin, pout)
        pin = pout
    hw_in = m.enc_proj_sizes[-1]
    dim_fix = (dense(rows, hw_in, m.enc_rnn_size)
               if hw_in != m.enc_rnn_size else 0.0)
    highway = m.enc_highway_depth * 2 * dense(rows, m.enc_rnn_size,
                                              m.enc_rnn_size)
    bigru = 2.0 * rows * 2 * _gru_macs(m.enc_rnn_size, m.enc_rnn_size)
    comp["enc_cbhg"] = bank + proj + dim_fix + highway + bigru

    # attention memory layer (hoisted out of the decode scan)
    mem_dim = 2 * m.enc_rnn_size
    comp["attention_keys"] = dense(rows, mem_dim, m.attention_size)

    # decoder scan (per step x steps)
    drows = B * steps
    pre_in = m.num_mels + mem_dim
    dec_prenet = 0.0
    din = pre_in
    for dout in m.dec_prenet_sizes:
        dec_prenet += dense(drows, din, dout)
        din = dout
    pre_out = m.dec_prenet_sizes[-1]
    if m.model_type == "simple" and m.num_speakers > 1:
        pre_out += m.speaker_embedding_size
    attn_rnn = 2.0 * drows * _gru_macs(pre_out, m.attention_state_size)
    # attention score: query proj + tanh(keys+q) @ v + context a @ values
    attn = (dense(drows, m.attention_state_size, m.attention_size)
            + dense(drows, t_in, m.attention_size)      # score reduce over U
            + dense(drows, t_in, mem_dim))              # context
    cat = m.attention_state_size + mem_dim
    if m.model_type == "simple" and m.num_speakers > 1:
        cat += m.speaker_embedding_size
    dec_proj = dense(drows, cat, m.dec_rnn_size)
    dec_grus = sum(2.0 * drows * _gru_macs(m.dec_rnn_size, m.dec_rnn_size)
                   for _ in range(m.dec_layer_num))
    frame_proj = dense(drows, m.dec_rnn_size, m.num_mels * r)
    comp["decoder"] = (dec_prenet + attn_rnn + attn + dec_proj + dec_grus
                       + frame_proj)

    # post CBHG over t_out frames
    prows = B * t_out
    K, C = m.post_bank_size, m.post_bank_channel_size
    bank = sum(dense(prows, k * m.num_mels, C) for k in range(1, K + 1))
    proj = 0.0
    pin = K * C
    for pout in m.post_proj_sizes:
        proj += dense(prows, m.post_proj_width * pin, pout)
        pin = pout
    hw_in = m.post_proj_sizes[-1]
    dim_fix = (dense(prows, hw_in, m.post_rnn_size)
               if hw_in != m.post_rnn_size else 0.0)
    highway = m.post_highway_depth * 2 * dense(prows, m.post_rnn_size,
                                               m.post_rnn_size)
    bigru = 2.0 * prows * 2 * _gru_macs(m.post_rnn_size, m.post_rnn_size)
    comp["post_cbhg"] = bank + proj + dim_fix + highway + bigru

    lin_in = 2 * m.post_rnn_size
    if m.model_type == "simple" and m.num_speakers > 1:
        lin_in += m.speaker_embedding_size
    comp["linear_head"] = dense(prows, lin_in, m.num_freq)

    comp["total"] = sum(comp.values())
    return comp


def sequential_scan_steps(config: Config, t_in: int, t_out: int) -> int:
    """Sequential loop iterations one forward pass executes: the fused
    fw/bw BiGRU scans run t iterations each (ops/rnn.py), the decoder
    t_out/r.  The backward pass replays each scan in reverse (same
    count).  This is the binding quantity at small batch: each step of a
    loop runs after the one before it, however little of the card it
    fills."""
    m = config.model
    enc = -(-t_in // max(1, m.rnn_unroll))
    dec = -(-(t_out // m.reduction_factor) // max(1, m.decoder_unroll))
    post = -(-t_out // max(1, m.rnn_unroll))
    return enc + dec + post


def train_step_model(config: Config, batch: int, t_in: int,
                     t_out: int) -> Dict[str, float]:
    """FLOPs, HBM bytes, and sequential-iteration counts for one
    forward+backward train step."""
    fwd = forward_flops(config, batch, t_in, t_out)
    total = 3.0 * fwd["total"]  # bwd = 2x fwd matmul FLOPs

    # parameter and optimizer memory traffic per step: read the params
    # (forward) + read them (backward) + gradients written and read + Adam
    # m/v read and written + params written
    from .state import create_model
    n_params = sum(p.numel() for p in create_model(config).parameters())
    param_bytes = 4 * n_params
    opt_traffic = 9 * param_bytes  # 2 reads + grad w+r + m/v r+w + write

    # major activations (f32), saved forward + re-read backward
    m = config.model
    act = batch * t_in * (m.embedding_size + sum(m.enc_prenet_sizes)
                          + m.enc_bank_size * m.enc_bank_channel_size
                          + sum(m.enc_proj_sizes)
                          + (2 + m.enc_highway_depth) * m.enc_rnn_size
                          + m.attention_size)
    steps = t_out // m.reduction_factor
    act += batch * steps * (sum(m.dec_prenet_sizes) + m.attention_state_size
                            + 2 * m.enc_rnn_size + t_in
                            + (1 + m.dec_layer_num) * m.dec_rnn_size
                            + m.num_mels * m.reduction_factor)
    act += batch * t_out * (m.post_bank_size * m.post_bank_channel_size
                            + sum(m.post_proj_sizes)
                            + (2 + m.post_highway_depth) * m.post_rnn_size
                            + m.num_freq)
    act_bytes = 4 * act * 2  # write forward, read backward

    return {
        "forward_flops": fwd["total"],
        "total_flops": total,
        "flops_by_component": fwd,
        "n_params": float(n_params),
        "hbm_bytes": float(opt_traffic + act_bytes),
        "sequential_iterations_fwd": float(
            sequential_scan_steps(config, t_in, t_out)),
        "sequential_iterations_total": float(
            2 * sequential_scan_steps(config, t_in, t_out)),
    }


def mfu(total_flops: float, step_seconds: float,
        peak_tflops: float = H100_FP32_PEAK_TFLOPS) -> float:
    """Model FLOP utilization (%) against ``peak_tflops`` (default the
    H100's float32 peak)."""
    return 100.0 * total_flops / step_seconds / (peak_tflops * 1e12)
