"""The yardstick's arithmetic, frozen: the card's peaks, the model's
matrix-product FLOPs (the port's ``train/roofline.py``), the fused
Griffin-Lim iteration's operations and bytes (K1, the port's
``ops/kernels/gl_fused.py::iteration_flops`` and ``chip_smoke.py``'s byte
count), the spectral step's operations and bytes (K3, ``chip_smoke.py``)
and the overlap-add's bytes (K2, ``chip_smoke.py``).

Conventions: 1 multiply-add = 2 FLOPs; a training step's backward is twice
its forward's matrix products; elementwise work is left out.
"""

from __future__ import annotations

from typing import Dict

# Published peaks of one NVIDIA H100 SXM (dense, at its 700 W limit)
PEAK_F32_FLOPS = 67e12      # float32 outside the tensor cores (TF32 off)
PEAK_BF16_FLOPS = 989e12    # bf16 tensor cores
PEAK_BYTES = 3.35e12        # HBM3


def _gru_macs(in_dim: int, units: int) -> int:
    return (in_dim + units) * 2 * units + (in_dim + units) * units


def forward_flops(m: dict, batch: int, t_in: int, t_out: int
                  ) -> Dict[str, float]:
    """Matrix-product FLOPs of one forward over ``t_in`` tokens and
    ``t_out`` frames (teacher-forced or greedy alike), by component."""
    r = m["reduction_factor"]
    steps = t_out // r
    B = batch
    simple = m["model_type"] == "simple" and m["num_speakers"] > 1

    def dense(rows, din, dout):
        return 2.0 * rows * din * dout

    comp: Dict[str, float] = {}
    rows = B * t_in
    din = m["embedding_size"]
    enc_prenet = 0.0
    for dout in m["enc_prenet_sizes"]:
        enc_prenet += dense(rows, din, dout)
        din = dout
    comp["enc_prenet"] = enc_prenet

    cin = m["enc_prenet_sizes"][-1]
    K, C = m["enc_bank_size"], m["enc_bank_channel_size"]
    bank = sum(dense(rows, k * cin, C) for k in range(1, K + 1))
    proj, pin = 0.0, K * C
    for pout in m["enc_proj_sizes"]:
        proj += dense(rows, m["enc_proj_width"] * pin, pout)
        pin = pout
    hw_in = m["enc_proj_sizes"][-1]
    units = m["enc_rnn_size"]
    dim_fix = dense(rows, hw_in, units) if hw_in != units else 0.0
    highway = m["enc_highway_depth"] * 2 * dense(rows, units, units)
    bigru = 2.0 * rows * 2 * _gru_macs(units, units)
    comp["enc_cbhg"] = bank + proj + dim_fix + highway + bigru

    mem_dim = 2 * units
    comp["attention_keys"] = dense(rows, mem_dim, m["attention_size"])

    drows = B * steps
    dec_prenet, din = 0.0, m["num_mels"] + mem_dim
    for dout in m["dec_prenet_sizes"]:
        dec_prenet += dense(drows, din, dout)
        din = dout
    pre_out = m["dec_prenet_sizes"][-1] + (m["speaker_embedding_size"]
                                           if simple else 0)
    attn_rnn = 2.0 * drows * _gru_macs(pre_out, m["attention_state_size"])
    attn = (dense(drows, m["attention_state_size"], m["attention_size"])
            + dense(drows, t_in, m["attention_size"])
            + dense(drows, t_in, mem_dim))
    cat = m["attention_state_size"] + mem_dim + (
        m["speaker_embedding_size"] if simple else 0)
    dec_proj = dense(drows, cat, m["dec_rnn_size"])
    dec_grus = sum(2.0 * drows * _gru_macs(m["dec_rnn_size"],
                                           m["dec_rnn_size"])
                   for _ in range(m["dec_layer_num"]))
    frame_proj = dense(drows, m["dec_rnn_size"], m["num_mels"] * r)
    comp["decoder"] = (dec_prenet + attn_rnn + attn + dec_proj + dec_grus
                       + frame_proj)

    prows = B * t_out
    K, C = m["post_bank_size"], m["post_bank_channel_size"]
    bank = sum(dense(prows, k * m["num_mels"], C) for k in range(1, K + 1))
    proj, pin = 0.0, K * C
    for pout in m["post_proj_sizes"]:
        proj += dense(prows, m["post_proj_width"] * pin, pout)
        pin = pout
    hw_in = m["post_proj_sizes"][-1]
    units = m["post_rnn_size"]
    dim_fix = dense(prows, hw_in, units) if hw_in != units else 0.0
    highway = m["post_highway_depth"] * 2 * dense(prows, units, units)
    bigru = 2.0 * prows * 2 * _gru_macs(units, units)
    comp["post_cbhg"] = bank + proj + dim_fix + highway + bigru
    lin_in = 2 * units + (m["speaker_embedding_size"] if simple else 0)
    comp["linear_head"] = dense(prows, lin_in, m["num_freq"])
    comp["total"] = sum(comp.values())
    return comp


def train_step_flops(m: dict, batch: int, t_in: int, t_out: int) -> float:
    """Forward plus backward (twice the forward) matrix-product FLOPs of
    one training step at the padded shape."""
    return 3.0 * forward_flops(m, batch, t_in, t_out)["total"]


def gl_iteration_flops(rows: int, n_fft: int) -> float:
    """Matrix-product FLOPs of one half-size Griffin-Lim iteration over
    ``rows`` frames: u against the even bins, v against the odd, and the
    two inverses."""
    M = n_fft // 2
    ne, no = M // 2 + 1, M // 2
    return 8.0 * rows * M * (ne + no)


def k1_iteration_bytes(batch: int, n_frames: int, n_fft: int,
                       hop: int) -> float:
    """Bytes one fused iteration (K1) must move at least: the carried
    signal in and out, the target magnitudes, the bf16 DFT matrices, the
    window and the normalizer."""
    M = n_fft // 2
    ne, no = M // 2 + 1, M // 2
    k0 = -(-n_fft // hop)
    out_len = n_fft + hop * (n_frames - 1)
    ta = -(-n_frames // 8) * 8
    nba = -(-max(-(-out_len // hop), ta + k0 - 1) // 8) * 8
    return (2 * batch * nba * hop * 4 + batch * n_frames * (ne + no) * 4
            + 2 * M * (ne + no) * 2 + n_fft * 4 + nba * hop * 4)


def k1_iteration_seconds(batch: int, n_frames: int, n_fft: int,
                         hop: int) -> float:
    """The least time of one K1 iteration on the card: the larger of its
    operations at the bf16 peak and its bytes at the HBM peak."""
    return max(gl_iteration_flops(batch * n_frames, n_fft) / PEAK_BF16_FLOPS,
               k1_iteration_bytes(batch, n_frames, n_fft, hop) / PEAK_BYTES)


def k3_iteration_flops(rows: int, n_fft: int) -> float:
    """Matrix-product FLOPs of one spectral step (K3) over ``rows`` frames:
    the two forward DFT products and the two inverses over the n_fft / 2 + 1
    bins (the kernels' bin padding is not counted); 13.4 GFLOP at 800 x
    2048."""
    return 8.0 * rows * n_fft * (n_fft // 2 + 1)


def k3_iteration_bytes(rows: int, n_fft: int) -> float:
    """Bytes one spectral step must move at least: the frames and the
    target magnitudes in, the four bf16 DFT matrices, the new frames
    out."""
    F = n_fft // 2 + 1
    return (rows * n_fft * 4 + rows * F * 4 + 4 * n_fft * F * 2
            + rows * n_fft * 4)


def k3_iteration_seconds(rows: int, n_fft: int) -> float:
    """The least time of one K3 step on the card: the larger of its
    operations at the bf16 peak and its bytes at the HBM peak."""
    return max(k3_iteration_flops(rows, n_fft) / PEAK_BF16_FLOPS,
               k3_iteration_bytes(rows, n_fft) / PEAK_BYTES)


def k2_call_bytes(batch: int, n_frames: int, n_fft: int, hop: int) -> float:
    """Bytes one overlap-add (K2) must move: the frames in, the signal
    out, the window and the normalizer."""
    num_samples = (n_frames - 1) * hop
    out_len = n_fft + hop * (n_frames - 1)
    return (batch * n_frames * n_fft * 4 + batch * num_samples * 4
            + n_fft * 4 + out_len * 4)


def k2_call_seconds(batch: int, n_frames: int, n_fft: int, hop: int
                    ) -> float:
    flops = 2.0 * batch * n_frames * n_fft + batch * (n_frames - 1) * hop
    return max(flops / PEAK_F32_FLOPS,
               k2_call_bytes(batch, n_frames, n_fft, hop) / PEAK_BYTES)
