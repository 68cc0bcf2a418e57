"""The Tacotron 2 family and its cell: ``t2_offline_long`` resolves to its
files and family, the family's FLOP counts against counts written out by
hand, the step's weight bytes, the three new readers on hand-built runs (nothing where their data
is missing), ``field_gaps``, and the cell's driver on the CPU at small
widths, whose reference passes the program."""

import copy

import numpy as np
import pytest
import torch

from perfbench import core, flops
from perfbench.families import tacotron2 as family
from perfbench.tests import small

CELL = "t2_offline_long"


def _model():
    cell = core.find_cell(CELL)
    return cell.config["config"]["model"]


def test_cell_resolves_to_its_family():
    cell = core.find_cell(CELL)
    assert cell.kind == "offline"
    assert cell.config["family"] == "tacotron2"
    assert core.family(cell.config).__file__ == family.__file__
    assert set(cell.limits["limits"]) == {
        "align_gap", "wave_gap", "length_mismatch", "stop_gap", "spec_gap"}
    assert not hasattr(family, "TRAIN_REFERENCE")
    m = cell.config["config"]["model"]
    assert family.frames_per_step(m) == 1
    # 120 tokens at 8 a token: 960 steps, past the ladder's 800: the cap
    assert family.decode_budget(cell.config["config"], 120) == 1000
    assert family.decode_budget(cell.config["config"], 40) == 400
    assert family.decode_budget(cell.config["config"], 1) == 200
    names = {m["name"] for m in cell.metrics_for(True)}
    assert {"synth.decoder_step_us.offline", "synth.postnet_device_ms.offline",
            "t2.decoder_step.roofline_pct.offline"} <= names


def test_flops_by_hand():
    """0.61 GFLOP a step at 16 rows over 128 tokens: the two LSTMs' 570
    MFLOP and the rest."""
    m = _model()
    rows, t_in = 16, 128
    step = 2 * rows * (
        80 * 256 + 256 * 256                       # prenet
        + (256 + 512 + 1024) * 4096                # attention LSTM
        + 1024 * 128                               # query
        + t_in * 31 * 2 * 32 + t_in * 32 * 128     # location features
        + t_in * 128 + t_in * 512                  # v, context
        + (1024 + 512 + 1024) * 4096               # decoder LSTM
        + (1024 + 512) * 81)                       # frames and gate
    assert family.decoder_step_flops(m, rows, t_in) == step
    assert 0.60e9 < step < 0.62e9
    tokens, frames = 4 * 96, 4 * 500
    encoder = 2 * tokens * (5 * 512 * 512 * 3 + 2 * (512 + 256) * 1024
                            + 512 * 128)
    postnet = 2 * frames * 5 * (80 * 512 + 3 * 512 * 512 + 512 * 80)
    want = (encoder + 500 * family.decoder_step_flops(m, 4, 96) + postnet
            + 2 * frames * 80 * 1025)
    assert family.forward_flops(m, 4, 96, 500) == want


def test_step_bytes_by_hand():
    """72.8 MB a step: the two LSTMs' 71.4 MB (kernels and both biases)
    and the other layers of the step, not the memory layer."""
    weights = (80 * 256 + 256 * 256                   # prenet
               + (256 + 512 + 1024) * 4096 + 2 * 4096  # attention LSTM
               + 1024 * 128 + 31 * 2 * 32 + 32 * 128 + 128   # attention
               + (1024 + 512 + 1024) * 4096 + 2 * 4096  # decoder LSTM
               + (1024 + 512) * 81 + 81)                # frames and gate
    assert family.decoder_step_bytes(_model()) == 4 * weights
    assert 72.7e6 < 4 * weights < 72.9e6


def _run(units, traced=()):
    cell = core.find_cell(CELL)
    run = core.Run("offline", cell.config, cell.traffic)
    run.units = [dict(u, traced=i in traced) for i, u in enumerate(units)]
    run.traced = list(traced)
    return run


def test_decoder_step_and_postnet_readers():
    units = [{"steps": 1000, "chunks": 2, "decoder_device_ms": 400.0,
              "postnet_device_ms": 10.0},
             {"steps": 1000, "chunks": 2, "decoder_device_ms": 360.0,
              "postnet_device_ms": 8.0},
             {"steps": 1000, "chunks": 2, "decoder_device_ms": 9e9,
              "postnet_device_ms": 9e9}]
    run = _run(units, traced=[2])
    read = core.metric_reader
    assert read("synth.decoder_step_us.offline")(run) == pytest.approx(190.0)
    assert read("synth.postnet_device_ms.offline")(run) == pytest.approx(9.0)
    roofline = read("t2.decoder_step.roofline_pct.offline")(run)
    # the weight bytes at the HBM peak take longer than the FLOPs
    step_s = family.decoder_step_bytes(_model()) / flops.PEAK_BYTES
    assert step_s > (family.decoder_step_flops(_model(), 16, 128)
                     / flops.PEAK_F32_FLOPS)
    assert roofline == pytest.approx(100.0 * step_s / 190e-6)
    assert 0.0 < roofline < 100.0
    # the parent's units, or a --trace 0 run's, carry no such keys
    bare = _run([{"steps": 1000, "chunks": 2, "wall_s": 1.0}])
    for name in ("synth.decoder_step_us.offline",
                 "synth.postnet_device_ms.offline",
                 "t2.decoder_step.roofline_pct.offline"):
        assert read(name)(bare) is None
    assert read("synth.decoder_step_us.offline")(
        _run(units, traced=[0, 1, 2])) is None
    # Tacotron's family has no decoder_step_flops
    t1 = _run(units, traced=[2])
    t1.config = core.find_cell("single_offline_long").config
    assert read("t2.decoder_step.roofline_pct.offline")(t1) is None
    assert read("synth.decoder_step_us.offline")(t1) == pytest.approx(190.0)


def test_field_gaps():
    rows = [{"stop_logits": torch.tensor([0.1, -2.0, 3.0]),
             "spec_moments": torch.tensor([10.0, 4.0], dtype=torch.float64)}
            for _ in range(2)]
    items = [{k: v.numpy().copy() for k, v in r.items()} for r in rows]
    assert family.field_gaps(items, rows) == {"stop_gap": 0.0,
                                              "spec_gap": 0.0}
    items[1]["stop_logits"][2] += 0.25
    items[0]["spec_moments"][1] = 4.02
    gaps = family.field_gaps(items, rows)
    assert gaps["stop_gap"] == pytest.approx(0.25)
    assert gaps["spec_gap"] == pytest.approx(0.005)
    items[0]["stop_logits"] = np.zeros(2, np.float32)
    assert family.field_gaps(items, rows)["stop_gap"] == float("inf")


def test_variables_are_seeded():
    m = copy.deepcopy(_model())
    a = family.make_variables(m, 2 ** 33 + 5, small.CPU)
    b = family.make_variables(m, 2 ** 33 + 5, small.CPU)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["params/decoder/attention_rnn/hidden/kernel"]
    assert float(w.abs().max()) <= 1.0 / 32.0
    assert float(a["batch_stats/postnet/conv_5_bn/BatchNorm_0/var"].min()) \
        == 1.0


def test_cell_on_the_cpu():
    """The cell's driver at small widths: the program's numbers pass the
    limits, the control's fail the decode's."""
    cell = core.find_cell(CELL)
    m = cell.config["config"]["model"]
    m.update(embedding_size=32, attention_size=8, dec_prenet_sizes=[16, 16],
             t2_enc_conv_channels=32, t2_enc_lstm_size=16,
             t2_attention_lstm_size=32, t2_decoder_lstm_size=32,
             t2_location_filters=4, t2_postnet_channels=32, num_freq=257,
             max_iters=120, steps_per_token=1.0)
    cell.config["config"]["audio"].update(num_freq=257, frame_length_ms=20.0,
                                          frame_shift_ms=5.0)
    cell.traffic.update(texts_per_call=3, check_sample=2, trace_seconds=0.1,
                        tokens=[20, 40])
    out = small.run(cell, small.args(seconds=0.2, control=True), None)
    assert all(c["ok"] for c in out.checks), out.checks
    control = out.control["tf32_fp8"]
    assert control["align_gap"] > cell.limits["limits"]["align_gap"]
    assert control["stop_gap"] > cell.limits["limits"]["stop_gap"]
    assert out.units[0]["steps"] == 120
