"""Tacotron 2 in the port (``models/tacotron2.py``) at small widths on the
CPU: against the plain reference of ``tests/ref_tacotron2.py`` (one text
at a time, unpadded, ``torch.nn.LSTM``), padding and row invariance, the
prenet's dropout rule, the decode-budget ladder, the stop-gate trim, the
configuration's refusals, the benchmark family's layout and reference,
and a replayed ``synthesize`` against the eager one."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from ref_tacotron2 import Tacotron2Reference, keep_masks, mel_basis
from tacotron_tpu_torch.config import AudioConfig, Config, ModelConfig
from tacotron_tpu_torch.models import tacotron2 as t2
from tacotron_tpu_torch.params import flatten_variables, to_flax
from tacotron_tpu_torch.synth import synthesizer as tsynth

MODEL = dict(architecture="tacotron2", embedding_size=24, attention_size=12,
             dec_prenet_sizes=(16, 16), reduction_factor=1, max_iters=16,
             steps_per_token=1.0, num_mels=10, num_freq=129,
             t2_enc_conv_channels=20, t2_enc_lstm_size=10,
             t2_attention_lstm_size=32, t2_decoder_lstm_size=28,
             t2_location_filters=6, t2_location_width=7,
             t2_postnet_channels=18)
AUDIO = dict(num_mels=10, num_freq=129, sample_rate=16000, frame_shift_ms=8,
             frame_length_ms=16, griffin_lim_iters=3)
TEXTS = ["안녕하세요.", "반갑습니다 여러분", "음성 합성"]
STEPS = 16


def _config(**model) -> Config:
    return Config(model=ModelConfig(**dict(MODEL, **model)),
                  audio=AudioConfig(**AUDIO))


@pytest.fixture(scope="module")
def synth():
    return tsynth.Synthesizer(device="cpu").init_random(_config(), seed=3)


def _variables(s):
    return flatten_variables(to_flax(s.model.state_dict()))


def _reference(s):
    m = dataclasses.asdict(s.config.model)
    return Tacotron2Reference(_variables(s), m,
                              dataclasses.asdict(s.config.audio))


def _batch(s, texts, bucket=32):
    seqs = [tsynth.text_to_sequence(t, s.cleaner_names()) for t in texts]
    ids = torch.zeros((len(seqs), bucket), dtype=torch.int64)
    for i, q in enumerate(seqs):
        ids[i, :len(q)] = torch.as_tensor(q)
    return ids, torch.as_tensor([len(q) for q in seqs])


def test_port_matches_reference(synth):
    """The batched, padded decode against the reference's one text at a
    time over 16 steps.  Float32 throughout; the two sum their products
    in other orders (batched GEMMs and one fused LSTM cell against
    ``torch.nn.LSTM``, stacked location features against ``F.conv1d``),
    a few ulps a step that 16 recurrent steps carry: alignments (in
    [0, 1]) and stop logits (~1) within 2e-6, the post-net's mel within
    1e-5, and the moments (sums over ~1e3 values) within 1e-5 of
    themselves.  The normalized linear spectrogram (in [0, 1]) within
    2e-4: in the bins where the pseudo-inverse's product cancels to
    ~1e-4 of the unit-scale amplitudes, float32's ~1e-7 absolute error of
    that product is ~1e-3 relative, which the dB scale (8.7 dB per unit
    of relative error, over the 100 dB range) turns into ~1e-4."""
    ids, lengths = _batch(synth, TEXTS)
    out = synth._forward(ids, lengths, None, None, torch.tensor(False),
                         STEPS)
    ref = _reference(synth).infer(ids, lengths, None, STEPS)
    torch.testing.assert_close(out["alignments"], ref["alignments"],
                               atol=2e-6, rtol=0)
    torch.testing.assert_close(out["stop_logits"], ref["stop_logits"],
                               atol=2e-6, rtol=0)
    torch.testing.assert_close(out["mel_outputs"], ref["mel_outputs"],
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(out["linear_outputs"], ref["linear_outputs"],
                               atol=2e-4, rtol=0)
    res = synth.synthesize(TEXTS, max_steps=STEPS, attention_trim=False,
                           librosa_trim=False)
    moments = torch.as_tensor(np.stack(res["spec_moments"])).double()
    torch.testing.assert_close(moments, ref["spec_moments"], atol=0,
                               rtol=1e-5)
    for got, want in zip(res["stop_logits"], ref["stop_logits"]):
        np.testing.assert_allclose(got, want.numpy(), atol=2e-6, rtol=0)


def test_padding_and_row_invariance(synth):
    """One text in buckets 32 and 64, in row 0 of one batch and row 3 of
    another: the same outputs, to float32's rounding of GEMMs over other
    batch shapes (1e-6; the linear spectrogram 2e-4, for the dB scale's
    gain in the bins of the pseudo-inverse's cancellation, as in
    :func:`test_port_matches_reference`)."""
    text = TEXTS[1]
    a_ids, a_len = _batch(synth, [text], bucket=32)
    b_ids, b_len = _batch(synth, TEXTS + [text], bucket=64)
    a = synth._forward(a_ids, a_len, None, None, torch.tensor(False), STEPS)
    b = synth._forward(b_ids, b_len, None, None, torch.tensor(False), STEPS)
    n = int(a_len[0])
    for key, atol in (("stop_logits", 1e-6), ("mel_outputs", 1e-6),
                      ("linear_outputs", 2e-4)):
        torch.testing.assert_close(a[key][0], b[key][3], atol=atol, rtol=0)
    torch.testing.assert_close(a["alignments"][0, :n],
                               b["alignments"][3, :n], atol=1e-6, rtol=0)
    assert float(b["alignments"][3, n:].abs().max()) == 0.0


def test_dropout_mask_rule():
    """The port's masks bit for bit against the reference's, kept at half
    the units (0.5 +- 0.02 over 200 steps x 256 units), other at every
    step and for every text."""
    texts = [[5, 9, 30, 1], [5, 9, 31, 1], [7, 1], list(range(2, 80)) + [1]]
    ids = torch.zeros((len(texts), 96), dtype=torch.int64)
    for i, q in enumerate(texts):
        ids[i, :len(q)] = torch.as_tensor(q)
    lengths = torch.as_tensor([len(q) for q in texts])
    sizes = (256, 128)
    port = t2.prenet_keep_masks(ids, lengths, 200, sizes)
    for i, q in enumerate(texts):
        ref = keep_masks(q, 200, sizes)
        for layer in range(2):
            assert np.array_equal(port[layer][:, i].numpy(), ref[layer])
    keep = (port[0] > 0).float()
    assert set(torch.unique(port[0]).tolist()) == {0.0, 2.0}
    assert abs(float(keep.mean()) - 0.5) < 0.02
    for i in range(len(texts)):
        assert abs(float(keep[:, i].mean()) - 0.5) < 0.02
        assert not torch.equal(keep[0, i], keep[1, i])
    for i in range(1, len(texts)):
        assert not torch.equal(keep[:, 0], keep[:, i])
    # padding and the row do not enter: the same text in a wider bucket
    wide = torch.zeros((1, 160), dtype=torch.int64)
    wide[0, :4] = torch.as_tensor(texts[0])
    alone = t2.prenet_keep_masks(wide, lengths[:1], 200, sizes)
    assert torch.equal(alone[1][:, 0], port[1][:, 0])


@pytest.mark.parametrize("max_iters", [80, 150, 200, 300, 1000])
def test_budget_ladder(max_iters):
    """Tacotron's rungs are the old ladder's at every r and max_iters;
    Tacotron 2's (r = 1) run 200-800 frames, then max_iters."""
    old = (50, 100, 150, 200)
    assert tsynth.STEP_LADDER == old
    for r in (1, 2, 4, 5):
        tacotron = ModelConfig(reduction_factor=r, max_iters=max_iters)
        assert tsynth.step_ladder(tacotron) == old
        for n in (1, 10, 13, 30, 40, 50, 80, 500):
            assert tsynth.adaptive_max_steps(
                n, 30, max_iters, ladder=tsynth.step_ladder(tacotron)) == \
                tsynth.adaptive_max_steps(n, 30, max_iters, ladder=old)
    assert tsynth.step_ladder(_config().model) == (200, 400, 600, 800)
    assert tsynth.step_ladder(
        _config(reduction_factor=2).model) == (100, 200, 300, 400)
    cfg = _config(max_iters=1000, steps_per_token=8.0)
    rungs = tsynth.prewarm_step_rungs(cfg, [32, 64, 128])
    assert rungs == {32: [200, 400], 64: [400, 600], 128: [600, 800, 1000]}
    s = tsynth.Synthesizer(device="cpu")
    s.config = cfg
    assert s._budget([120], None, 32) == (128, 1000)
    assert s._budget([40], None, 32) == (64, 400)


def test_gate_trim_frames():
    """The cut is through the first step whose gate exceeds 0.5 (at least
    one), every step when none does, times r."""
    logits = torch.tensor([[-3.0, -1.0, 0.5, -2.0, 4.0],
                           [2.0, -1.0, -1.0, -1.0, -1.0],
                           [-1.0, -1.0, -1.0, -1.0, -1.0],
                           [-1.0, 0.0, -1.0, -1.0, 1e-3]])
    assert tsynth.gate_trim_frames(logits, 0.5, 1).tolist() == [3, 1, 5, 5]
    assert tsynth.gate_trim_frames(logits, 0.5, 2).tolist() == [6, 2, 10, 10]


def test_gate_trim_in_synthesize(synth):
    res = synth.synthesize(TEXTS, max_steps=STEPS, attention_trim=True,
                           librosa_trim=False)
    want = tsynth.gate_trim_frames(
        torch.as_tensor(np.stack(res["stop_logits"])), 0.5, 1).tolist()
    assert res["ends"] == want
    host = synth.synthesize(TEXTS, max_steps=STEPS, attention_trim=True,
                            vocode="none")
    assert host["ends"] == want
    np.testing.assert_allclose(np.stack(host["spec_moments"]),
                               np.stack(res["spec_moments"]), rtol=1e-5)


def test_refusals():
    """Tacotron 2 is single-speaker, float32 and not trained here; each
    refusal says why.  A Tacotron configuration's JSON keeps only
    Tacotron's fields; a Tacotron 2 one round-trips."""
    with pytest.raises(ValueError, match="single-speaker"):
        _config(num_speakers=2, model_type="deepvoice")
    with pytest.raises(ValueError, match="float32 only"):
        _config(compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="architecture"):
        ModelConfig(architecture="wavenet")
    from tacotron_tpu_torch.train.step import make_train_step
    with pytest.raises(ValueError, match="inference only"):
        make_train_step(_config())
    cfg = _config()
    assert Config.from_json(cfg.to_json()) == cfg
    plain = json.loads(Config().to_json())["model"]
    assert "architecture" not in plain
    assert not [k for k in plain if k.startswith("t2_")]
    assert Config.from_dict(json.loads(Config().to_json())) == Config()


def test_family_matches_module_layout():
    """The benchmark family's variables are the module's state, path for
    path and shape for shape, at the configuration's full widths, and the
    program loads them."""
    from perfbench import core
    from perfbench.families import tacotron2 as family
    raw = core.load_json(core.HERE / "configs"
                         / "tacotron2_ko_single.json")["config"]
    cfg = Config.from_dict(raw)
    model = t2.Tacotron2(cfg.model, cfg.audio)
    port = {k: tuple(v.shape) for k, v in
            flatten_variables(to_flax(model.state_dict())).items()}
    spec = {p: tuple(s) for p, s, _ in family.variable_spec(raw["model"])}
    assert spec == port
    assert sum(p.numel() for p in model.parameters()) == 28158337


def test_bench_reference_agrees(synth):
    """``perfbench/reference/tacotron2.py`` (batched, every product one
    ``mm``) against this directory's reference on the same weights:
    float32 in other orders, the tolerances of the port's test."""
    from perfbench.reference import tacotron2 as bench
    ids, lengths = _batch(synth, TEXTS)
    v = {k: torch.as_tensor(a) for k, a in _variables(synth).items()}
    m = dataclasses.asdict(synth.config.model)
    m["dec_prenet_sizes"] = list(m["dec_prenet_sizes"])
    ours = bench.Reference(v, m, dataclasses.asdict(synth.config.audio))
    got = ours.infer(ids, lengths, None, STEPS)
    want = _reference(synth).infer(ids, lengths, None, STEPS)
    for key, atol in (("alignments", 2e-6), ("stop_logits", 2e-6),
                      ("mel_outputs", 1e-5), ("linear_outputs", 2e-4)):
        torch.testing.assert_close(got[key], want[key], atol=atol, rtol=0)
    torch.testing.assert_close(got["spec_moments"], want["spec_moments"],
                               atol=0, rtol=1e-5)
    assert np.array_equal(bench.mel_basis(16000, 256, 10),
                          mel_basis(16000, 256, 10)) or np.allclose(
        bench.mel_basis(16000, 256, 10), mel_basis(16000, 256, 10),
        atol=1e-7)
    from tacotron_tpu_torch.dsp.primitives import mel_basis as port_basis
    np.testing.assert_allclose(mel_basis(16000, 256, 10),
                               port_basis(16000, 256, 10), atol=1e-7)


def test_replay_equals_eager(synth):
    """A prewarmed call replays (on the CPU: the function on the static
    buffers) bit for bit the eager call, its stop logits and moments
    too, and times the decode's split phases."""
    kw = dict(max_steps=STEPS, attention_trim=False, librosa_trim=False)
    eager = synth.synthesize(TEXTS, **kw)
    synth.prewarm(**synth.prewarm_args(TEXTS, max_steps=STEPS,
                                       attention_trim=False))
    replayed = synth.synthesize(TEXTS, collect_timings=True, **kw)
    assert replayed["timings"]["chunks_replayed"] == 1
    for key in ("wavs", "stop_logits", "spec_moments", "ends"):
        for a, b in zip(eager[key], replayed[key]):
            assert np.array_equal(a, b), key
    t = replayed["timings"]
    assert t["encoder_device_ms"] + t["decoder_device_ms"] \
        + t["postnet_device_ms"] == pytest.approx(t["decode_device_ms"])
