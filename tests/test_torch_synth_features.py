"""The serving features of the port's synthesizer against the JAX package's
on the CPU, same weights (``random_variables``), small widths
(``test_torch_synth``'s model, 129 bins, 3 Griffin-Lim iterations):

- the numpy helpers (``split_text``, ``attention_trim_index``,
  ``posthoc_attention``, ``attention_health``) give equal results on the
  same texts and arrays;
- ``synthesize`` with ``manual_attention_mode``, ``vocode="host"`` and
  ``"none"``, ``synthesize_robust`` and ``synthesize_long`` agree with the
  tolerances of ``test_synthesize_matches_jax``: equal ends, alignments and
  spectrograms within 5e-4 (the greedy-decode tolerance of the model
  test), waveforms correlated above 0.999 with a std ratio in
  [0.95, 1.05];
- ``collect_timings`` splits the call into phases that sum to the total;
- the single-utterance ``dsp/chip.py`` wrappers agree with JAX's within
  ``test_torch_dsp``'s bound for their engine (3e-3 of the peak,
  correlation above 0.9999).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron_tpu.dsp import chip as jchip
from tacotron_tpu.synth import synthesizer as jsynth
from tacotron_tpu.text import text_to_sequence as jax_text_to_sequence
from tacotron_tpu_torch.dsp import chip as tchip
from tacotron_tpu_torch.synth import synthesizer as tsynth
from test_torch_dsp import configs as audio_configs
from test_torch_dsp import rel_err
from test_torch_synth import _configs, _pair
from test_torch_params import random_variables

TEXTS = ["안녕하세요.", "반갑습니다 여러분", "음성 합성"]
SPEAKERS = [0, 1, 1]
STEPS = 8
# seed 8: every first-pass decode step of TEXTS has a top-two attention gap
# above 1e-3 (asserted below), so mode 1's argmax cannot flip between the
# packages
SEED = 8


@pytest.fixture(scope="module")
def pair():
    cfg, _ = _configs()
    return _pair(random_variables(cfg.model, SEED))


def _both(pair, **kw):
    js, ts = pair
    return js.synthesize(**kw), ts.synthesize(**kw)


def _assert_waveforms_close(want, got):
    assert len(got) == len(want)
    for wa, wb in zip(want, got):
        assert wb.shape == wa.shape
        assert wb.dtype == np.float32
        assert np.corrcoef(wa, wb)[0, 1] > 0.999
        assert 0.95 <= wb.std() / wa.std() <= 1.05


def _assert_alignments_close(want, got):
    assert len(got) == len(want)
    for aa, ab in zip(want, got):
        assert ab.shape == aa.shape
        np.testing.assert_allclose(ab, aa, atol=5e-4)


# ------------------------------------------------------------ numpy helpers

CLEANERS = ["korean_cleaners"]


def _ntok(text, cleaners=CLEANERS, symbol_set="korean"):
    return len(jax_text_to_sequence(text, cleaners, symbol_set=symbol_set))


@pytest.mark.parametrize("text,budget", [
    # the sentence and clause budgets of tests/test_synth.py
    ("안녕하세요. 반갑습니다! 오늘 날씨가 좋네요? 감사합니다.", 500),
    ("안녕하세요. 반갑습니다! 오늘 날씨가 좋네요? 감사합니다.", 30),
    ("하나, 둘, 셋, 넷, 다섯, 여섯, 일곱, 여덟.", 20),
    ("가나다라 마바사아 자차카타 파하가나 다라마바", 16),
    # never losing text
    ("버전 2.5를 사용하세요.", 500), ("버전 2.5를 사용하세요.", 20),
    ("끝...다음 문장이 이어집니다.", 500), ("끝...다음 문장이 이어집니다.", 20),
    ("그가 \"안녕하세요.\"라고 말했다. 그리고 떠났다.", 500),
    ("그가 \"안녕하세요.\"라고 말했다. 그리고 떠났다.", 20),
    ("쉼표,뒤에,공백이,없다", 500), ("쉼표,뒤에,공백이,없다", 20),
    ("마침표 없이 끝나는 문장", 500), ("마침표 없이 끝나는 문장", 20),
    # hard splits of an unbroken run
    ("가나다라마바사아자차카타파하" * 8, 20),
])
def test_split_text_matches_jax(text, budget):
    got = tsynth.split_text(text, budget, CLEANERS)
    assert got == jsynth.split_text(text, budget, CLEANERS)
    assert "".join(got).replace(" ", "") == text.replace(" ", "")
    if _ntok(text) <= budget:
        assert got == [text]
    else:
        assert len(got) >= 2 and all(_ntok(c) <= budget for c in got)


def test_split_text_english_matches_jax():
    text = ("Dr. Smith paid $3.50 on the 2nd. It rained, then it cleared; "
            "we walked home! Did you see it?")
    cleaners = ["english_cleaners"]
    for budget in (200, 30, 12):
        got = tsynth.split_text(text, budget, cleaners, symbol_set="english")
        assert got == jsynth.split_text(text, budget, cleaners,
                                        symbol_set="english")
        assert all(_ntok(c, cleaners, "english") <= budget for c in got)


def _random_alignments(seed, n=4, t_in=9, t_dec=12):
    rng = np.random.default_rng(seed)
    al = rng.random((n, t_in, t_dec)).astype(np.float32)
    al /= al.sum(axis=1, keepdims=True)
    al[1, :, 6:] = 0.0
    al[1, t_in - 1, 6:] = 1.0          # reaches the last token halfway
    # a diagonal sweep, then a decode stuck on one token
    al[2] = 0.0
    al[2, np.minimum(np.arange(t_dec) // 2, t_in - 1), np.arange(t_dec)] = 1
    al[3] = 0.0
    al[3, 2, :] = 1.0
    return al


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_attention_trim_index_matches_jax(seed):
    al = _random_alignments(seed)
    for seq_len in (1, 5, 9):
        for i in range(al.shape[0]):
            a = al[i, :seq_len]
            for r in (2, 4):
                assert tsynth.attention_trim_index(a, seq_len, r) == \
                    jsynth.attention_trim_index(a, seq_len, r)
    # the host loop equals the batched device version
    lengths = np.asarray([9, 9, 9, 9])
    want = [tsynth.attention_trim_index(a, 9, 4) for a in al]
    got = tsynth.attention_trim_frames(torch.from_numpy(al),
                                       torch.from_numpy(lengths), 4)
    assert got.tolist() == want


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_posthoc_attention_matches_jax(mode):
    al = _random_alignments(4)
    got = tsynth.posthoc_attention(al, mode)
    np.testing.assert_array_equal(got, jsynth.posthoc_attention(al, mode))
    assert got.shape == al.shape and got.dtype == al.dtype
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-6)


def test_posthoc_attention_unknown_mode_raises():
    with pytest.raises(ValueError, match="manual_attention_mode"):
        tsynth.posthoc_attention(_random_alignments(0), 4)


def _soft_bump(t_in=20, t_dec=40, sigma=4.0):
    """A wide bump whose center sweeps the diagonal."""
    pos = np.minimum(np.arange(t_dec) / 2.0, t_in - 1)
    grid = np.arange(t_in)[:, None]
    soft = np.exp(-0.5 * ((grid - pos[None, :]) / sigma) ** 2)
    return (soft / soft.sum(0, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("soft_monotonic", [False, True])
@pytest.mark.parametrize("which", ["random", "stuck", "diagonal", "soft",
                                   "single_step"])
def test_attention_health_matches_jax(which, soft_monotonic):
    al = {"random": _random_alignments(5)[0],
          "stuck": _random_alignments(5)[3],
          "diagonal": _random_alignments(5)[2],
          "soft": _soft_bump(),
          "single_step": _random_alignments(5)[0][:, :1]}[which]
    kw = dict(soft_monotonic=soft_monotonic, min_coverage=0.4)
    got = tsynth.attention_health(al, **kw)
    assert got == jsynth.attention_health(al, **kw)
    assert got["gate"] == ("soft_monotonic" if soft_monotonic
                           else "sharpness")
    assert got["ok"] == (got["ok_soft_monotonic"] if soft_monotonic
                         else got["ok_sharpness"])


def test_attention_health_soft_gate_rates_wide_attention():
    """A wide but travelling bump fails the sharpness gate and passes the
    soft-monotonic one; collapsed attention fails both."""
    h = tsynth.attention_health(_soft_bump())
    assert h["focus"] < 0.25 and h["path_coverage"] == 1.0
    assert not h["ok"]
    assert tsynth.attention_health(_soft_bump(), soft_monotonic=True)["ok"]
    collapsed = np.zeros((20, 12), np.float32)
    collapsed[2] = 1.0             # the whole decode on one token of 20
    stuck = tsynth.attention_health(collapsed, soft_monotonic=True)
    assert not stuck["ok_sharpness"] and not stuck["ok_soft_monotonic"]


# -------------------------------------------------------------- synthesize

def _first_pass_gaps(pair):
    """The smallest top-two attention gap over every decode step of JAX's
    first pass."""
    want, _ = _both(pair, texts=TEXTS, speaker_ids=SPEAKERS,
                    max_steps=STEPS, vocode="none")
    gaps = []
    for al in want["alignments"]:
        top = np.sort(al, axis=0)
        gaps.append(float((top[-1] - top[-2]).min()))
    return min(gaps)


@pytest.mark.parametrize("mode", [1, 2])
def test_manual_attention_mode_matches_jax(pair, mode):
    """Two passes on both sides: the decode, its post-hoc alignments, and
    the decode with them as manual alignments."""
    if mode == 1:   # argmax ties could flip the one-hot between packages
        assert _first_pass_gaps(pair) > 1e-3
    want, got = _both(pair, texts=TEXTS, speaker_ids=SPEAKERS,
                      max_steps=STEPS, librosa_trim=False,
                      manual_attention_mode=mode)
    hop = pair[1].config.audio.hop_length
    assert [w.size for w in got["wavs"]] == [e * hop for e in got["ends"]]
    _assert_waveforms_close(want["wavs"], got["wavs"])
    _assert_alignments_close(want["alignments"], got["alignments"])
    if mode == 1:   # the second pass attends exactly where it was told
        for al in got["alignments"]:
            assert set(np.unique(al)) <= {0.0, 1.0}


def test_vocode_host_matches_jax(pair):
    want, got = _both(pair, texts=TEXTS, speaker_ids=SPEAKERS,
                      max_steps=STEPS, vocode="host", librosa_trim=False)
    assert got["ends"] == [len(s) for s in got["linear"]]
    assert [len(s) for s in got["linear"]] == [len(s) for s in
                                               want["linear"]]
    for sa, sb in zip(want["linear"], got["linear"]):
        np.testing.assert_allclose(sb, sa, atol=5e-4)
    _assert_alignments_close(want["alignments"], got["alignments"])
    _assert_waveforms_close(want["wavs"], got["wavs"])


def test_vocode_none_matches_jax(pair):
    want, got = _both(pair, texts=TEXTS, speaker_ids=SPEAKERS,
                      max_steps=STEPS, vocode="none", attention_trim=False)
    n_frames = STEPS * pair[1].config.model.reduction_factor
    assert got["ends"] == [n_frames] * len(TEXTS)
    for sa, sb in zip(want["linear"], got["linear"]):
        assert sb.shape == sa.shape == (n_frames,
                                        pair[1].config.audio.num_freq)
        np.testing.assert_allclose(sb, sa, atol=5e-4)
    assert all(w.shape == (0,) and w.dtype == np.float32
               for w in got["wavs"])


def test_host_and_chip_trim_alike(pair):
    """The host trim (``attention_trim_index``) and the chip trim
    (``attention_trim_frames``) cut the same frames."""
    _, ts = pair
    kw = dict(texts=TEXTS, speaker_ids=SPEAKERS, max_steps=STEPS,
              librosa_trim=False)
    assert ts.synthesize(vocode="none", **kw)["ends"] == \
        ts.synthesize(**kw)["ends"]


#: gates chosen so that, on the fixture's first pass, utterance 1 fails the
#: soft-monotonic gate (path coverage 0.227 < 0.3) and 0 and 2 pass it
HEALTH = dict(min_coverage=0.3, soft_monotonic=True)
GATES = {"coverage": "min_coverage", "focus": "min_focus",
         "monotonicity": "min_monotonicity", "path_coverage": "min_coverage"}


def test_synthesize_robust_matches_jax(pair):
    js, ts = pair
    kw = dict(texts=TEXTS, speaker_ids=SPEAKERS, max_steps=STEPS,
              librosa_trim=False, retry_mode=1, health_kwargs=HEALTH)
    want = js.synthesize_robust(**kw)
    # every gate metric of JAX's first pass is 1e-2 or more from its
    # threshold, and every token's peak from the coverage threshold, so
    # no verdict can flip between the packages
    defaults = dict(min_coverage=0.5, min_focus=0.25, min_monotonicity=0.6,
                    coverage_threshold=0.2)
    thresholds = dict(defaults, **HEALTH)
    first, _ = _both(pair, texts=TEXTS, speaker_ids=SPEAKERS,
                     max_steps=STEPS, librosa_trim=False)
    for h, al in zip(want["attention_health"], first["alignments"]):
        for metric, gate in GATES.items():
            assert abs(h[metric] - thresholds[gate]) >= 1e-2, (metric, h)
        assert np.abs(al.max(axis=1) - 0.2).min() >= 1e-4
    assert want["retried"] == [1]

    got = ts.synthesize_robust(**kw)
    assert got["retried"] == want["retried"]
    for ha, hb in zip(want["attention_health"], got["attention_health"]):
        assert {k: v for k, v in hb.items() if not isinstance(v, float)} \
            == {k: v for k, v in ha.items() if not isinstance(v, float)}
        for k, v in ha.items():
            if isinstance(v, float):
                assert abs(hb[k] - v) <= 1e-3, k
    _assert_waveforms_close(want["wavs"], got["wavs"])
    _assert_alignments_close(want["alignments"], got["alignments"])
    hop = ts.config.audio.hop_length
    assert [w.size for w in got["wavs"]] == [e * hop for e in got["ends"]]
    # the retried utterance attends one-hot (mode 1)
    assert set(np.unique(got["alignments"][1])) <= {0.0, 1.0}


def test_synthesize_robust_diagnoses_without_retry(pair):
    _, ts = pair
    res = ts.synthesize_robust(texts=TEXTS, speaker_ids=SPEAKERS,
                               max_steps=STEPS, retry_mode=0,
                               health_kwargs=HEALTH)
    assert res["retried"] == []
    assert [h["ok"] for h in res["attention_health"]] == [True, False, True]
    with pytest.raises(ValueError, match="manual_attention_mode"):
        ts.synthesize_robust(texts=TEXTS, manual_attention_mode=1)


LONG_TEXT = "안녕하세요. 반갑습니다 여러분, 음성 합성을 시험합니다."


def test_synthesize_long_matches_jax(pair):
    js, ts = pair
    kw = dict(speaker_id=1, max_chunk_tokens=16, robust=False,
              max_steps=STEPS, librosa_trim=False, gap_sentence_ms=100.0,
              gap_clause_ms=50.0)
    want = js.synthesize_long(LONG_TEXT, **kw)
    got = ts.synthesize_long(LONG_TEXT, **kw)
    assert got["chunks"] == want["chunks"]
    assert len(got["chunks"]) >= 3
    assert got["wav"].shape == want["wav"].shape
    assert np.corrcoef(got["wav"], want["wav"])[0, 1] > 0.999
    # the pieces plus one gap per boundary: sentence-final punctuation
    # gets the sentence gap, a clause split the clause gap
    sr = ts.config.audio.sample_rate
    gaps = [int(sr * (0.1 if c.rstrip()[-1] in ".!?" else 0.05))
            for c in got["chunks"][:-1]]
    assert len(got["wav"]) == sum(len(w) for w in got["parts"]["wavs"]) \
        + sum(gaps)
    n0 = len(got["parts"]["wavs"][0])
    np.testing.assert_array_equal(got["wav"][n0:n0 + gaps[0]], 0.0)
    assert abs(got["wav"][0]) < 1e-6 and abs(got["wav"][-1]) < 1e-6


def test_synthesize_long_robust_routes_through_retry(pair):
    _, ts = pair
    out = ts.synthesize_long(LONG_TEXT, max_chunk_tokens=16,
                             max_steps=STEPS, fade_ms=0.0,
                             health_kwargs=HEALTH)
    assert "retried" in out["parts"] and "attention_health" in out["parts"]
    raw = out["parts"]["wavs"]
    np.testing.assert_array_equal(out["wav"][:len(raw[0])], raw[0])


@pytest.mark.parametrize("manual", [0, 1])
def test_collect_timings(pair, manual):
    _, ts = pair
    res = ts.synthesize(texts=TEXTS, speaker_ids=SPEAKERS, max_steps=STEPS,
                        manual_attention_mode=manual, collect_timings=True)
    t = res["timings"]
    assert set(t) == {"frontend_ms", "dispatch_ms", "device_ms",
                      "fetch_ms", "post_ms", "total_ms"}
    assert all(v >= 0.0 for v in t.values())
    parts = (t["frontend_ms"] + t["dispatch_ms"] + t["device_ms"]
             + t["fetch_ms"] + t["post_ms"])
    assert abs(parts - t["total_ms"]) < 1.0
    assert "timings" not in ts.synthesize(texts=TEXTS[:1], max_steps=2,
                                          vocode="none",
                                          collect_timings=True)


def test_wire_format_applies_to_chip_only(pair):
    _, ts = pair
    for vocode in ("host", "none"):
        with pytest.raises(ValueError, match="chip path"):
            ts.synthesize(texts=TEXTS[:1], max_steps=2, vocode=vocode,
                          wire_format="mulaw8")
    with pytest.raises(ValueError, match="vocode"):
        ts.synthesize(texts=TEXTS[:1], max_steps=2, vocode="gpu")


# ---------------------------------------------------- single-utterance DSP

@pytest.mark.parametrize("engine", ["fused", "matmul_half"])
@pytest.mark.parametrize("what", ["griffin_lim", "linear", "mel"])
def test_chip_wrappers_match_jax(engine, what):
    """The batch-of-one wrappers, held to test_torch_dsp's bound for three
    iterations of either engine: 3e-3 of the peak, correlation above
    0.9999."""
    jcfg, tcfg = audio_configs(griffin_lim_impl=engine, griffin_lim_iters=3)
    rng = np.random.default_rng(6)
    T = 21
    if what == "griffin_lim":
        x = rng.random((T, tcfg.num_freq)).astype(np.float32)
        ns = (T - 1) * tcfg.hop_length
        want = jchip.griffin_lim(jnp.asarray(x), ns, jcfg)
        got = tchip.griffin_lim(torch.from_numpy(x), ns, tcfg)
    elif what == "linear":
        x = rng.random((T, tcfg.num_freq)).astype(np.float32)
        want = jchip.linear_to_waveform(jnp.asarray(x), jcfg)
        got = tchip.linear_to_waveform(torch.from_numpy(x), tcfg)
    else:
        x = rng.random((T, tcfg.num_mels)).astype(np.float32)
        want = jchip.mel_to_waveform(jnp.asarray(x), jcfg)
        got = tchip.mel_to_waveform(torch.from_numpy(x), tcfg)
    want, got = np.asarray(want), got.numpy()
    assert got.shape == want.shape == ((T - 1) * tcfg.hop_length,)
    assert rel_err(got, want) <= 3e-3
    assert np.corrcoef(got, want)[0, 1] > 0.9999


def test_num_frames_matches_jax():
    jcfg, tcfg = audio_configs()
    for n in (0, 1, 127, 128, 129, 2560, 12345):
        assert tchip.num_frames(n, tcfg) == jchip.num_frames(n, jcfg)
