"""The benchmark's own copies held once against the port they were
written from: the frontend's ids, the variables' layout, the frozen
FLOP, byte and busy-time arithmetic."""


import numpy as np
import pytest

from perfbench import core, flops, trace
from perfbench.reference import weights
from perfbench.reference.frontend import text_to_ids
from perfbench.traffic import generate

from tacotron_tpu_torch.config import Config


def config(name):
    raw = core.load_json(core.HERE / "configs" / f"{name}.json")["config"]
    return raw, Config.from_dict(raw)


def test_frontend_matches_port():
    from tacotron_tpu_torch.text import text_to_sequence
    words = [w for ws in generate.word_pool().values() for w in ws]
    rng = np.random.default_rng(3)
    texts = words + [generate.sentence(rng, n) for n in range(4, 160, 3)]
    for text in texts:
        assert text_to_ids(text) == list(text_to_sequence(text)), text


@pytest.mark.parametrize("name", ["tacotron_son_single",
                                  "deepvoice2_son_park"])
def test_variables_match_port_layout(name):
    from tacotron_tpu_torch.params import flatten_variables, to_flax
    from tacotron_tpu_torch.train.state import create_model
    raw, cfg = config(name)
    model = create_model(cfg)
    port = {k: v.shape for k, v in
            flatten_variables(to_flax(model.state_dict())).items()}
    ours = {p: tuple(s) for p, s, _ in weights.variable_spec(raw["model"])}
    assert ours == port
    assert weights.count_parameters(raw["model"]) == sum(
        p.numel() for p in model.parameters())


def test_train_flops_match_port():
    from tacotron_tpu_torch.train.roofline import forward_flops, \
        train_step_model
    raw, cfg = config("deepvoice2_son_park")
    port = train_step_model(cfg, 16, 96, 448)
    assert flops.train_step_flops(raw["model"], 16, 96, 448) == \
        port["total_flops"]
    assert flops.forward_flops(raw["model"], 4, 64, 200) == \
        forward_flops(cfg, 4, 64, 200)


def test_k1_arithmetic_matches_port():
    from tacotron_tpu_torch.ops.kernels import gl_fused
    audio = Config().audio
    assert flops.gl_iteration_flops(16 * 200, audio.n_fft) == \
        gl_fused.iteration_flops(16 * 200, audio.n_fft)
    nba, out_len = gl_fused.signal_blocks_layout(200, audio)
    M = audio.n_fft // 2
    ne, no = M // 2 + 1, M // 2
    hop = audio.hop_length
    # chip_smoke.py's byte count of one iteration at B = 16, T = 200
    want = (2 * 16 * nba * hop * 4 + 16 * 200 * (ne + no) * 4
            + 2 * M * (ne + no) * 2 + audio.n_fft * 4 + nba * hop * 4)
    assert flops.k1_iteration_bytes(16, 200, audio.n_fft, hop) == want


def test_busy_matches_port():
    from tacotron_tpu_torch.synth.profile import busy_us
    rng = np.random.default_rng(0)
    starts = rng.uniform(0, 1000, 200)
    iv = [("k", s, s + d) for s, d in zip(starts, rng.uniform(0, 30, 200))]
    ours = sum(e - s for s, e in trace.union_us([(s, e) for _, s, e in iv]))
    assert ours == pytest.approx(busy_us(iv), abs=1e-9)


def test_summarize_idle_and_groups():
    dev = [("gl_dft_project_kernel", 10.0, 20.0),
           ("ampere_sgemm_64x64", 15.0, 30.0),
           ("ola_centered_blocks_kernel", 50.0, 60.0)]
    host = [("bench.window", 0.0, 100.0), ("bench.step", 30.0, 55.0)]
    s = trace.summarize(dev, host, (0.0, 100.0))
    assert s["busy_s"] == pytest.approx(30e-6)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["idle_s_by_span"] == pytest.approx(
        {"bench.window": 50e-6, "bench.step": 20e-6})
    assert set(s["device_s_by_group"]) == {
        "gl_dft_project", "matrix products (cuBLAS)", "ola_centered"}


def test_fast_vocoder_matches_port():
    from tacotron_tpu_torch.synth import Synthesizer
    raw, _ = config("tacotron_son_single")
    fast = generate.griffin_lim({"vocoder": "fast"}, raw["audio"])
    assert fast == (Synthesizer.FAST_GRIFFIN_LIM_ITERS,
                    Synthesizer.FAST_GRIFFIN_LIM_MOMENTUM)
    classic = generate.griffin_lim({"vocoder": "classic"}, raw["audio"])
    assert classic == (raw["audio"]["griffin_lim_iters"],
                       raw["audio"]["griffin_lim_momentum"])
