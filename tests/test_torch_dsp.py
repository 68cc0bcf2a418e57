"""DSP parity of the PyTorch port against the JAX package on the CPU.

Geometry: a small config where the fused engine applies (n_fft 256, hop
128, two hop chunks per frame), and the reference geometry (n_fft 2048,
hop 300) for the overlap-add.  The JAX side runs its Pallas kernels in
interpret mode, as its own tests do; the port's wrappers take their plain
versions on CPU tensors."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron_tpu.config import AudioConfig
from tacotron_tpu.dsp import chip as jchip
from tacotron_tpu.ops.pallas import gl_fused as jgl
from tacotron_tpu.ops.pallas import ola as jola
from tacotron_tpu.text import text_to_sequence as jax_text_to_sequence
from tacotron_tpu_torch.config import AudioConfig as TorchAudioConfig
from tacotron_tpu_torch.dsp import chip as tchip
from tacotron_tpu_torch.ops.kernels import gl_fused as tgl
from tacotron_tpu_torch.ops.kernels import ola as tola
from tacotron_tpu_torch.text import text_to_sequence

SMALL = dict(num_freq=129, sample_rate=16000, frame_shift_ms=8,
             frame_length_ms=16)


def configs(**kw):
    return AudioConfig(**SMALL, **kw), TorchAudioConfig(**SMALL, **kw)


def rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_gl_iteration_reference_matches_jax_kernel():
    """Plain K1 against the JAX fused iteration kernel (interpret mode) on
    the same signal blocks and magnitudes.  Both round to bf16 at the same
    points; only the f32 summation order differs, which can at most flip an
    isolated bf16 rounding (2^-8 of one spectrum value, diluted by the
    inverse DFT): 1e-4 of the peak."""
    jcfg, tcfg = configs()
    rng = np.random.default_rng(0)
    B, T = 2, 21
    Ta = -(-T // 8) * 8
    mag = np.pad(rng.random((B, T, 129)).astype(np.float32),
                 ((0, 0), (0, Ta - T), (0, 0)))
    je, jo = jgl.prepare_magnitudes(jnp.asarray(mag), jcfg.n_fft)
    te, to = tgl.prepare_magnitudes(torch.from_numpy(mag), tcfg.n_fft)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6)
    nba, _ = tgl.signal_blocks_layout(T, tcfg)
    assert (nba, _) == jgl.signal_blocks_layout(T, jcfg)
    sig = rng.standard_normal((B, nba, tcfg.hop_length)).astype(np.float32)

    want = jgl.gl_iteration(jnp.asarray(sig), je, jo, T, jcfg,
                            interpret=True)
    got = tgl.gl_iteration_reference(torch.from_numpy(sig), te, to, T, tcfg)
    assert rel_err(got, want) <= 1e-4
    # the wrapper takes the plain version for a CPU tensor
    before = tgl.gl_iteration.launches
    via = tgl.gl_iteration(torch.from_numpy(sig), te, to, T, tcfg)
    assert tgl.gl_iteration.launches == before
    torch.testing.assert_close(via, got, rtol=0, atol=0)

    y0 = tgl.initial_signal_blocks(te, to, T, tcfg)
    assert rel_err(y0, jgl.initial_signal_blocks(je, jo, T, jcfg)) <= 1e-5


@pytest.mark.parametrize("iters,tol", [(1, 1e-4), (3, 3e-3)])
def test_fused_engine_matches_jax(iters, tol):
    """The whole fused engine (zero-phase start, iterations, center slice)
    on the whole signal, edges included: both carry the same full-length
    layout.  One iteration agrees to 1e-4 of the peak, as above.  The
    compiled JAX loop drops some of the bf16 roundings (XLA's excess-
    precision rewrites) and later iterations amplify such isolated
    differences at low-magnitude bins, where the phase is ill-conditioned:
    3e-3 after three iterations, correlation above 0.9999."""
    jcfg, tcfg = configs(griffin_lim_impl="fused", griffin_lim_iters=iters)
    rng = np.random.default_rng(1)
    T = 21
    mag = rng.random((2, T, 129)).astype(np.float32)
    ns = (T - 1) * tcfg.hop_length
    assert tchip.resolve_engine(tcfg, T, "cpu") == "fused"
    want = np.asarray(jchip.griffin_lim_batched(jnp.asarray(mag), ns, jcfg))
    got = tchip.griffin_lim_batched(torch.from_numpy(mag), ns, tcfg).numpy()
    assert got.shape == want.shape
    assert rel_err(got, want) <= tol
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999


@pytest.mark.parametrize("B,T,block_tile", [(3, 25, 8), (2, 112, 16),
                                            (1, 12, 8)])
def test_overlap_add_reference_matches_jax_kernel(B, T, block_tile):
    """Plain K2 against the JAX overlap-add kernel (interpret mode) at the
    reference geometry, for stacks the kernel tiles and for the short stack
    it hands to XLA: atol 2e-6, as the JAX kernel's own test."""
    cfg = TorchAudioConfig()
    rng = np.random.default_rng(2)
    ns = (T - 1) * cfg.hop_length
    fr = rng.standard_normal((B, T, cfg.n_fft)).astype(np.float32)
    want = jola.overlap_add_batched(jnp.asarray(fr), ns, AudioConfig(),
                                    block_tile=block_tile, interpret=True)
    got = tola.overlap_add_reference(torch.from_numpy(fr), ns, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
    before = tola.overlap_add_batched.launches
    via = tola.overlap_add_batched(torch.from_numpy(fr), ns, cfg)
    assert tola.overlap_add_batched.launches == before
    torch.testing.assert_close(via, got, rtol=0, atol=0)


@pytest.mark.parametrize("engine,tol", [("matmul_half", 1e-3),
                                        ("fft", 1e-5)])
def test_other_engines_match_jax(engine, tol):
    """fft is float32 throughout: 1e-5 of the peak.  matmul_half rounds to
    bf16 where the compiled JAX engine does (see ``dsp/chip.py``); isolated
    rounding flips from f32 summation order, carried through three
    iterations: 1e-3 of the peak."""
    jcfg, tcfg = configs(griffin_lim_impl=engine, griffin_lim_iters=3)
    rng = np.random.default_rng(3)
    T = 21
    mag = rng.random((2, T, 129)).astype(np.float32)
    ns = (T - 1) * tcfg.hop_length
    want = np.asarray(jchip.griffin_lim_batched(jnp.asarray(mag), ns, jcfg))
    got = tchip.griffin_lim_batched(torch.from_numpy(mag), ns, tcfg).numpy()
    assert rel_err(got, want) <= tol
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999


def test_fused_supported_matches_jax():
    """The routing predicate equals JAX's over a grid of geometries and
    frame counts, including the 383/384 boundary at the reference
    geometry."""
    geometries = [{}, SMALL, dict(num_freq=1024),                 # n_fft%4
                  dict(num_freq=513, frame_shift_ms=2.5),          # K0 > 9
                  dict(num_freq=193, sample_rate=16000),           # M%128
                  dict(num_freq=257, sample_rate=16000,
                       frame_shift_ms=10, frame_length_ms=25)]
    for geo in geometries:
        jcfg, tcfg = AudioConfig(**geo), TorchAudioConfig(**geo)
        for n in (1, 24, 200, 382, 383, 384, 600, 2000):
            assert tgl.fused_supported(tcfg, n) == jgl.fused_supported(
                jcfg, n), (geo, n)
    assert tgl.max_fused_frames(2048) == 383
    ref = TorchAudioConfig()
    assert tgl.fused_supported(ref, 383) and not tgl.fused_supported(ref, 384)


def test_engine_dispatch():
    _, tcfg = configs()
    assert tchip.resolve_engine(tcfg, 21, "cpu") == "matmul_half"
    assert tchip.resolve_engine(tcfg, 21, "cuda") == "fused"
    ref = TorchAudioConfig()
    assert tchip.resolve_engine(ref, 383, "cuda") == "fused"
    assert tchip.resolve_engine(ref, 384, "cuda") == "matmul_half"
    for impl in ("matmul_bf16", "matmul_split", "pallas"):
        assert tchip.resolve_engine(
            dataclasses.replace(ref, griffin_lim_impl=impl), 10,
            "cpu") == impl
    with pytest.raises(ValueError):
        tchip.resolve_engine(dataclasses.replace(
            ref, griffin_lim_impl="matmul_bf16", ola_impl="pallas"), 10,
            "cpu")
    with pytest.raises(ValueError):
        tchip.resolve_engine(dataclasses.replace(ref, ola_impl="bogus"),
                             10, "cpu")
    with pytest.raises(ValueError):
        tchip.resolve_engine(dataclasses.replace(
            ref, griffin_lim_impl="fft", ola_impl="pallas"), 10, "cpu")


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on CUDA is refused, never
    computed by the plain version."""
    cfg = TorchAudioConfig()
    frames = torch.empty((1, 12, cfg.n_fft), device="meta")
    with pytest.raises(ValueError):
        tola.overlap_add_batched(frames, 100, cfg)
    sig = torch.empty((1, 24, cfg.hop_length), device="meta")
    with pytest.raises(ValueError):
        tgl.gl_iteration(sig, sig, sig, 12, cfg)


def test_inv_preemphasis_matches_jax():
    """FFT-domain FIR in float32 on both sides; the 1/(1-0.97 z^-1) filter
    amplifies up to 33x: 1e-5 of the peak."""
    jcfg, tcfg = configs()
    x = np.random.default_rng(4).standard_normal((2, 3000)).astype(
        np.float32)
    want = jax.vmap(lambda y: jchip.inv_preemphasis(y, jcfg))(jnp.asarray(x))
    got = tchip.inv_preemphasis(torch.from_numpy(x), tcfg)
    assert rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("engine", ["fused", "matmul_half"])
def test_batched_linear_to_waveform_matches_jax(engine):
    """The whole inversion chain (denormalize, dB -> amplitude, ** 1.5,
    three Griffin-Lim iterations, inverse pre-emphasis), held to the
    three-iteration bound of the fused engine above: 3e-3 of the peak,
    correlation above 0.9999."""
    tol = 3e-3
    jcfg, tcfg = configs(griffin_lim_impl=engine, griffin_lim_iters=3)
    spec = np.random.default_rng(5).random((2, 21, 129)).astype(np.float32)
    want = np.asarray(jchip.batched_linear_to_waveform(jnp.asarray(spec),
                                                       jcfg))
    got = tchip.batched_linear_to_waveform(torch.from_numpy(spec),
                                           tcfg).numpy()
    assert got.shape == want.shape == (2, 20 * tcfg.hop_length)
    assert rel_err(got, want) <= tol
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999


@pytest.mark.parametrize("text,cleaners,symbol_set", [
    ("안녕하세요. 만나서 반갑습니다!", ["korean_cleaners"], "korean"),
    ("오늘은 2024년 3월 5일, 기온은 12.5도입니다.", ["korean_cleaners"],
     "korean"),
    ("SNS에서 'AI' 음성을 들었어요?", ["korean_cleaners"], "korean"),
    ("Hello, world! It's 42 degrees.", ["english_cleaners"], "english"),
    ("Dr. Smith paid $3.50 on the 2nd.", ["english_cleaners"], "english"),
])
def test_frontend_ids_identical(text, cleaners, symbol_set):
    want = jax_text_to_sequence(text, cleaners, symbol_set=symbol_set)
    got = text_to_sequence(text, cleaners, symbol_set=symbol_set)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
