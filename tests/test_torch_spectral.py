"""The Griffin-Lim spectral step (K3) and the dense-matrix engines of the
PyTorch port against the JAX package on the CPU.

The JAX side runs its Pallas spectral-step kernel in interpret mode, as its
own tests do, and its engines as the compiled program (``jax.jit``): XLA
keeps or drops bf16 roundings by context, and the compiled program is what
runs.  The port's wrappers take their plain versions on CPU tensors."""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron_tpu.config import AudioConfig
from tacotron_tpu.dsp import chip as jchip
from tacotron_tpu.ops.pallas import griffin_lim as jgl
from tacotron_tpu_torch.config import AudioConfig as TorchAudioConfig
from tacotron_tpu_torch.dsp import chip as tchip
from tacotron_tpu_torch.ops.kernels import griffin_lim as tgl

SMALL = dict(num_freq=129, sample_rate=16000, frame_shift_ms=8,
             frame_length_ms=16)
# n_fft 254 (2 mod 4): the geometry matmul_half hands to matmul_bf16
ODD = dict(num_freq=128, sample_rate=16000, frame_shift_ms=8,
           frame_length_ms=15)


def rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("n_fft,rows", [(256, 70), (512, 70), (2048, 9)])
def test_spectral_step_reference_matches_jax(n_fft, rows):
    """Plain K3 against the JAX kernel (interpret mode, row tile 32, so 70
    rows leave a partial tile) and against JAX's plain version: both round
    the same bf16 inputs and spectra, and differ in f32 summation order
    only, which can flip isolated bf16 roundings: 2e-3 of the maximum."""
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((rows, n_fft)).astype(np.float32)
    mag = np.abs(rng.standard_normal((rows, n_fft // 2 + 1))).astype(
        np.float32)
    got = tgl.spectral_step_reference(torch.from_numpy(frames),
                                      torch.from_numpy(mag), n_fft).numpy()
    kernel = np.asarray(jgl.spectral_step(jnp.asarray(frames),
                                          jnp.asarray(mag), n_fft,
                                          row_tile=32, interpret=True))
    plain = np.asarray(jgl.spectral_step_reference(jnp.asarray(frames),
                                                   jnp.asarray(mag), n_fft))
    assert got.shape == kernel.shape == (rows, n_fft)
    assert rel_err(got, kernel) <= 2e-3
    assert rel_err(got, plain) <= 2e-3
    # the wrapper takes the plain version for a CPU tensor
    before = tgl.spectral_step.launches
    via = tgl.spectral_step(torch.from_numpy(frames), torch.from_numpy(mag),
                            n_fft)
    assert tgl.spectral_step.launches == before
    torch.testing.assert_close(via, torch.from_numpy(got), rtol=0, atol=0)


@pytest.mark.parametrize("n_fft", [256, 254, 2048])
def test_dft_matrices_match_jax(n_fft):
    """The dense matrices equal JAX's; the kernels' padded copies hold them
    in their leading block and zeros elsewhere."""
    for got, want in zip(tchip.dft_matrices(n_fft),
                         jchip._dft_matrices(n_fft)):
        np.testing.assert_array_equal(got, want)
    F = n_fft // 2 + 1
    dre, dim, ire, iim = tgl.padded_dft_matrices(n_fft)
    assert dre.shape[0] % tgl.TILE == 0 and dre.shape[1] % tgl.TILE == 0
    assert ire.shape == dre.shape[::-1]
    plain = tchip.dft_matrices(n_fft)
    for padded, want in zip((dre, dim, ire.T, iim.T),
                            (plain[0], plain[1], plain[2].T, plain[3].T)):
        np.testing.assert_array_equal(padded[:n_fft, :F], want)
        assert not padded[n_fft:].any() and not padded[:, F:].any()


def test_split_fft_matches_jax():
    """The two-stage DFT: both directions against JAX's on the same frames
    (the same bf16 roundings, compiled; 1e-5 of the peak), and the forward
    against numpy's FFT at bf16 accuracy (1e-2 of the peak)."""
    n_fft = 256
    rng = np.random.default_rng(7)
    frames = rng.standard_normal((12, n_fft)).astype(np.float32)
    re, im = tchip.split_fft(torch.from_numpy(frames), n_fft)
    jre, jim = jax.jit(lambda f: jchip._split_fft(f, n_fft))(
        jnp.asarray(frames))
    assert rel_err(re, jre) <= 1e-5 and rel_err(im, jim) <= 1e-5
    ref = np.fft.fft(frames, axis=-1)
    assert rel_err(re, ref.real) <= 1e-2 and rel_err(im, ref.imag) <= 1e-2
    back = tchip.split_ifft_real(re, im, n_fft)
    jback = jax.jit(lambda a, b: jchip._split_ifft_real(a, b, n_fft))(jre,
                                                                      jim)
    assert rel_err(back, jback) <= 1e-5
    assert rel_err(back, frames) <= 2e-2
    mag = rng.random((3, n_fft // 2 + 1)).astype(np.float32)
    np.testing.assert_array_equal(
        tchip.mirror_full_spectrum(torch.from_numpy(mag)).numpy(),
        np.asarray(jchip._mirror_full_spectrum(jnp.asarray(mag))))


# (engine, momentum) -> tolerance of the peak after three iterations.
# matmul_split and matmul_bf16 round exactly where the compiled JAX engines
# do; with momentum 0.99 the extrapolation step of the compiled loop rounds
# a last ulp differently, which flips isolated bf16 roundings of the next
# frames.  The "pallas" engine sums its inverse products over 128-bin tiles
# in JAX and in one pass in the port, which flips isolated bf16 roundings
# too; later iterations amplify them at low-magnitude bins, where the phase
# is ill-conditioned (the fused engine's 3e-3 of the same geometry).
ENGINE_TOLERANCE = {("matmul_split", 0.0): 1e-5, ("matmul_split", 0.99): 1e-5,
                    ("matmul_bf16", 0.0): 1e-5, ("matmul_bf16", 0.99): 1e-2,
                    ("pallas", 0.0): 2e-3, ("pallas", 0.99): 5e-3}


@pytest.mark.parametrize("engine,momentum", sorted(ENGINE_TOLERANCE))
def test_engine_matches_compiled_jax(engine, momentum):
    jcfg = AudioConfig(**SMALL, griffin_lim_impl=engine, griffin_lim_iters=3,
                       griffin_lim_momentum=momentum)
    tcfg = TorchAudioConfig(**SMALL, griffin_lim_impl=engine,
                            griffin_lim_iters=3,
                            griffin_lim_momentum=momentum)
    rng = np.random.default_rng(3)
    T = 21
    mag = rng.random((2, T, 129)).astype(np.float32)
    ns = (T - 1) * tcfg.hop_length
    assert tchip.resolve_engine(tcfg, T, "cpu") == engine
    want = np.asarray(jax.jit(
        lambda m: jchip.griffin_lim_batched(m, ns, jcfg))(jnp.asarray(mag)))
    got = tchip.griffin_lim_batched(torch.from_numpy(mag), ns, tcfg).numpy()
    assert got.shape == want.shape == (2, ns)
    assert rel_err(got, want) <= ENGINE_TOLERANCE[engine, momentum]
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999


@pytest.mark.parametrize("engine,half_start", [("matmul_half", False),
                                               ("pallas", False),
                                               ("pallas", True)])
def test_long_decode_engines_track_fft(engine, half_start):
    """The engines a decode past the fused engine's frame cap can run
    (matmul_half on the CPU; on CUDA the spectral-step engine from
    matmul_half's start, and as asked for explicitly from JAX's), each on
    its CPU path at the reference geometry, batch 2 x 400 frames, eight
    iterations: held to the strict float32 "fft" engine under the bound
    the repo holds its bf16 engines to (``tests/test_dsp.py``: correlation
    above 0.98, the waveform's scale within 5 %)."""
    base = TorchAudioConfig(griffin_lim_iters=8)
    B, T = 2, 400
    assert not tchip.gl_fused.fused_supported(base, T)
    mag = torch.from_numpy(np.random.default_rng(3).random(
        (B, T, base.num_freq)).astype(np.float32))
    ns = (T - 1) * base.hop_length
    want = tchip.griffin_lim_batched(
        mag, ns, dataclasses.replace(base, griffin_lim_impl="fft")).numpy()
    cfg = dataclasses.replace(base, griffin_lim_impl=engine)
    assert tchip.resolve_engine(cfg, T, "cpu") == engine
    got = (tchip._ENGINES["pallas_half"] if half_start
           else tchip.griffin_lim_batched)(mag, ns, cfg).numpy()
    assert got.shape == want.shape == (B, ns)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.98
    assert 0.95 < got.std() / want.std() < 1.05


def spectral_convergence(y, target, audio) -> float:
    """Mean over the utterances of || |STFT(y)| - S || / ||S||."""
    mag = torch.abs(tchip.stft(y, audio))
    return float((torch.linalg.vector_norm(mag - target, dim=(1, 2))
                  / torch.linalg.vector_norm(target, dim=(1, 2))).mean())


@pytest.mark.parametrize("seed", [0, 1])
def test_cuda_route_keeps_matmul_half_convergence_on_floor_frames(seed):
    """Past the fused engine's cap, "auto" on CUDA runs the spectral-step
    engine from matmul_half's zero-phase start ("pallas_half").  Reached
    through ``griffin_lim_batched`` with ``resolve_engine`` answering as on
    CUDA, on the CPU paths: two utterances of 400 frames, half of each a
    harmonic tone 80-90 dB under full scale and the rest the -100 dB floor
    (flat rows), eight iterations.  The route's spectral convergence stays
    within 5 % of matmul_half's (the engine it replaces there); from JAX's
    dense start, which adds one rounding pattern to every flat row, the
    same iteration misses that bound (by about 40 %)."""
    audio = TorchAudioConfig(griffin_lim_iters=8)
    B, T = 2, 400
    ns = (T - 1) * audio.hop_length
    rng = np.random.default_rng(seed)
    t = np.arange(ns) / audio.sample_rate
    wav = np.zeros((B, ns), np.float32)
    for b in range(B):
        f0 = rng.uniform(100, 220)
        tone = sum(np.sin(2 * np.pi * k * f0 * t + 6 * rng.random()) / k
                   for k in range(1, 30))
        lo = rng.integers(0, ns // 2)
        wav[b, lo:lo + ns // 2] = 0.3 * tone[lo:lo + ns // 2]
    spec = 0.1 * tchip.spectrogram(torch.from_numpy(wav), audio)[:, :T]
    assert float((spec.amax(-1) == 0).float().mean()) > 0.4
    target = tchip.db_to_amp(tchip.denormalize_db(spec, audio)
                             + audio.ref_level_db) ** audio.power

    resolve = tchip.resolve_engine
    with mock.patch.object(tchip, "resolve_engine",
                           lambda cfg, n, device: resolve(cfg, n, "cuda")):
        assert tchip.resolve_engine(audio, T, "cpu") == "pallas_half"
        route = tchip.griffin_lim_batched(target, ns, audio)
    sc = {"route": spectral_convergence(route, target, audio)}
    for engine in ("matmul_half", "pallas"):
        cfg = dataclasses.replace(audio, griffin_lim_impl=engine)
        sc[engine] = spectral_convergence(
            tchip.griffin_lim_batched(target, ns, cfg), target, audio)
    assert sc["route"] <= 1.05 * sc["matmul_half"], sc
    assert sc["pallas"] > 1.05 * sc["matmul_half"], sc


def test_odd_n_fft_reaches_matmul_bf16():
    """n_fft = 254 (2 mod 4): matmul_half hands over to matmul_bf16 in both
    packages.  The zero-phase start agrees to 1e-6 of the peak.  After one
    iteration JAX's own compiled and eager programs differ by ~3e-3 of the
    peak at this geometry (XLA rounds otherwise than at n_fft 256, where
    the port matches the compiled program to 1e-7); the port lies within
    3e-3 of both."""
    for iters, tol in ((0, 1e-6), (1, 3e-3)):
        jcfg = AudioConfig(**ODD, griffin_lim_impl="matmul_half",
                           griffin_lim_iters=iters)
        tcfg = TorchAudioConfig(**ODD, griffin_lim_impl="matmul_half",
                                griffin_lim_iters=iters)
        assert tcfg.n_fft == 254
        assert tchip.resolve_engine(tcfg, 21, "cpu") == "matmul_bf16"
        assert tchip.resolve_engine(tcfg, 21, "cuda") == "matmul_bf16"
        rng = np.random.default_rng(3)
        mag = rng.random((2, 21, 128)).astype(np.float32)
        ns = 20 * tcfg.hop_length
        want = np.asarray(jax.jit(
            lambda m: jchip.griffin_lim_batched(m, ns, jcfg))(
                jnp.asarray(mag)))
        with jax.disable_jit():
            eager = np.asarray(jchip.griffin_lim_batched(jnp.asarray(mag),
                                                         ns, jcfg))
        got = tchip.griffin_lim_batched(torch.from_numpy(mag), ns,
                                        tcfg).numpy()
        assert rel_err(got, want) <= tol and rel_err(got, eager) <= tol
        assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.99999


JAX_ENGINES = {"_griffin_lim_fused_batched": "fused",
               "_griffin_lim_half_batched": "matmul_half",
               "_griffin_lim_matmul": "matmul_bf16",
               "_griffin_lim_split_batched": "matmul_split",
               "_griffin_lim_pallas_batched": "pallas",
               "_griffin_lim_fft": "fft"}


def jax_engine(cfg, n_frames):
    """The engine JAX's dispatch runs for ``cfg`` on the CPU, found by
    replacing each engine with a recorder, or the exception it raises."""
    called = []

    def recorder(name):
        def run(magnitude, num_samples, config):
            called.append(name)
            return jnp.zeros(magnitude.shape[:-2] + (num_samples,))
        return run

    patches = [mock.patch.object(jchip, fn, recorder(name))
               for fn, name in JAX_ENGINES.items()]
    for p in patches:
        p.start()
    try:
        jchip.griffin_lim_batched(jnp.zeros((1, n_frames, cfg.num_freq)),
                                  (n_frames - 1) * cfg.hop_length, cfg)
    except (ValueError, AssertionError) as exc:
        return type(exc)
    finally:
        for p in patches:
            p.stop()
    return called[0]


@pytest.mark.parametrize("geometry", [SMALL, ODD, {}])
def test_dispatch_matches_jax(geometry):
    """Every engine name, with every overlap-add choice, resolves on the
    CPU to the engine JAX runs, and the configurations JAX refuses with
    ValueError raise ValueError in the port."""
    for impl in ("auto", "fused", "matmul_half", "matmul_bf16",
                 "matmul_split", "pallas", "fft", "bogus"):
        for ola in ("auto", "xla", "pallas", "bogus"):
            kw = dict(geometry, griffin_lim_impl=impl, ola_impl=ola)
            for n_frames in (21, 400):
                want = jax_engine(AudioConfig(**kw), n_frames)
                tcfg = TorchAudioConfig(**kw)
                if want is ValueError:
                    with pytest.raises(ValueError):
                        tchip.resolve_engine(tcfg, n_frames, "cpu")
                elif want is AssertionError:   # matmul_split, n_fft % 128
                    with pytest.raises(AssertionError):
                        tchip.griffin_lim_batched(
                            torch.zeros((1, n_frames, tcfg.num_freq)),
                            (n_frames - 1) * tcfg.hop_length, tcfg)
                else:
                    assert tchip.resolve_engine(tcfg, n_frames, "cpu") \
                        == want, (kw, n_frames)


def test_spectral_step_refuses_other_devices():
    frames = torch.empty((4, 256), device="meta")
    with pytest.raises(ValueError):
        tgl.spectral_step(frames, torch.empty((4, 129), device="meta"), 256)


def test_pallas_engine_on_cuda_resolution():
    """On CUDA, "auto" stays the fused engine and the explicit engines
    resolve as on the CPU."""
    ref = TorchAudioConfig()
    assert tchip.resolve_engine(ref, 200, "cuda") == "fused"
    for impl in ("pallas", "matmul_split", "matmul_bf16"):
        cfg = dataclasses.replace(ref, griffin_lim_impl=impl)
        assert tchip.resolve_engine(cfg, 200, "cuda") == impl
