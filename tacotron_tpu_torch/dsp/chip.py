"""On-device DSP in PyTorch: STFT, iSTFT, Griffin-Lim vocoding, and the
training targets (pre-emphasis, linear and mel spectrograms,
:func:`features_from_waveform`).

Counterpart of the JAX package's ``dsp/chip.py``, batched natively (every
function takes a leading batch axis where the JAX one was vmapped).  The
Griffin-Lim loop starts from zero phase and renews the phase as
``est / max(|est|, eps)``: deterministic, no random numbers.

Engines (``AudioConfig.griffin_lim_impl``):

- ``"fused"``: the carried full-length iteration of ``ops/kernels/gl_fused``
  (the CUDA kernel chain on a CUDA tensor);
- ``"matmul_half"``: u/v half-frame DFT as bf16 matrix products, with the
  overlap-add of ``ops/kernels/ola`` (the CUDA kernel on a CUDA tensor
  unless ``ola_impl="xla"``);
- ``"matmul_bf16"``: the dense DFT pair as bf16 matrix products, with the
  plain overlap-add (``ola_impl="pallas"`` is refused, as in JAX);
- ``"matmul_split"``: the two-stage (Cooley-Tukey) DFT as bf16 matrix
  products over the full spectrum, with the overlap-add of ``ops/kernels/ola``;
- ``"pallas"``: the spectral step of ``ops/kernels/griffin_lim`` (the CUDA
  kernel pair on a CUDA tensor), with the overlap-add of ``ops/kernels/ola``;
- ``"fft"``: strict float32 ``torch.fft``, the parity anchor.

``"auto"`` resolves to ``"fused"`` on CUDA and ``"matmul_half"`` on the CPU,
where the JAX package resolves to its Pallas kernels on the TPU and to
``"matmul_half"`` on the CPU.  ``"fused"`` routes decodes longer than
:func:`~tacotron_tpu_torch.ops.kernels.gl_fused.max_fused_frames` to
``"matmul_half"``, and ``"matmul_half"`` routes an ``n_fft`` that is not a
multiple of 4 to ``"matmul_bf16"``, as in JAX.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.kernels import gl_fused
from ..ops.kernels import griffin_lim as spectral
from ..ops.kernels.gl_fused import round_bf16
from ..ops.kernels.ola import (device_constant, overlap_add_batched,
                               overlap_add_reference, window_tensor)
from .primitives import inv_mel_basis, mel_basis


def num_frames(num_samples: int, config) -> int:
    """STFT frames of a ``num_samples`` signal (centered framing)."""
    return 1 + num_samples // config.hop_length


def frame_signal(y: torch.Tensor, config) -> torch.Tensor:
    """Centered (reflect-padded), windowed framing [B, S] ->
    [B, 1 + S // hop, n_fft] (librosa semantics)."""
    n_fft, hop = config.n_fft, config.hop_length
    padded = F.pad(y[:, None, :], (n_fft // 2, n_fft // 2),
                   mode="reflect")[:, 0]
    n_frames = 1 + y.shape[-1] // hop
    frames = padded.unfold(-1, n_fft, hop)[:, :n_frames]
    return frames * window_tensor(config, y.device)


def stft(y: torch.Tensor, config) -> torch.Tensor:
    """[B, S] -> complex64 [B, n_frames, n_freq]."""
    return torch.fft.rfft(frame_signal(y, config), dim=-1)


overlap_add = overlap_add_reference


def istft(spec: torch.Tensor, num_samples: int, config) -> torch.Tensor:
    """complex [B, n_frames, n_freq] -> [B, num_samples]."""
    frames = torch.fft.irfft(spec, n=config.n_fft, dim=-1)
    return overlap_add(frames, num_samples, config)


@functools.lru_cache(maxsize=4)
def dft_matrices(n_fft: int):
    """Real DFT and inverse DFT as dense matrices: forward [n_fft, F]
    cos/sin, so ``frames @ DFT`` is the rfft; inverse [F, n_fft] with the
    Hermitian weights folded in, so ``re @ IDFT_RE + im @ IDFT_IM`` is the
    irfft (F = n_fft // 2 + 1)."""
    F = n_fft // 2 + 1
    ang = -2.0 * np.pi * np.arange(n_fft)[:, None] * np.arange(F)[None, :] \
        / n_fft
    dft_re = np.cos(ang).astype(np.float32)
    dft_im = np.sin(ang).astype(np.float32)
    w = np.full(F, 2.0, np.float32)
    w[0] = w[-1] = 1.0
    ang2 = 2.0 * np.pi * np.arange(F)[:, None] * np.arange(n_fft)[None, :] \
        / n_fft
    idft_re = (w[:, None] * np.cos(ang2) / n_fft).astype(np.float32)
    idft_im = (w[:, None] * -np.sin(ang2) / n_fft).astype(np.float32)
    return dft_re, dft_im, idft_re, idft_im


def mirror_full_spectrum(mag: torch.Tensor) -> torch.Tensor:
    """[R, F = n_fft // 2 + 1] magnitudes -> Hermitian-extended [R, n_fft]."""
    return torch.cat([mag, mag.flip(-1)[:, 1:-1]], dim=-1)


@functools.lru_cache(maxsize=4)
def split_dft_matrices(n_fft: int, n1: int = 128) -> dict:
    """Two-stage (Cooley-Tukey) DFT factors for n_fft = n1 * n2: an
    [n1, n1] stage, an [n2, n1] twiddle and an [n2, n2] stage.  Index split:
    time n = n2 * i1 + i2, frequency k = k1 + n1 * k2.  The inverse factors
    carry the opposite sign, with 1 / n_fft folded into the last stage."""
    assert n_fft % n1 == 0, (n_fft, n1)
    n2 = n_fft // n1
    i1 = np.arange(n1)
    i2 = np.arange(n2)
    ang1 = -2.0 * np.pi * np.outer(i1, i1) / n1
    angt = -2.0 * np.pi * np.outer(i2, i1) / n_fft
    ang2 = -2.0 * np.pi * np.outer(i2, i2) / n2
    f32 = np.float32
    return {
        "n1": n1, "n2": n2,
        "c1_re": np.cos(ang1).astype(f32), "c1_im": np.sin(ang1).astype(f32),
        "tw_re": np.cos(angt).astype(f32), "tw_im": np.sin(angt).astype(f32),
        "c2_re": np.cos(ang2).astype(f32), "c2_im": np.sin(ang2).astype(f32),
        "ic1_re": np.cos(-ang1).astype(f32),
        "ic1_im": np.sin(-ang1).astype(f32),
        "itw_re": np.cos(-angt).astype(f32),
        "itw_im": np.sin(-angt).astype(f32),
        "ic2_re": (np.cos(-ang2) / n_fft).astype(f32),
        "ic2_im": (np.sin(-ang2) / n_fft).astype(f32),
    }


def _split_tensor(n_fft: int, key: str, device) -> torch.Tensor:
    """A split-DFT factor on ``device``: the stage matrices in bf16, the
    twiddles in f32."""
    def make():
        value = torch.as_tensor(split_dft_matrices(n_fft)[key])
        return value if "tw" in key else value.to(torch.bfloat16)
    return device_constant(("split", n_fft, key), make, device)


def _split_stage(ar, ai, tw_re, tw_im, R, n1, n2):
    """Twiddle [R, n2, n1] and regroup to [R * n1, n2] for the second
    stage."""
    br = (ar * tw_re - ai * tw_im).transpose(1, 2).reshape(R * n1, n2)
    bi = (ar * tw_im + ai * tw_re).transpose(1, 2).reshape(R * n1, n2)
    return br, bi


def split_fft(frames: torch.Tensor, n_fft: int):
    """Real [R, n_fft] -> full complex spectrum (re, im) [R, n_fft] through
    the two-stage matrix DFT, in natural bin order."""
    m = split_dft_matrices(n_fft)
    n1, n2 = m["n1"], m["n2"]
    R = frames.shape[0]
    c1_re, c1_im, tw_re, tw_im, c2_re, c2_im = (
        _split_tensor(n_fft, k, frames.device) for k in
        ("c1_re", "c1_im", "tw_re", "tw_im", "c2_re", "c2_im"))
    G = frames.reshape(R, n1, n2).transpose(1, 2).reshape(R * n2, n1)
    ar = bf16_matmul_f32(G, c1_re).reshape(R, n2, n1)
    ai = bf16_matmul_f32(G, c1_im).reshape(R, n2, n1)
    br, bi = _split_stage(ar, ai, tw_re, tw_im, R, n1, n2)
    xr = bf16_matmul_f32(br, c2_re) - bf16_matmul_f32(bi, c2_im)
    xi = bf16_matmul_f32(br, c2_im) + bf16_matmul_f32(bi, c2_re)
    xr = xr.reshape(R, n1, n2).transpose(1, 2).reshape(R, n_fft)
    xi = xi.reshape(R, n1, n2).transpose(1, 2).reshape(R, n_fft)
    return xr, xi


def split_ifft_real(xr: torch.Tensor, xi: torch.Tensor,
                    n_fft: int) -> torch.Tensor:
    """Full complex spectrum (re, im) [R, n_fft] -> the real part of its
    inverse DFT [R, n_fft] (exact for a Hermitian input)."""
    m = split_dft_matrices(n_fft)
    n1, n2 = m["n1"], m["n2"]
    R = xr.shape[0]
    ic1_re, ic1_im, itw_re, itw_im, ic2_re, ic2_im = (
        _split_tensor(n_fft, k, xr.device) for k in
        ("ic1_re", "ic1_im", "itw_re", "itw_im", "ic2_re", "ic2_im"))
    Gr = xr.reshape(R, n1, n2).transpose(1, 2).reshape(R * n2, n1)
    Gi = xi.reshape(R, n1, n2).transpose(1, 2).reshape(R * n2, n1)
    ar = (bf16_matmul_f32(Gr, ic1_re)
          - bf16_matmul_f32(Gi, ic1_im)).reshape(R, n2, n1)
    ai = (bf16_matmul_f32(Gr, ic1_im)
          + bf16_matmul_f32(Gi, ic1_re)).reshape(R, n2, n1)
    br, bi = _split_stage(ar, ai, itw_re, itw_im, R, n1, n2)
    y = bf16_matmul_f32(br, ic2_re) - bf16_matmul_f32(bi, ic2_im)
    return y.reshape(R, n1, n2).transpose(1, 2).reshape(R, n_fft)


@functools.lru_cache(maxsize=4)
def half_dft_matrices(n_fft: int):
    """Half-size decimation matrices of the "matmul_half" engine: forward
    (e_r, e_i, o_r, o_i) [M, M/2+1 | M/2] and inverse (iu_r, iu_i, iv_r,
    iv_i) with the Hermitian weights folded in."""
    assert n_fft % 4 == 0, n_fft
    M = n_fft // 2
    n = np.arange(M)[:, None]
    m = np.arange(M // 2 + 1)[None, :]
    p = np.arange(M // 2)[None, :]
    ang_e = 2.0 * np.pi * n * (2 * m) / n_fft
    ang_o = 2.0 * np.pi * n * (2 * p + 1) / n_fft
    w = np.full(M // 2 + 1, 2.0)
    w[0] = w[-1] = 1.0
    f32 = np.float32
    return (np.cos(ang_e).astype(f32), (-np.sin(ang_e)).astype(f32),
            np.cos(ang_o).astype(f32), (-np.sin(ang_o)).astype(f32),
            (w * np.cos(ang_e) / n_fft).T.astype(f32),
            (w * -np.sin(ang_e) / n_fft).T.astype(f32),
            (2.0 * np.cos(ang_o) / n_fft).T.astype(f32),
            (2.0 * -np.sin(ang_o) / n_fft).T.astype(f32))


def _half_matrix(n_fft: int, i: int, device) -> torch.Tensor:
    return device_constant(
        ("half", n_fft, i),
        lambda: torch.as_tensor(half_dft_matrices(n_fft)[i]).to(
            torch.bfloat16), device)


def bf16_matmul(a: torch.Tensor, b_bf16: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with both operands rounded to bf16, f32 accumulation and
    the result rounded to bf16 (returned as f32): a bf16 matrix product as
    the accelerators compute it.  On CUDA it is a bf16 product; on the CPU
    the same numbers come from an f32 product of the rounded operands."""
    if a.is_cuda:
        return (a.to(torch.bfloat16) @ b_bf16).float()
    return round_bf16(round_bf16(a) @ b_bf16.float())


def bf16_matmul_f32(a: torch.Tensor, b_bf16: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with both operands rounded to bf16 and the f32 result kept
    unrounded: what the JAX engine's ``(u @ e).astype(f32)`` compiles to
    (XLA folds the convert into the product).  An f32 product of the
    rounded operands is exact per term."""
    return round_bf16(a) @ b_bf16.float()


def dif_rfft(frames: torch.Tensor, n_fft: int):
    """Real [R, n_fft] -> rfft in split-bin layout (Xe_r, Xe_i, Xo_r, Xo_i):
    Xe = bins 0, 2, .., n_fft/2, Xo = bins 1, 3, .., n_fft/2 - 1."""
    M = n_fft // 2
    e_r, e_i, o_r, o_i = (_half_matrix(n_fft, i, frames.device)
                          for i in range(4))
    x1, x2 = frames[:, :M], frames[:, M:]
    u = x1 + x2
    v = x1 - x2
    return (bf16_matmul_f32(u, e_r), bf16_matmul_f32(u, e_i),
            bf16_matmul_f32(v, o_r), bf16_matmul_f32(v, o_i))


def dif_irfft(xe_r, xe_i, xo_r, xo_i, n_fft: int) -> torch.Tensor:
    """Split-bin rfft -> real [R, n_fft] frames.  Each product is rounded
    to bf16 and the pairs are summed in f32, which is what the JAX engine
    computes once compiled."""
    iu_r, iu_i, iv_r, iv_i = (_half_matrix(n_fft, i, xe_r.device)
                              for i in range(4, 8))
    u = bf16_matmul(xe_r, iu_r) + bf16_matmul(xe_i, iu_i)
    v = bf16_matmul(xo_r, iv_r) + bf16_matmul(xo_i, iv_i)
    return torch.cat([u + v, u - v], dim=1)


def _ola_fn(config, num_samples: int, device) -> Callable:
    """Overlap-add of the batched engines: the kernel when ``ola_impl`` is
    "pallas", or "auto" on CUDA; the plain version otherwise."""
    use_kernel = (config.ola_impl == "pallas"
                  or (config.ola_impl == "auto"
                      and torch.device(device).type == "cuda"))
    if use_kernel:
        return lambda fr: overlap_add_batched(fr, num_samples, config)
    return lambda fr: overlap_add_reference(fr, num_samples, config)


def gl_loop(gl_update: Callable, y0: torch.Tensor, config) -> torch.Tensor:
    """``griffin_lim_iters`` projection steps; with momentum a != 0 the fast
    Griffin-Lim ``t_n = P(y_n); y_{n+1} = t_n + a (t_n - t_{n-1})``."""
    alpha = float(config.griffin_lim_momentum)
    y = y0
    if alpha == 0.0:
        for _ in range(config.griffin_lim_iters):
            y = gl_update(y)
        return y
    t_prev = y0
    for _ in range(config.griffin_lim_iters):
        t = gl_update(y)
        y = t + alpha * (t - t_prev)
        t_prev = t
    return y


def _griffin_lim_half_batched(magnitude: torch.Tensor, num_samples: int,
                              config) -> torch.Tensor:
    B, T, _ = magnitude.shape
    n_fft = config.n_fft
    mag = magnitude.reshape(B * T, -1)
    mag_e, mag_o = mag[:, 0::2], mag[:, 1::2]
    ola = _ola_fn(config, num_samples, magnitude.device)

    frames0 = dif_irfft(mag_e, torch.zeros_like(mag_e),
                        mag_o, torch.zeros_like(mag_o), n_fft)
    y = ola(frames0.reshape(B, T, n_fft))

    def project(re, im, target):
        inv_amp = torch.rsqrt(torch.clamp(re * re + im * im, min=1e-16))
        return target * inv_amp * re, target * inv_amp * im

    def gl_update(y):
        frames = frame_signal(y, config).reshape(B * T, n_fft)
        er, ei, our, oui = dif_rfft(frames, n_fft)
        er, ei = project(er, ei, mag_e)
        our, oui = project(our, oui, mag_o)
        return ola(dif_irfft(er, ei, our, oui, n_fft).reshape(B, T, n_fft))

    return gl_loop(gl_update, y, config)


def _griffin_lim_fused_batched(magnitude: torch.Tensor, num_samples: int,
                               config) -> torch.Tensor:
    B, T, _ = magnitude.shape
    ta = gl_fused.frame_rows(T)
    magnitude = F.pad(magnitude, (0, 0, 0, ta - T))  # zero-magnitude rows
    mag_e_s, mag_o_s = gl_fused.prepare_magnitudes(magnitude, config.n_fft)
    y0 = gl_fused.initial_signal_blocks(mag_e_s, mag_o_s, T, config)
    sig = gl_loop(
        lambda s: gl_fused.gl_iteration(s, mag_e_s, mag_o_s, T, config),
        y0, config)
    return gl_fused.center_slice(sig, num_samples, config)


def _griffin_lim_matmul(magnitude: torch.Tensor, num_samples: int,
                        config) -> torch.Tensor:
    """The dense DFT pair as bf16 matrix products, with the JAX engine's own
    phase formula (``re / max(1e-8, |z|)``) and the plain overlap-add."""
    dft_re, dft_im, idft_re, idft_im = spectral.dft_tensors(
        config.n_fft, magnitude.device)

    def istft_mm(re, im):
        frames = bf16_matmul(re, idft_re) + bf16_matmul(im, idft_im)
        return overlap_add_reference(frames, num_samples, config)

    y = istft_mm(magnitude, torch.zeros_like(magnitude))

    def gl_update(y):
        frames = frame_signal(y, config)
        re = bf16_matmul(frames, dft_re)
        im = bf16_matmul(frames, dft_im)
        amp = torch.clamp(torch.sqrt(re * re + im * im), min=1e-8)
        return istft_mm(magnitude * re / amp, magnitude * im / amp)

    return gl_loop(gl_update, y, config)


def _griffin_lim_split_batched(magnitude: torch.Tensor, num_samples: int,
                               config) -> torch.Tensor:
    B, T, _ = magnitude.shape
    n_fft = config.n_fft
    mag_full = mirror_full_spectrum(magnitude.reshape(B * T, -1))
    ola = _ola_fn(config, num_samples, magnitude.device)

    # zero-phase start: the inverse of the real, Hermitian magnitudes
    frames0 = split_ifft_real(mag_full, torch.zeros_like(mag_full), n_fft)
    y = ola(frames0.reshape(B, T, n_fft))

    def gl_update(y):
        frames = frame_signal(y, config).reshape(B * T, n_fft)
        re, im = split_fft(frames, n_fft)
        inv_amp = torch.rsqrt(torch.clamp(re * re + im * im, min=1e-16))
        scale = mag_full * inv_amp
        new = split_ifft_real(re * scale, im * scale, n_fft)
        return ola(new.reshape(B, T, n_fft))

    return gl_loop(gl_update, y, config)


def _griffin_lim_pallas_batched(magnitude: torch.Tensor, num_samples: int,
                                config) -> torch.Tensor:
    """The spectral step of ``ops/kernels/griffin_lim`` on the whole batch's
    frames folded into one [B * T, n_fft] row matrix per iteration, with
    framing and the overlap-add around it."""
    B, T, _ = magnitude.shape
    n_fft = config.n_fft
    _, _, idft_re, _ = spectral.dft_tensors(n_fft, magnitude.device)
    mag_rows = magnitude.reshape(B * T, -1).contiguous()
    ola = _ola_fn(config, num_samples, magnitude.device)

    # zero-phase start: irfft(mag) == mag @ IDFT_RE
    frames0 = bf16_matmul_f32(mag_rows, idft_re)
    y = ola(frames0.reshape(B, T, n_fft))

    def gl_update(y):
        frames = frame_signal(y, config).reshape(B * T, n_fft)
        new = spectral.spectral_step(frames, mag_rows, n_fft)
        return ola(new.reshape(B, T, n_fft))

    return gl_loop(gl_update, y, config)


def _griffin_lim_fft(magnitude: torch.Tensor, num_samples: int,
                     config) -> torch.Tensor:
    S = magnitude.to(torch.complex64)
    y = istft(S, num_samples, config)

    def gl_update(y):
        est = stft(y, config)
        angles = est / torch.clamp(torch.abs(est), min=1e-8)
        return istft(S * angles, num_samples, config)

    return gl_loop(gl_update, y, config)


def resolve_engine(config, n_frames: int, device) -> str:
    """The engine :func:`griffin_lim_batched` runs for ``n_frames`` on
    ``device``."""
    if config.ola_impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown ola_impl {config.ola_impl!r} "
                         "(expected 'auto', 'pallas' or 'xla')")
    impl = config.griffin_lim_impl
    if impl == "auto":
        impl = ("fused" if torch.device(device).type == "cuda"
                else "matmul_half")
    if impl == "fused":
        if gl_fused.fused_supported(config, n_frames):
            return "fused"
        impl = "matmul_half"
    if impl == "matmul_half" and config.n_fft % 4 != 0:
        impl = "matmul_bf16"
    if impl in ("pallas", "matmul_split", "matmul_half"):
        return impl
    if impl not in ("matmul_bf16", "fft"):
        raise ValueError(f"unknown griffin_lim_impl {impl!r}")
    if config.ola_impl == "pallas":
        # the JAX engines are vmapped per item there and cannot take the
        # batched overlap-add kernel; the port refuses the same configs
        raise ValueError(
            f"ola_impl='pallas' is not supported by the '{impl}' engine "
            f"(use matmul_half/matmul_split/pallas, or ola_impl='auto'/'xla')")
    return impl


_ENGINES = {"fused": _griffin_lim_fused_batched,
            "matmul_half": _griffin_lim_half_batched,
            "matmul_bf16": _griffin_lim_matmul,
            "matmul_split": _griffin_lim_split_batched,
            "pallas": _griffin_lim_pallas_batched,
            "fft": _griffin_lim_fft}


def griffin_lim_batched(magnitude: torch.Tensor, num_samples: int,
                        config) -> torch.Tensor:
    """Phase reconstruction [B, n_frames, n_freq] -> [B, num_samples]."""
    impl = resolve_engine(config, magnitude.shape[1], magnitude.device)
    return _ENGINES[impl](magnitude, num_samples, config)


def griffin_lim(magnitude: torch.Tensor, num_samples: int,
                config) -> torch.Tensor:
    """One utterance [n_frames, n_freq] -> [num_samples]: a batch of one of
    :func:`griffin_lim_batched`."""
    return griffin_lim_batched(magnitude[None], num_samples, config)[0]


# ------------------------------------------------------------- scaling chain

@functools.lru_cache(maxsize=8)
def _inv_preemphasis_kernel(coef: float, length: int = 1500) -> np.ndarray:
    """Truncated impulse response of 1/(1 - coef z^-1); coef^1500 is far
    below float32 resolution for coef = 0.97."""
    return (coef ** np.arange(length)).astype(np.float32)


def inv_preemphasis(x: torch.Tensor, config) -> torch.Tensor:
    """Inverse pre-emphasis of [..., S] as an FFT-domain FIR."""
    if config.preemphasis == 0.0:
        return x
    kernel = _inv_preemphasis_kernel(config.preemphasis)
    n = x.shape[-1] + kernel.shape[0] - 1
    fft_len = 1 << (n - 1).bit_length()
    kernel_f = device_constant(
        ("preemph", config.preemphasis, fft_len),
        lambda: np.fft.rfft(kernel, fft_len).astype(np.complex64), x.device)
    y = torch.fft.irfft(torch.fft.rfft(x, fft_len, dim=-1) * kernel_f,
                        fft_len, dim=-1)
    return y[..., :x.shape[-1]].to(x.dtype)


def amp_to_db(x: torch.Tensor) -> torch.Tensor:
    return 20.0 * torch.log10(torch.clamp(x, min=1e-5))


def db_to_amp(x: torch.Tensor) -> torch.Tensor:
    return torch.pow(10.0, x * 0.05)


def normalize_db(S: torch.Tensor, config) -> torch.Tensor:
    return torch.clamp((S - config.min_level_db) / -config.min_level_db,
                       0, 1)


def denormalize_db(S: torch.Tensor, config) -> torch.Tensor:
    return torch.clamp(S, 0, 1) * -config.min_level_db + config.min_level_db


def preemphasis(x: torch.Tensor, config) -> torch.Tensor:
    """Pre-emphasis ``y[t] = x[t] - coef * x[t-1]`` of [..., S]."""
    return torch.cat(
        [x[..., :1], x[..., 1:] - config.preemphasis * x[..., :-1]], dim=-1)


# ----------------------------------------------------------------- features

def _mel_basis_t(config, device) -> torch.Tensor:
    """The mel filterbank transposed, [n_freq, n_mels], on ``device``."""
    return device_constant(
        ("mel_t", config.sample_rate, config.n_fft, config.num_mels),
        lambda: np.ascontiguousarray(mel_basis(
            config.sample_rate, config.n_fft, config.num_mels).T), device)


def _magnitude(y: torch.Tensor, config) -> torch.Tensor:
    """|STFT| of the pre-emphasized waveforms [N, S]: [N, T, n_freq]."""
    return torch.abs(stft(preemphasis(y, config), config))


def _linear(mag: torch.Tensor, config) -> torch.Tensor:
    return normalize_db(amp_to_db(mag) - config.ref_level_db, config)


def _mel(mag: torch.Tensor, config) -> torch.Tensor:
    return normalize_db(amp_to_db(mag @ _mel_basis_t(config, mag.device)),
                        config)


def spectrogram(y: torch.Tensor, config) -> torch.Tensor:
    """Waveforms [N, S] -> normalized linear spectrograms [N, T, n_freq]."""
    return _linear(_magnitude(y, config), config)


def melspectrogram(y: torch.Tensor, config) -> torch.Tensor:
    """Waveforms [N, S] -> normalized mel spectrograms [N, T, n_mels]."""
    return _mel(_magnitude(y, config), config)


def features_from_waveform(wavs: torch.Tensor, config):
    """Waveforms [N, S] float32 -> (linear [N, T, n_freq], mel [N, T,
    n_mels]) normalized targets, T = 1 + S // hop, from one shared STFT:
    the train step's on-device feature extraction (the feeder ships int16
    samples instead of spectrograms).  Frames whose window reaches into a
    waveform's zero-padded tail see zeros there, as in the JAX package."""
    mag = _magnitude(wavs, config)
    return _linear(mag, config), _mel(mag, config)


# ----------------------------------------------------------------- inversion

def batched_linear_to_waveform(specs: torch.Tensor, config) -> torch.Tensor:
    """Normalized linear spectrograms [B, n_frames, n_freq] -> waveforms
    [B, (n_frames - 1) * hop]: denormalize, dB -> amplitude, ``** power``,
    Griffin-Lim, inverse pre-emphasis."""
    n_frames = specs.shape[1]
    num_samples = (n_frames - 1) * config.hop_length
    S = db_to_amp(denormalize_db(specs, config) + config.ref_level_db)
    wavs = griffin_lim_batched(S ** config.power, num_samples, config)
    return inv_preemphasis(wavs, config)


def linear_to_waveform(spec: torch.Tensor, config) -> torch.Tensor:
    """One normalized linear spectrogram [n_frames, n_freq] -> waveform
    [(n_frames - 1) * hop]."""
    return batched_linear_to_waveform(spec[None], config)[0]


def mel_to_waveform(mel: torch.Tensor, config) -> torch.Tensor:
    """One normalized mel spectrogram [n_frames, n_mels] -> waveform
    [(n_frames - 1) * hop], through the pseudo-inverse of the filterbank."""
    num_samples = (mel.shape[0] - 1) * config.hop_length
    amp = db_to_amp(denormalize_db(mel, config))
    inv_basis_t = device_constant(
        ("inv_mel_t", config.sample_rate, config.n_fft, config.num_mels),
        lambda: np.ascontiguousarray(inv_mel_basis(
            config.sample_rate, config.n_fft, config.num_mels).T.astype(
                np.float32)), mel.device)
    S = torch.clamp(amp @ inv_basis_t, min=1e-10)
    y = griffin_lim(S ** config.power, num_samples, config)
    return inv_preemphasis(y, config)
