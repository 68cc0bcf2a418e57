"""The Griffin-Lim spectral step: the CUDA kernels (``csrc/griffin_lim.cu``)
and their plain PyTorch version.

Replaces the TPU kernel ``ops/pallas/griffin_lim.py::spectral_step`` (body
``_kernel``) of the JAX package, the inner step of the ``"pallas"``
Griffin-Lim engine.  On frames [rows, n_fft] and target magnitudes
[rows, F = n_fft // 2 + 1] it computes

    re, im   = frames @ DFT_RE, frames @ DFT_IM        (bf16 in, f32 sums)
    sre, sim = mag * re * rsqrt(max(re^2 + im^2, 1e-16)), the same with im
                                                       (rounded to bf16)
    out      = sre @ IDFT_RE + sim @ IDFT_IM           (bf16 in, f32 sums)

:func:`spectral_step` launches the kernels for a CUDA tensor and uses
:func:`spectral_step_reference` only for a tensor on the CPU.  The plain
version rounds to bf16 where the kernels do and takes its products in f32 on
the rounded values (exact per term), so the two differ only in summation
order.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build
from .gl_fused import round_bf16
from .layouts import interleave_bins, round_up
from .ola import device_constant

#: bins and the n_fft axis are padded to the kernels' 64-column tile; the
#: padded matrix rows and columns are zero, so padded bins carry nothing
TILE = 64


@functools.lru_cache(maxsize=4)
def padded_dft_matrices(n_fft: int):
    """The dense DFT matrices with the frequency axis padded to a multiple
    of TILE and the time axis to a multiple of TILE: forward [Np, Fp],
    inverse [Fp, Np], zeros in the padding."""
    from ...dsp.chip import dft_matrices
    dre, dim, ire, iim = dft_matrices(n_fft)
    F = dre.shape[1]
    Fp, Np = round_up(F, TILE), round_up(n_fft, TILE)
    fwd = ((0, Np - n_fft), (0, Fp - F))
    inv = ((0, Fp - F), (0, Np - n_fft))
    return (np.pad(dre, fwd), np.pad(dim, fwd), np.pad(ire, inv),
            np.pad(iim, inv))


@functools.lru_cache(maxsize=4)
def kernel_matrices(n_fft: int):
    """The kernels' layouts of the padded matrices (f32): fwd_t [2 Fp, Np],
    the transpose of the interleaved forward matrix [Np, 2 Fp] (per 64-bin
    tile, the DFT_RE columns then the DFT_IM columns; the forward GEMM's
    K-major B), and inv_t [Np, 2 Fp], the transpose of the inverse matrices
    stacked to match the interleaved spectra (the inverse GEMM's K-major
    B)."""
    dre, dim, ire, iim = padded_dft_matrices(n_fft)
    fwd = interleave_bins(dre, dim)
    return np.ascontiguousarray(fwd.T), interleave_bins(ire.T, iim.T)


def dft_tensors(n_fft: int, device, dtype=torch.bfloat16):
    """The four dense DFT matrices on ``device``, rounded to bf16 (as bf16,
    or as f32 holding bf16 values)."""
    from ...dsp.chip import dft_matrices
    return tuple(device_constant(
        ("dense", n_fft, i, str(dtype)),
        lambda i=i: torch.as_tensor(dft_matrices(n_fft)[i]).to(
            torch.bfloat16).to(dtype), device) for i in range(4))


def _kernel_tensors(n_fft: int, device):
    """:func:`kernel_matrices` on ``device`` in bf16."""
    return tuple(device_constant(
        ("dense_kernel", n_fft, i), lambda i=i: torch.as_tensor(
            kernel_matrices(n_fft)[i]).to(torch.bfloat16), device)
        for i in range(2))


def spectral_step_reference(frames: torch.Tensor, magnitude: torch.Tensor,
                            n_fft: int) -> torch.Tensor:
    """Plain version: frames [rows, n_fft], magnitudes [rows, F] ->
    new (unwindowed) frames [rows, n_fft] float32."""
    dre, dim, ire, iim = dft_tensors(n_fft, frames.device, torch.float32)
    fb = round_bf16(frames)
    re = fb @ dre
    im = fb @ dim
    inv_amp = torch.rsqrt(torch.clamp(re * re + im * im, min=1e-16))
    mag = magnitude.float()
    sre = round_bf16(mag * re * inv_amp)
    sim = round_bf16(mag * im * inv_amp)
    return sre @ ire + sim @ iim


def _lib():
    lib = _build.load("griffin_lim")
    fn = lib.gl_spectral_step
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def spectral_step(frames: torch.Tensor, magnitude: torch.Tensor,
                  n_fft: int) -> torch.Tensor:
    """One spectral step of Griffin-Lim on [rows, n_fft] f32 frames and
    [rows, n_fft // 2 + 1] f32 magnitudes -> [rows, n_fft] f32.  CUDA
    tensors go through the cast, forward and inverse kernels of
    ``csrc/griffin_lim.cu`` in one C call (``spectral_step.launches``
    counts each call); CPU tensors through :func:`spectral_step_reference`."""
    if frames.device.type == "cpu":
        return spectral_step_reference(frames, magnitude, n_fft)
    if frames.device.type != "cuda":
        raise ValueError(f"unsupported device {frames.device}")
    F = n_fft // 2 + 1
    if frames.dim() != 2 or frames.shape[1] != n_fft \
            or magnitude.shape != (frames.shape[0], F):
        raise ValueError(f"bad shapes: frames {tuple(frames.shape)}, "
                         f"magnitude {tuple(magnitude.shape)} for n_fft "
                         f"{n_fft}")
    for name, t in (("frames", frames), ("magnitude", magnitude)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != frames.device:
            raise ValueError(f"{name} must be contiguous float32 on "
                             f"{frames.device}")
    rows = frames.shape[0]
    device = frames.device
    Fp, Np = round_up(F, TILE), round_up(n_fft, TILE)
    out = torch.empty((rows, n_fft), dtype=torch.float32, device=device)
    if rows == 0:
        return out
    fwd_t, inv_t = _kernel_tensors(n_fft, device)
    fb = torch.empty((rows, Np), dtype=torch.bfloat16, device=device)
    spec = torch.empty((rows, 2 * Fp), dtype=torch.bfloat16, device=device)
    ptr = _build.ptr
    _build.check(_lib().gl_spectral_step(
        ptr(frames), ptr(magnitude), ptr(fwd_t), ptr(inv_t), ptr(fb),
        ptr(spec), ptr(out), rows, n_fft, F, Np, Fp,
        _build.stream_ptr(device)), "gl_spectral_step")
    spectral_step.launches += 1
    return out


spectral_step.launches = 0
