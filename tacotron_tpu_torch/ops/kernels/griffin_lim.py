"""The Griffin-Lim spectral step: the CUDA kernel pair
(``csrc/griffin_lim.cu``) and its plain PyTorch version.

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
from .ola import device_constant

#: bins and the n_fft axis are padded to the kernels' 64-column tile; the
#: padded matrix rows and columns are zero, so padded bins carry nothing
TILE = 64


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@functools.lru_cache(maxsize=4)
def padded_dft_matrices(n_fft: int):
    """The dense DFT matrices with the frequency axis padded to a multiple
    of TILE and the time axis to a multiple of TILE: forward [Np, Fp],
    inverse [Fp, Np], zeros in the padding."""
    from ...dsp.chip import dft_matrices
    dre, dim, ire, iim = dft_matrices(n_fft)
    F = dre.shape[1]
    Fp, Np = _round_up(F, TILE), _round_up(n_fft, TILE)
    fwd = ((0, Np - n_fft), (0, Fp - F))
    inv = ((0, Fp - F), (0, Np - n_fft))
    return (np.pad(dre, fwd), np.pad(dim, fwd), np.pad(ire, inv),
            np.pad(iim, inv))


def _dense_matrices(n_fft: int, padded: bool):
    if padded:
        return padded_dft_matrices(n_fft)
    from ...dsp.chip import dft_matrices
    return dft_matrices(n_fft)


def dft_tensors(n_fft: int, device, dtype=torch.bfloat16,
                padded: bool = False):
    """The four dense DFT matrices on ``device``, rounded to bf16 (as bf16,
    or as f32 holding bf16 values), unpadded or padded for the kernels."""
    return tuple(device_constant(
        ("dense", n_fft, i, str(dtype), padded),
        lambda i=i: torch.as_tensor(_dense_matrices(n_fft, padded)[i]).to(
            torch.bfloat16).to(dtype), device) for i in range(4))


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
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def spectral_step(frames: torch.Tensor, magnitude: torch.Tensor,
                  n_fft: int) -> torch.Tensor:
    """One spectral step of Griffin-Lim on [rows, n_fft] f32 frames and
    [rows, n_fft // 2 + 1] f32 magnitudes -> [rows, n_fft] f32.  CUDA
    tensors go through the forward and inverse kernels of
    ``csrc/griffin_lim.cu`` (``spectral_step.launches`` counts each call);
    CPU tensors through :func:`spectral_step_reference`."""
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
    Fp, Np = _round_up(F, TILE), _round_up(n_fft, TILE)
    dre, dim, ire, iim = dft_tensors(n_fft, device, padded=True)
    sre = torch.empty((rows, Fp), dtype=torch.bfloat16, device=device)
    sim = torch.empty((rows, Fp), dtype=torch.bfloat16, device=device)
    out = torch.empty((rows, n_fft), dtype=torch.float32, device=device)
    if rows == 0:
        return out
    ptr = _build.ptr
    _build.check(_lib().gl_spectral_step(
        ptr(frames), ptr(magnitude), ptr(dre), ptr(dim), ptr(ire), ptr(iim),
        ptr(sre), ptr(sim), ptr(out), rows, n_fft, F, Np, Fp,
        _build.stream_ptr(device)), "gl_spectral_step")
    spectral_step.launches += 1
    return out


spectral_step.launches = 0
