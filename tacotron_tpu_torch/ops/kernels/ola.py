"""Windowed, normalized, centered overlap-add: the CUDA kernel
(``csrc/ola.cu``) and its plain PyTorch version.

Replaces the TPU kernel ``ops/pallas/ola.py::_ola_kernel`` of the JAX
package.  :func:`overlap_add_batched` launches the kernel for a CUDA tensor
and uses :func:`overlap_add_reference` only for a tensor on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...dsp.primitives import padded_window
from . import _build


def chunks_per_frame(n_fft: int, hop: int) -> int:
    return -(-n_fft // hop)


def window_sumsquare_f64(n_frames: int, n_fft: int, hop: int,
                         win_length: int) -> np.ndarray:
    """Overlap-added squared window over the full signal, in float64, with
    1.0 where the window coverage is zero."""
    window_sq = padded_window(win_length, n_fft) ** 2
    acc = np.zeros(n_fft + hop * (n_frames - 1), dtype=np.float64)
    for t in range(n_frames):
        acc[t * hop: t * hop + n_fft] += window_sq
    acc[acc < 1e-10] = 1.0
    return acc


@functools.lru_cache(maxsize=32)
def window_sumsquare(n_frames: int, n_fft: int, hop: int,
                     win_length: int) -> np.ndarray:
    """The iSTFT normalizer (float32)."""
    return window_sumsquare_f64(n_frames, n_fft, hop,
                                win_length).astype(np.float32)


_CONSTS: Dict[Tuple, torch.Tensor] = {}


def device_constant(key: Tuple, make, device) -> torch.Tensor:
    """A numpy constant uploaded once per device (windows, norms, DFT
    matrices); ``make()`` returns the array."""
    full_key = key + (str(torch.device(device)),)
    value = _CONSTS.get(full_key)
    if value is None:
        value = torch.as_tensor(make()).to(device)
        _CONSTS[full_key] = value
    return value


def window_tensor(config, device) -> torch.Tensor:
    return device_constant(
        ("window", config.win_length, config.n_fft),
        lambda: padded_window(config.win_length,
                              config.n_fft).astype(np.float32), device)


def norm_tensor(n_frames: int, config, device) -> torch.Tensor:
    return device_constant(
        ("wss", n_frames, config.n_fft, config.hop_length, config.win_length),
        lambda: window_sumsquare(n_frames, config.n_fft, config.hop_length,
                                 config.win_length), device)


def ola_blocks(frames: torch.Tensor, hop: int, n_blocks: int) -> torch.Tensor:
    """Shifted-add overlap-add of [B, T, n_fft] (already windowed) frames
    into [B, n_blocks, hop] signal blocks: chunk j of frame t lands in block
    t + j.  Needs ``n_blocks >= T + ceil(n_fft / hop) - 1``."""
    B, T, n_fft = frames.shape
    K = chunks_per_frame(n_fft, hop)
    chunks = F.pad(frames, (0, K * hop - n_fft)).reshape(B, T, K, hop)
    acc = frames.new_zeros((B, n_blocks, hop))
    for j in range(K):
        acc[:, j:j + T] += chunks[:, :, j]
    return acc


def overlap_add_reference(frames: torch.Tensor, num_samples: int,
                          config) -> torch.Tensor:
    """Plain version: windowed OLA of [B, T, n_fft] frames, divided by the
    window sum-square, centered -> [B, num_samples]."""
    B, T, n_fft = frames.shape
    hop = config.hop_length
    windowed = frames * window_tensor(config, frames.device)
    signal = ola_blocks(windowed, hop,
                        T + chunks_per_frame(n_fft, hop)).reshape(B, -1)
    out_len = n_fft + hop * (T - 1)
    signal = signal[:, :out_len] / norm_tensor(T, config, frames.device)
    return signal[:, n_fft // 2: n_fft // 2 + num_samples]


#: output groups (of ``vec`` samples) one block of ``csrc/ola.cu`` takes:
#: one per thread of 256 (OLA_TILE)
OLA_TILE = 256


class OlaPlan(NamedTuple):
    """How ``csrc/ola.cu`` cuts the output: each thread takes groups of
    ``vec`` consecutive samples of one hop block, each block ``tile``
    groups."""

    vec: int
    tile: int


def ola_plan(n_fft: int, hop: int, num_samples: int) -> OlaPlan:
    """The widest vector (4, 2 or 1 samples) that divides ``hop``,
    ``n_fft``, ``n_fft / 2`` and ``num_samples``, so that every group lies
    in one hop block, wholly inside or outside the centered output, and
    every frame, window, norm and output access is aligned to its width."""
    for vec in (4, 2):
        if hop % vec == 0 and n_fft % vec == 0 and (n_fft // 2) % vec == 0 \
                and num_samples % vec == 0:
            return OlaPlan(vec, OLA_TILE)
    return OlaPlan(1, OLA_TILE)


def _lib():
    lib = _build.load("ola")
    fn = lib.ola_centered
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def overlap_add_batched(frames: torch.Tensor, num_samples: int,
                        config) -> torch.Tensor:
    """Windowed, normalized, centered overlap-add [B, T, n_fft] ->
    [B, num_samples].  CUDA tensors go through the kernel (every T);
    CPU tensors through :func:`overlap_add_reference`."""
    if frames.device.type == "cpu":
        return overlap_add_reference(frames, num_samples, config)
    if frames.device.type != "cuda":
        raise ValueError(f"unsupported device {frames.device}")
    if frames.dim() != 3 or frames.dtype != torch.float32 \
            or not frames.is_contiguous():
        raise ValueError("frames must be a contiguous float32 [B, T, n_fft] "
                         f"tensor, got {frames.dtype} {tuple(frames.shape)}")
    B, T, n_fft = frames.shape
    hop = config.hop_length
    if n_fft != config.n_fft or T < 1 or num_samples < 0 \
            or n_fft // 2 + num_samples > n_fft + hop * (T - 1):
        raise ValueError(f"bad overlap-add shape: frames {tuple(frames.shape)}"
                         f", num_samples {num_samples}, n_fft {config.n_fft}")
    device = frames.device
    window = window_tensor(config, device)
    norm = norm_tensor(T, config, device)
    out = torch.empty((B, num_samples), dtype=torch.float32, device=device)
    if num_samples == 0:
        return out
    plan = ola_plan(n_fft, hop, num_samples)
    err = _lib().ola_centered(
        _build.ptr(frames), _build.ptr(window), _build.ptr(norm),
        _build.ptr(out), B, T, n_fft, hop, num_samples, plan.vec, plan.tile,
        _build.stream_ptr(device))
    _build.check(err, "ola_centered")
    overlap_add_batched.launches += 1
    return out


overlap_add_batched.launches = 0
