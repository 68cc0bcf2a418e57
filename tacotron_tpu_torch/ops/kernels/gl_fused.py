"""One Griffin-Lim iteration over the carried full-length signal: the CUDA
kernel chain (``csrc/gl_fused.cu``) and its plain PyTorch version.

Replaces the TPU kernel ``ops/pallas/gl_fused.py::_gl_iter_kernel`` of the
JAX package, with its helpers.  The iteration works in the u/v half-frame
decimation: for a frame split into halves x1, x2, ``u = x1 + x2`` carries
the even bins and ``v = x1 - x2`` the odd ones, so the forward DFT is two
half-size products and the inverse uses the same matrices transposed, with
the Hermitian weights folded into the target magnitudes
(:func:`prepare_magnitudes`).  The signal is carried between iterations at
full overlap-add length as [B, NBa, hop] blocks and re-framed directly; only
the ~n_fft/2 samples at each end see different context than the
center-slice + reflect-pad engines (the JAX package's documented edge
deviation, kept).

:func:`gl_iteration` launches the kernels for CUDA tensors and uses
:func:`gl_iteration_reference` only for tensors on the CPU.  The reference
rounds to bf16 exactly where the kernel does, and takes its products in f32
on the rounded values (bf16 x bf16 products are exact in f32).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from .layouts import BIN_TILE, interleave_bins, round_up
from .ola import (chunks_per_frame, device_constant, ola_blocks,
                  window_sumsquare_f64, window_tensor)

#: frame rows are padded to a multiple of 8 (the JAX layout, kept so the
#: carried signal has the same block count as the reference engine)
ROW_ALIGN = 8
#: OLA row-shift headroom of the JAX kernel: hop chunks per frame - 1 <= 8
PADK = 8
LANE = 128

# The JAX kernel keeps a whole item's iteration in the TPU's 16 MB scoped
# vector memory and routes longer decodes to the matmul_half engine.  The
# port keeps that routing (same formula, same constants) so each decode goes
# to the same engine as in JAX.  It is not a limit of the CUDA kernels, but
# lifting it would send long decodes to another engine than JAX does, so
# their outputs would no longer match the reference: it stays.
ROUTING_BUDGET_BYTES = 14 * 1024 * 1024
ROUTING_BYTES_PER_FRAME = 26_000


def _routing_estimate(n_fft: int, n_frames: int) -> int:
    M = n_fft // 2
    ne, no = M // 2 + 1, M // 2
    matrices = 2 * 2 * M * (round_up(ne, LANE) + round_up(no, LANE))
    return matrices + n_frames * ROUTING_BYTES_PER_FRAME


def max_fused_frames(n_fft: int) -> int:
    """Longest decode (frames) routed to the fused engine: 383 at n_fft
    2048."""
    return ((ROUTING_BUDGET_BYTES - _routing_estimate(n_fft, 0))
            // ROUTING_BYTES_PER_FRAME)


def fused_supported(config, n_frames: int) -> bool:
    """The JAX predicate: n_fft % 4 == 0, (n_fft/2) % 128 == 0, at most
    PADK+1 hop chunks per frame, and the frame cap of the routing budget."""
    n_fft, hop = config.n_fft, config.hop_length
    k0 = -(-n_fft // hop) if hop >= 1 else 0
    return (n_fft % 4 == 0 and (n_fft // 2) % LANE == 0
            and k0 - 1 <= PADK and n_frames >= 1 and hop >= 1
            and _routing_estimate(n_fft, n_frames) <= ROUTING_BUDGET_BYTES)


@functools.lru_cache(maxsize=4)
def fwd_matrices(n_fft: int):
    """Even/odd-bin forward DFT matrices [M, NE] / [M, NO] (f32, bins
    zero-padded to BIN_TILE) and the inverse Hermitian weights we/wo."""
    M = n_fft // 2
    ne, no = M // 2 + 1, M // 2
    nep, nop = round_up(ne, BIN_TILE), round_up(no, BIN_TILE)
    n = np.arange(M)[:, None]
    ang_e = 2.0 * np.pi * n * (2 * np.arange(ne)[None, :]) / n_fft
    ang_o = 2.0 * np.pi * n * (2 * np.arange(no)[None, :] + 1) / n_fft
    f32 = np.float32

    def padc(a, w):
        return np.pad(a.astype(f32), ((0, 0), (0, w - a.shape[1])))

    e_r, e_i = padc(np.cos(ang_e), nep), padc(-np.sin(ang_e), nep)
    o_r, o_i = padc(np.cos(ang_o), nop), padc(-np.sin(ang_o), nop)
    we = np.full(ne, 2.0, f32)
    we[0] = we[-1] = 1.0
    we = np.pad(we / n_fft, (0, nep - ne))
    wo = np.full(nop, 2.0 / n_fft, f32)
    wo[no:] = 0.0
    return e_r, e_i, o_r, o_i, we, wo


def _matrices(n_fft: int, device):
    """The four DFT matrices on ``device`` for the plain versions: f32
    holding their bf16 roundings."""
    def make(i):
        return lambda: torch.as_tensor(fwd_matrices(n_fft)[i]).to(
            torch.bfloat16).float()
    return tuple(device_constant(("gl_mat", n_fft, i), make(i), device)
                 for i in range(4))


@functools.lru_cache(maxsize=4)
def kernel_matrices(n_fft: int):
    """The kernels' layouts of the forward matrices (f32): the interleaved
    even and odd matrices we [M, 2 NE], wo [M, 2 NO] (per 64-bin tile, the
    cosine columns then the sine columns; the inverse GEMM's B^T), and
    their transposes we_t [2 NE, M], wo_t [2 NO, M] (the forward GEMM's
    K-major B)."""
    e_r, e_i, o_r, o_i, _, _ = fwd_matrices(n_fft)
    we, wo = interleave_bins(e_r, e_i), interleave_bins(o_r, o_i)
    return (np.ascontiguousarray(we.T), np.ascontiguousarray(wo.T), we, wo)


def _kernel_matrices(n_fft: int, device):
    """:func:`kernel_matrices` on ``device`` in bf16."""
    return tuple(device_constant(
        ("gl_kmat", n_fft, i), lambda i=i: torch.as_tensor(
            kernel_matrices(n_fft)[i]).to(torch.bfloat16), device)
        for i in range(4))


@functools.lru_cache(maxsize=8)
def inv_norm_full(n_frames: int, n_fft: int, hop: int, win_length: int,
                  nba: int) -> np.ndarray:
    """1 / overlap-added squared window over the full signal, as [nba * hop]
    (1.0 in the zero-coverage tail)."""
    acc = window_sumsquare_f64(n_frames, n_fft, hop, win_length)
    inv = np.ones(nba * hop, dtype=np.float64)
    inv[:acc.size] = 1.0 / acc
    return inv.astype(np.float32)


def _inv_norm(n_frames, config, nba, device) -> torch.Tensor:
    key = ("inv_norm", n_frames, config.n_fft, config.hop_length,
           config.win_length, nba)
    return device_constant(key, lambda: inv_norm_full(
        n_frames, config.n_fft, config.hop_length, config.win_length, nba),
        device)


def prepare_magnitudes(magnitude: torch.Tensor, n_fft: int):
    """[B, T, n_freq] target magnitudes -> weight-folded split-bin
    (mag_e_s [B, T, NE], mag_o_s [B, T, NO]) for :func:`gl_iteration`."""
    e_r, _, o_r, _, _, _ = fwd_matrices(n_fft)
    nep, nop = e_r.shape[1], o_r.shape[1]
    mag_e = magnitude[:, :, 0::2]
    mag_o = magnitude[:, :, 1::2]
    # the weights as device constants: an upload per call would be a
    # host-to-device copy inside a CUDA-graph capture
    we, wo = (device_constant(("gl_weights", n_fft, i),
                              lambda i=i: fwd_matrices(n_fft)[i],
                              magnitude.device) for i in (4, 5))
    mag_e_s = F.pad(mag_e, (0, nep - mag_e.shape[-1])) * we
    mag_o_s = F.pad(mag_o, (0, nop - mag_o.shape[-1])) * wo
    return mag_e_s.contiguous(), mag_o_s.contiguous()


def frame_rows(n_frames: int) -> int:
    """Ta: the frame axis of the magnitudes, padded to ROW_ALIGN."""
    return round_up(n_frames, ROW_ALIGN)


def signal_blocks_layout(n_frames: int, config):
    """(NBa, full signal length) of the carried signal for ``n_frames``."""
    n_fft, hop = config.n_fft, config.hop_length
    K0 = chunks_per_frame(n_fft, hop)
    out_len = n_fft + hop * (n_frames - 1)
    ta = frame_rows(n_frames)
    nba = round_up(max(-(-out_len // hop), ta + K0 - 1), ROW_ALIGN)
    return nba, out_len


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16, returned as float32."""
    return x.to(torch.bfloat16).float()


def initial_signal_blocks(mag_e_s: torch.Tensor, mag_o_s: torch.Tensor,
                          n_frames: int, config) -> torch.Tensor:
    """Zero-phase start: inverse DFT of the target magnitudes and full-length
    overlap-add -> [B, NBa, hop] (plain PyTorch, once per call)."""
    n_fft, hop = config.n_fft, config.hop_length
    B, T, _ = mag_e_s.shape
    NBa, _ = signal_blocks_layout(n_frames, config)
    e_r, _, o_r, _ = _matrices(n_fft, mag_e_s.device)
    u2 = round_bf16(mag_e_s) @ e_r.T
    v2 = round_bf16(mag_o_s) @ o_r.T
    frames = torch.cat([u2 + v2, u2 - v2], dim=-1) \
        * window_tensor(config, mag_e_s.device)
    acc = ola_blocks(frames, hop, NBa)
    return acc * _inv_norm(n_frames, config, NBa,
                           mag_e_s.device).reshape(NBa, hop)


def center_slice(sig_blocks: torch.Tensor, num_samples: int,
                 config) -> torch.Tensor:
    """[B, NBa, hop] full signal blocks -> [B, num_samples] centered."""
    flat = sig_blocks.reshape(sig_blocks.shape[0], -1)
    start = config.n_fft // 2
    return flat[:, start:start + num_samples]


def _check_inputs(sig_blocks, mag_e_s, mag_o_s, n_frames, config):
    n_fft, hop = config.n_fft, config.hop_length
    if not fused_supported(config, n_frames):
        raise ValueError(f"fused iteration does not take n_fft {n_fft}, "
                         f"hop {hop}, {n_frames} frames")
    if sig_blocks.dim() != 3 or mag_e_s.dim() != 3 or mag_o_s.dim() != 3:
        raise ValueError("sig_blocks and magnitudes must be 3-D")
    B, NBa, h = sig_blocks.shape
    Ta = mag_e_s.shape[1]
    nep = round_up(n_fft // 4 + 1, BIN_TILE)
    nop = round_up(n_fft // 4, BIN_TILE)
    if h != hop or mag_e_s.shape != (B, Ta, nep) \
            or mag_o_s.shape != (B, Ta, nop) or Ta < n_frames \
            or NBa < Ta + chunks_per_frame(n_fft, hop) - 1 \
            or NBa * hop < n_fft + hop * (n_frames - 1):
        raise ValueError(
            f"bad shapes: sig_blocks {tuple(sig_blocks.shape)}, mag_e_s "
            f"{tuple(mag_e_s.shape)}, mag_o_s {tuple(mag_o_s.shape)} for "
            f"{n_frames} frames, n_fft {n_fft}, hop {hop}")
    for name, t in (("sig_blocks", sig_blocks), ("mag_e_s", mag_e_s),
                    ("mag_o_s", mag_o_s)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != sig_blocks.device:
            raise ValueError(f"{name} must be contiguous float32 on "
                             f"{sig_blocks.device}")


def gl_iteration_reference(sig_blocks: torch.Tensor, mag_e_s: torch.Tensor,
                           mag_o_s: torch.Tensor, n_frames: int,
                           config) -> torch.Tensor:
    """Plain version of one iteration: [B, NBa, hop] -> [B, NBa, hop]."""
    B, NBa, hop = sig_blocks.shape
    n_fft = config.n_fft
    M = n_fft // 2
    Ta = mag_e_s.shape[1]
    device = sig_blocks.device
    e_r, e_i, o_r, o_i = _matrices(n_fft, device)
    win = window_tensor(config, device)

    flat = sig_blocks.reshape(B, NBa * hop)
    f = round_bf16(flat.unfold(-1, n_fft, hop)[:, :Ta] * win)  # [B,Ta,n_fft]
    u = round_bf16(f[..., :M] + f[..., M:])
    v = round_bf16(f[..., :M] - f[..., M:])

    def project(re, im, mag):
        s = mag * torch.rsqrt(torch.clamp(re * re + im * im, min=1e-16))
        return round_bf16(re * s), round_bf16(im * s)

    xe_r, xe_i = project(u @ e_r, u @ e_i, mag_e_s)
    xo_r, xo_i = project(v @ o_r, v @ o_i, mag_o_s)
    u2 = xe_r @ e_r.T + xe_i @ e_i.T
    v2 = xo_r @ o_r.T + xo_i @ o_i.T
    fo = torch.cat([u2 + v2, u2 - v2], dim=-1) * win
    acc = ola_blocks(fo, hop, NBa)
    return acc * _inv_norm(n_frames, config, NBa, device).reshape(NBa, hop)


def _lib():
    lib = _build.load("gl_fused")
    if lib.gl_frame_uv.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        sigs = {
            "gl_frame_uv": [P] * 4 + [I] * 5 + [P],
            "gl_dft_project": [P] * 8 + [I] * 4 + [P],
            "gl_idft_window": [P] * 6 + [I] * 4 + [P],
            "gl_ola_norm": [P] * 3 + [I] * 5 + [P],
        }
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def gl_iteration(sig_blocks: torch.Tensor, mag_e_s: torch.Tensor,
                 mag_o_s: torch.Tensor, n_frames: int,
                 config) -> torch.Tensor:
    """One Griffin-Lim iteration over the batch: [B, NBa, hop] signal
    blocks -> new blocks.  ``mag_e_s``/``mag_o_s`` [B, Ta, NE/NO] come from
    :func:`prepare_magnitudes` with the frame axis padded to Ta >= T.
    CUDA tensors run the four kernels of ``csrc/gl_fused.cu``
    (``gl_iteration.launches`` counts each launch); CPU tensors run
    :func:`gl_iteration_reference`."""
    if sig_blocks.device.type == "cpu":
        return gl_iteration_reference(sig_blocks, mag_e_s, mag_o_s,
                                      n_frames, config)
    if sig_blocks.device.type != "cuda":
        raise ValueError(f"unsupported device {sig_blocks.device}")
    _check_inputs(sig_blocks, mag_e_s, mag_o_s, n_frames, config)
    if any(t.data_ptr() % 16 for t in (mag_e_s, mag_o_s)):
        raise ValueError("the magnitudes must be 16-byte aligned")
    B, NBa, hop = sig_blocks.shape
    Ta, NE = mag_e_s.shape[1:]
    NO = mag_o_s.shape[2]
    n_fft = config.n_fft
    M = n_fft // 2
    rows = B * Ta
    device = sig_blocks.device
    lib = _lib()
    stream = _build.stream_ptr(device)
    ptr = _build.ptr
    we_t, wo_t, we, wo = _kernel_matrices(n_fft, device)
    win = window_tensor(config, device)
    inv_norm = _inv_norm(n_frames, config, NBa, device)

    bf16 = torch.bfloat16
    u = torch.empty((rows, M), dtype=bf16, device=device)
    v = torch.empty((rows, M), dtype=bf16, device=device)
    xe = torch.empty((rows, 2 * NE), dtype=bf16, device=device)
    xo = torch.empty((rows, 2 * NO), dtype=bf16, device=device)
    frames = torch.empty((rows, n_fft), dtype=torch.float32, device=device)
    out = torch.empty_like(sig_blocks)

    _build.check(lib.gl_frame_uv(
        ptr(sig_blocks), ptr(win), ptr(u), ptr(v), B, Ta, NBa * hop, hop, M,
        stream), "gl_frame_uv")
    gl_iteration.launches += 1
    _build.check(lib.gl_dft_project(
        ptr(u), ptr(v), ptr(we_t), ptr(wo_t), ptr(mag_e_s), ptr(mag_o_s),
        ptr(xe), ptr(xo), rows, M, NE, NO, stream), "gl_dft_project")
    gl_iteration.launches += 1
    _build.check(lib.gl_idft_window(
        ptr(xe), ptr(xo), ptr(we), ptr(wo), ptr(win), ptr(frames), rows, M,
        NE, NO, stream), "gl_idft_window")
    gl_iteration.launches += 1
    _build.check(lib.gl_ola_norm(
        ptr(frames), ptr(inv_norm), ptr(out), B, Ta, n_fft, hop, NBa * hop,
        stream), "gl_ola_norm")
    gl_iteration.launches += 1
    return out


gl_iteration.launches = 0
