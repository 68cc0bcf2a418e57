"""A TF1-convention GRU over a whole sequence: the CUDA kernel
(``csrc/gru.cu``) and its plain PyTorch version.

Replaces the TPU kernel ``ops/pallas/gru.py::_gru_kernel`` (driven by
``_gru_pallas_raw`` / ``gru_sequence``) of the JAX package.  Per step, with
the gate conventions of ``ops/rnn.py``::

    [r, u] = sigmoid([x, h] @ wg + bg)
    c      = tanh([x, r * h] @ wc + bc)
    h'     = u * h + (1 - u) * c

and a per-step mask [T, N]: past a row's length the carry holds and the
emitted output is zero (``dynamic_rnn(sequence_length=...)``).  Weights are
in flax's layout, ``wg`` [D + H, 2H] and ``wc`` [D + H, H]; the adapters
below transpose ``nn.Linear``'s [out, in].

:func:`gru_sequence` is differentiable: its forward launches the kernel for
CUDA tensors (and runs :func:`gru_reference_scan` for CPU tensors), its
backward recomputes through :func:`gru_reference_scan` under autograd, as
the JAX package's ``custom_vjp`` does.  The model's CBHG keeps
``ops/rnn.py::BiGRU``; :func:`bigru_from_params` is the opt-in entry point
that runs a ``BiGRU``'s weights through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, Optional, Union

import torch
from torch import nn

from ..rnn import reverse_sequence
from . import _build


def gru_reference_scan(x_tnd: torch.Tensor, h0: torch.Tensor,
                       wg: torch.Tensor, bg: torch.Tensor,
                       wc: torch.Tensor, bc: torch.Tensor,
                       mask_tn: torch.Tensor) -> torch.Tensor:
    """Plain version: [T, N, D] inputs -> [T, N, H] outputs."""
    T, N, _ = x_tnd.shape
    H = h0.shape[1]
    h = h0
    ys = []
    for t in range(T):
        x_t = x_tnd[t]
        gates = torch.sigmoid(torch.cat([x_t, h], dim=-1) @ wg + bg)
        r, u = gates[:, :H], gates[:, H:]
        c = torch.tanh(torch.cat([x_t, r * h], dim=-1) @ wc + bc)
        h_new = u * h + (1.0 - u) * c
        m = mask_tn[t][:, None]
        ys.append(h_new * m)
        h = h * (1 - m) + h_new * m
    if not ys:
        return x_tnd.new_zeros((0, N, H))
    return torch.stack(ys)


def _lib():
    lib = _build.load("gru")
    fn = lib.gru_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _gru_kernel(x, h0, wg, bg, wc, bc, mask) -> torch.Tensor:
    """Launch ``csrc/gru.cu`` on CUDA tensors: the input projections of
    every step, then the recurrence, one block per row."""
    T, N, D = x.shape
    H = h0.shape[1]
    if h0.shape != (N, H) or wg.shape != (D + H, 2 * H) \
            or bg.shape != (2 * H,) or wc.shape != (D + H, H) \
            or bc.shape != (H,) or mask.shape != (T, N):
        raise ValueError(
            f"bad GRU shapes: x {tuple(x.shape)}, h0 {tuple(h0.shape)}, wg "
            f"{tuple(wg.shape)}, bg {tuple(bg.shape)}, wc {tuple(wc.shape)}, "
            f"bc {tuple(bc.shape)}, mask {tuple(mask.shape)}")
    args = [t.contiguous() for t in (x, h0, wg, bg, wc, bc, mask)]
    for t in args:
        if t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"GRU tensors must be float32 on {x.device}")
    device = x.device
    out = torch.empty((T, N, H), dtype=torch.float32, device=device)
    if T == 0 or N == 0:
        return out
    gx = torch.empty((T, N, 2 * H), dtype=torch.float32, device=device)
    cx = torch.empty((T, N, H), dtype=torch.float32, device=device)
    ptr = _build.ptr
    _build.check(_lib().gru_forward(
        *(ptr(t) for t in args), ptr(gx), ptr(cx), ptr(out), T, N, D, H,
        _build.stream_ptr(device)), "gru_forward")
    gru_sequence.launches += 1
    return out


class GRUSequence(torch.autograd.Function):
    """Forward through the kernel (CUDA) or the plain scan (CPU); backward
    through autograd of the plain scan, recomputed from the inputs."""

    @staticmethod
    def forward(ctx, x_tnd, h0, wg, bg, wc, bc, mask_tn):
        ctx.save_for_backward(x_tnd, h0, wg, bg, wc, bc, mask_tn)
        if x_tnd.device.type == "cpu":
            return gru_reference_scan(x_tnd, h0, wg, bg, wc, bc, mask_tn)
        if x_tnd.device.type != "cuda":
            raise ValueError(f"unsupported device {x_tnd.device}")
        return _gru_kernel(x_tnd, h0, wg, bg, wc, bc, mask_tn)

    @staticmethod
    def backward(ctx, grad):
        x_tnd, h0, wg, bg, wc, bc, mask_tn = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in
                      (x_tnd, h0, wg, bg, wc, bc)]
            ys = gru_reference_scan(*inputs, mask_tn)
            grads = torch.autograd.grad(ys, inputs, grad, allow_unused=True)
        return (*grads, None)


def gru_sequence(x_tnd: torch.Tensor, h0: torch.Tensor, wg: torch.Tensor,
                 bg: torch.Tensor, wc: torch.Tensor, bc: torch.Tensor,
                 mask_tn: torch.Tensor) -> torch.Tensor:
    """GRU over [T, N, D] -> [T, N, H]; ``mask_tn`` is float [T, N] (1.0
    inside the sequence).  ``gru_sequence.launches`` counts kernel
    launches."""
    return GRUSequence.apply(x_tnd, h0, wg, bg, wc, bc, mask_tn)


gru_sequence.launches = 0


def gru_sequence_ntd(x_ntd: torch.Tensor, h0: torch.Tensor,
                     wg: torch.Tensor, bg: torch.Tensor, wc: torch.Tensor,
                     bc: torch.Tensor,
                     lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batch-major form: [N, T, D] -> [N, T, H], masked by ``lengths``."""
    N, T, _ = x_ntd.shape
    if lengths is None:
        mask = x_ntd.new_ones((T, N))
    else:
        t_idx = torch.arange(T, device=x_ntd.device)
        mask = (t_idx[:, None] < lengths.to(x_ntd.device)[None, :]).to(
            x_ntd.dtype)
    out = gru_sequence(x_ntd.transpose(0, 1).contiguous(), h0, wg, bg, wc,
                       bc, mask)
    return out.transpose(0, 1)


def _cell_weights(params, side: str):
    """(wg, bg, wc, bc) of one direction in flax's layout, from a ``BiGRU``
    module or its state dict."""
    if isinstance(params, nn.Module):
        cell = getattr(params, side)
        gw, gb = cell.gates.weight, cell.gates.bias
        cw, cb = cell.candidate.weight, cell.candidate.bias
    else:
        gw, gb = params[f"{side}.gates.weight"], params[f"{side}.gates.bias"]
        cw = params[f"{side}.candidate.weight"]
        cb = params[f"{side}.candidate.bias"]
    return gw.t(), gb, cw.t(), cb


def bigru_from_params(params: Union[nn.Module, Mapping[str, torch.Tensor]],
                      xs_ntd: torch.Tensor,
                      lengths: Optional[torch.Tensor] = None,
                      initial_state: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Run an ``ops/rnn.py::BiGRU``'s weights (the module or its state dict)
    through :func:`gru_sequence`: [N, T, D] -> [N, T, 2H], the same function
    as ``BiGRU.forward``."""
    N, T, _ = xs_ntd.shape
    fw, bw = _cell_weights(params, "fw"), _cell_weights(params, "bw")
    H = fw[2].shape[1]
    if initial_state is not None:
        init_fw, init_bw = initial_state.chunk(2, dim=-1)
    else:
        init_fw = xs_ntd.new_zeros((N, H))
        init_bw = xs_ntd.new_zeros((N, H))

    ys_fw = gru_sequence_ntd(xs_ntd, init_fw, *fw, lengths)
    if lengths is None:
        ys_bw = torch.flip(gru_sequence_ntd(torch.flip(xs_ntd, dims=[1]),
                                            init_bw, *bw), dims=[1])
    else:
        xs_rev = reverse_sequence(xs_ntd, lengths)
        ys_bw = reverse_sequence(
            gru_sequence_ntd(xs_rev, init_bw, *bw, lengths), lengths)
    return torch.cat([ys_fw, ys_bw], dim=-1)
