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

The dtypes are those the JAX package's ``gru_sequence`` takes
(:func:`check_dtypes`): ``x`` and ``h0`` float32, each of ``wg``, ``bg``,
``wc``, ``bc`` and the mask float32 or bf16, the output float32.  The
products of bf16 operands are float32 (JAX's ``preferred_element_type``,
``tacotron_tpu/ops/pallas/gru.py:72-82``): the plain version upcasts them,
which is exact, and the kernel converts each element as it loads it, with
no float32 copy of the tensor.  Each gradient comes back in its input's
dtype, as ``jax.grad`` gives it.

:func:`gru_sequence` is differentiable: its forward launches the kernel for
CUDA tensors, on the route :func:`cluster_plan` picks from the shapes (a
thread-block cluster holding the recurrent weights in shared memory, or,
above H = 512, one block per row streaming them from L2), and runs
:func:`gru_reference_scan` for CPU tensors; its
backward recomputes through :func:`gru_reference_scan` under autograd, as
the JAX package's ``custom_vjp`` does.  :func:`bigru_from_params` runs a
``BiGRU``'s weights through it; the model's CBHG calls it where no gradient
is needed and the carry is float32 (``models/modules.py``), and keeps
``ops/rnn.py::BiGRU`` otherwise.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, NamedTuple, Optional, Union

import torch
from torch import nn

from ..rnn import reverse_sequence
from . import _build


#: the operands that may be bf16, in the order of their bits in the C
#: calls' ``dtypes`` (kOperand* in csrc/gru.cu)
BF16_OPERANDS = ("wg", "bg", "wc", "bc", "mask")


def check_dtypes(x_tnd, h0, wg, bg, wc, bc, mask_tn) -> None:
    """Raise ``ValueError`` on dtypes the JAX package's ``gru_sequence``
    refuses.  ``x`` and ``h0`` must be float32: its kernel stores the
    float32 state into an output of ``x``'s dtype and ``h0`` into a float32
    scratch (``tacotron_tpu/ops/pallas/gru.py:90``, ``:61``), and a bf16
    one fails to trace.  Weights, biases and mask may be float32 or bf16."""
    for name, t in (("x", x_tnd), ("h0", h0)):
        if t.dtype != torch.float32:
            raise ValueError(f"GRU {name} must be float32, not {t.dtype}")
    for name, t in zip(BF16_OPERANDS, (wg, bg, wc, bc, mask_tn)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"GRU {name} must be float32 or bfloat16, not "
                             f"{t.dtype}")


def dtype_bits(**operands: torch.Tensor) -> int:
    """The C calls' ``dtypes``: the bit of each operand, named as in
    :data:`BF16_OPERANDS`, that is bf16."""
    return sum(1 << BF16_OPERANDS.index(name)
               for name, t in operands.items() if t.dtype == torch.bfloat16)


def gru_reference_scan(x_tnd: torch.Tensor, h0: torch.Tensor,
                       wg: torch.Tensor, bg: torch.Tensor,
                       wc: torch.Tensor, bc: torch.Tensor,
                       mask_tn: torch.Tensor) -> torch.Tensor:
    """Plain version: [T, N, D] inputs -> [T, N, H] float32 outputs.  bf16
    weights and biases are upcast (exactly) inside every step, as JAX's
    scan body promotes them, so that autograd rounds each step's gradient
    to bf16 and sums the steps in bf16, as ``jax.grad`` of the scan does."""
    T, N, _ = x_tnd.shape
    H = h0.shape[1]
    mask_tn = mask_tn.float()
    h = h0
    ys = []
    for t in range(T):
        x_t = x_tnd[t]
        wg_t, bg_t, wc_t, bc_t = (p.float() for p in (wg, bg, wc, bc))
        gates = torch.sigmoid(torch.cat([x_t, h], dim=-1) @ wg_t + bg_t)
        r, u = gates[:, :H], gates[:, H:]
        c = torch.tanh(torch.cat([x_t, r * h], dim=-1) @ wc_t + bc_t)
        h_new = u * h + (1.0 - u) * c
        m = mask_tn[t][:, None]
        ys.append(h_new * m)
        h = h * (1 - m) + h_new * m
    if not ys:
        return x_tnd.new_zeros((0, N, H))
    return torch.stack(ys)


#: batch rows one cluster serves at most (CL_ROWS in csrc/gru.cu)
CLUSTER_ROWS = 4
#: blocks per cluster at most: the H100's largest (non-portable) cluster
CLUSTER_MAX_BLOCKS = 16
#: the shared memory one block may use on the H100 (227 KB)
SMEM_LIMIT = 232_448
#: the least shared memory a cluster block is launched with: two blocks of
#: 116 KB do not fit one SM's 228 KB, so every block of a cluster gets an SM
#: of its own
SMEM_ONE_BLOCK_PER_SM = 118_784
#: threads of the streaming route's one block per row (REC_THREADS)
STREAMING_THREADS = 1024


class ClusterPlan(NamedTuple):
    """How ``csrc/gru.cu`` runs the recurrence of an [N, H] state.

    ``route`` is "cluster" (a cluster of ``cluster`` blocks per group of up
    to ``rows`` batch rows; block k owns units [k * hs, (k + 1) * hs) and
    keeps their recurrent weight columns in its shared memory) or
    "streaming" (one block per row, ``hs`` = H, reading the recurrent
    weights through L2 every step).  ``smem_bytes`` is the dynamic shared
    memory each block is launched with.  ``cluster``, ``hs`` and ``rows``
    are C, Hs and R of the source note in ``csrc/gru.cu``."""

    route: str
    cluster: int
    hs: int
    rows: int
    smem_bytes: int


def cluster_layout_bytes(H: int, cluster: int) -> int:
    """Shared memory a cluster block needs (the layout of
    ``gru_cluster_kernel``): its r, u and candidate columns over the depth
    rounded up to 32, the double-buffered state and r * h of four rows, and
    its u gates; the units per block rounded up to 4."""
    hs = -(-H // cluster)
    hs_pad = -(-hs // 4) * 4
    hk = -(-H // 32) * 32
    return 4 * (3 * hs_pad * hk + 12 * hk + 4 * hs_pad)


def streaming_bytes(H: int) -> int:
    """Shared memory of the streaming route's block (the depth slices of
    ``gru_recurrence`` in ``csrc/gru.cu``): h, h', r * h, the gates and the
    partial sums."""
    nsl_g = 1 if 2 * H >= STREAMING_THREADS else STREAMING_THREADS // (2 * H)
    nsl_c = 1 if H >= STREAMING_THREADS else STREAMING_THREADS // H
    return 4 * (5 * H + max(nsl_g * 2 * H, nsl_c * H))


def cluster_plan(N: int, H: int) -> ClusterPlan:
    """The route, from the shapes alone: the cluster route wherever a
    block's columns fit its shared memory, the streaming route above that
    (H > 512, where the depth also outgrows the kernel's 16 chunks of 32).
    Blocks per cluster: one per 16 units, at most 16, so a block keeps 16
    units where it can.  Over 16 blocks each block's products take half as
    long as over 8 and each exchange of state a little longer; at H = 256
    the 16 are faster (PERF.md)."""
    cluster = min(CLUSTER_MAX_BLOCKS, max(1, -(-H // 16)))
    need = cluster_layout_bytes(H, cluster)
    if need > SMEM_LIMIT:
        return ClusterPlan("streaming", 1, H, 1, streaming_bytes(H))
    return ClusterPlan("cluster", cluster, -(-H // cluster),
                       max(1, min(CLUSTER_ROWS, N)),
                       max(need, SMEM_ONE_BLOCK_PER_SM))


def _lib():
    lib = _build.load("gru")
    if lib.gru_recurrence.argtypes is None:
        lib.gru_projection.argtypes = [ctypes.c_void_p] * 7 \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.gru_projection.restype = ctypes.c_int
        lib.gru_recurrence.argtypes = [ctypes.c_void_p] * 7 \
            + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        lib.gru_recurrence.restype = ctypes.c_int
    return lib


def gru_input_projection(x, wg, bg, wc, bc):
    """The input halves of every step on the card, biases included:
    (gx [T, N, 2H], cx [T, N, H]), float32.  Contiguous CUDA tensors of the
    dtypes :func:`check_dtypes` allows, shapes checked by the caller."""
    T, N, D = x.shape
    H = bc.shape[0]
    gx = torch.empty((T, N, 2 * H), dtype=torch.float32, device=x.device)
    cx = torch.empty((T, N, H), dtype=torch.float32, device=x.device)
    ptr = _build.ptr
    _build.check(_lib().gru_projection(
        ptr(x), ptr(wg), ptr(bg), ptr(wc), ptr(bc), ptr(gx), ptr(cx), T, N,
        D, H, dtype_bits(wg=wg, bg=bg, wc=wc, bc=bc),
        _build.stream_ptr(x.device)), "gru_projection")
    return gx, cx


def gru_recurrence(gx, cx, h0, wg, wc, mask, products: bool = True):
    """The recurrence over the input halves on the card, on the route
    :func:`cluster_plan` picks: [T, N, H] float32.  ``products=False`` runs
    the cluster schedule with its products compiled out (zero sums), to
    time its latency floor; it is refused on the streaming route."""
    T, N, H2 = gx.shape
    H = H2 // 2
    D = wg.shape[0] - H
    plan = cluster_plan(N, H)
    blocks = plan.cluster if plan.route == "cluster" else 0
    out = torch.empty((T, N, H), dtype=torch.float32, device=gx.device)
    ptr = _build.ptr
    _build.check(_lib().gru_recurrence(
        ptr(gx), ptr(cx), ptr(h0), ptr(wg), ptr(wc), ptr(mask), ptr(out), T,
        N, D, H, blocks, plan.hs, plan.rows, plan.smem_bytes, int(products),
        dtype_bits(wg=wg, wc=wc, mask=mask), _build.stream_ptr(gx.device)),
        "gru_recurrence")
    return out


def _gru_kernel(x, h0, wg, bg, wc, bc, mask) -> torch.Tensor:
    """Launch ``csrc/gru.cu`` on CUDA tensors: the input projections of
    every step, then the recurrence on the route of :func:`cluster_plan`.
    bf16 operands are passed as they are (``.contiguous()`` copies only a
    strided tensor, in its own dtype)."""
    T, N, D = x.shape
    H = h0.shape[1]
    if h0.shape != (N, H) or wg.shape != (D + H, 2 * H) \
            or bg.shape != (2 * H,) or wc.shape != (D + H, H) \
            or bc.shape != (H,) or mask.shape != (T, N):
        raise ValueError(
            f"bad GRU shapes: x {tuple(x.shape)}, h0 {tuple(h0.shape)}, wg "
            f"{tuple(wg.shape)}, bg {tuple(bg.shape)}, wc {tuple(wc.shape)}, "
            f"bc {tuple(bc.shape)}, mask {tuple(mask.shape)}")
    check_dtypes(x, h0, wg, bg, wc, bc, mask)
    args = [t.contiguous() for t in (x, h0, wg, bg, wc, bc, mask)]
    if any(t.device != x.device for t in args):
        raise ValueError(f"GRU tensors must all be on {x.device}")
    x, h0, wg, bg, wc, bc, mask = args
    if T == 0 or N == 0:
        return torch.empty((T, N, H), dtype=torch.float32, device=x.device)
    gx, cx = gru_input_projection(x, wg, bg, wc, bc)
    out = gru_recurrence(gx, cx, h0, wg, wc, mask)
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
    """GRU over [T, N, D] -> [T, N, H] float32; ``mask_tn`` is float [T, N]
    (1.0 inside the sequence).  The dtypes of :func:`check_dtypes`, on
    either device.  ``gru_sequence.launches`` counts kernel launches."""
    check_dtypes(x_tnd, h0, wg, bg, wc, bc, mask_tn)
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
