"""The compute dtype: parameters cast at their point of use.

The JAX model keeps its parameters in float32 and casts each one to the
activations' dtype where a layer uses it (flax's ``.astype(x.dtype)``, a
Dense with ``dtype=x.dtype``).  Here :func:`cast` does that, and
:class:`Linear`, :func:`linear` and :func:`conv1d` use it, so a layer fed
bfloat16 computes in bfloat16 and a layer fed float32 is unchanged.

The decoder loop uses its parameters once a step.  JAX's compiler hoists a
loop-invariant cast out of its scan; eagerly, :func:`compute_copies` does
the same: inside its block :func:`cast` hands out one copy per parameter,
made on entry, instead of a cast kernel at every use.  Each use is its own
autograd node whose backward casts that use's gradient to the parameter's
dtype, so the uses' gradients add up in float32 at the parameter, as the
transpose of JAX's scan adds the cotangents of a cast inside its body.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterable, Optional

import torch
import torch.nn.functional as F
from torch import nn

_copies = threading.local()


class _CopyUse(torch.autograd.Function):
    """One use of a copy made by :func:`compute_copies`: the copy itself
    forward (no kernel), the use's gradient in the parameter's dtype
    backward."""

    @staticmethod
    def forward(ctx, param, copy):
        ctx.dtype = param.dtype
        return copy.view_as(copy)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None


def cast(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``p`` in ``dtype``: ``p`` itself when it has that dtype, the copy
    made on entry to :func:`compute_copies` inside its block, else
    ``p.to(dtype)``."""
    if p.dtype == dtype:
        return p
    copy = (getattr(_copies, "table", None) or {}).get(id(p))
    if copy is None or copy.dtype != dtype:
        return p.to(dtype)
    if p.requires_grad and torch.is_grad_enabled():
        return _CopyUse.apply(p, copy)
    return copy


@contextlib.contextmanager
def compute_copies(params: Iterable[torch.Tensor], dtype: torch.dtype):
    """Within the block, :func:`cast` of one of ``params`` to ``dtype``
    returns a copy made here, once (in this thread)."""
    previous = getattr(_copies, "table", None)
    _copies.table = {id(p): p.detach().to(dtype) for p in params
                     if p.dtype != dtype}
    try:
        yield
    finally:
        _copies.table = previous


def add_bias(y: torch.Tensor, bias: Optional[torch.Tensor],
             shape=(-1,)) -> torch.Tensor:
    """``y + bias`` (``bias`` reshaped to ``shape``) in ``y``'s dtype."""
    return y if bias is None else y + cast(bias, y.dtype).reshape(shape)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``F.linear`` in ``x``'s dtype.  Below float32 the product is
    rounded to ``x``'s dtype before the bias is added, as flax's ``Dense``
    rounds its ``dot_general`` and then adds (in JAX's compiled and eager
    programs alike); a fused bias would round once."""
    w = cast(weight, x.dtype)
    if x.dtype == torch.float32:
        return F.linear(x, w, None if bias is None else cast(bias, x.dtype))
    return add_bias(F.linear(x, w), bias)


def conv1d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``F.conv1d`` ([N, C, T]) in ``x``'s dtype; below float32 the bias
    is added after the product's rounding, as in :func:`linear` (the JAX
    convolutions add it after ``conv_general_dilated``)."""
    w = cast(weight, x.dtype)
    if x.dtype == torch.float32:
        return F.conv1d(x, w, None if bias is None else cast(bias, x.dtype))
    return add_bias(F.conv1d(x, w), bias, (-1, 1))


class Linear(nn.Linear):
    """``nn.Linear`` that computes in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)
