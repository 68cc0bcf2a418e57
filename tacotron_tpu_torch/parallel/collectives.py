"""The collectives of the data-parallel train step and of sharded synthesis.

The JAX train step is one SPMD program over the global batch, and every
reduction in it (the loss denominators, BatchNorm's statistics, the
metrics) runs over all rows of all processes.  Here each rank computes its
rows and these functions make the reductions global:

- :meth:`DataShard.sum` is a differentiable all-reduce: its backward
  all-reduces the gradient too, so a rank's loss that reads a global sum
  sends each rank its share of the gradient through it;
- :meth:`DataShard.max` reduces values that take no gradient (lengths);
- :func:`flat_all_reduce` sums a list of tensors with one collective over
  one flat buffer (the step's gradients and metrics);
- :meth:`DataShard.rows` takes this rank's rows of a tensor drawn over the
  global batch (the dropout masks).

Each collective called adds one to :data:`calls`: a count for tests and for
``chip_smoke.py`` (a CUDA graph's capture calls the step's collectives
once; its replays run them without Python).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence

import torch
import torch.distributed as dist

#: collectives called through this module since the last reset
calls = 0


def _call(fn, *args, **kwargs) -> None:
    global calls
    calls += 1
    fn(*args, **kwargs)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; the gradient of every rank's input is the sum of
    the ranks' output gradients."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        y = x.clone()
        _call(dist.all_reduce, y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        g = grad.contiguous().clone()
        _call(dist.all_reduce, g, group=ctx.group)
        return g, None


@dataclasses.dataclass(frozen=True)
class DataShard:
    """This rank's place on the data axis: the axis's process ``group``,
    the rank's ``index`` on it and its ``size``.  A global batch of
    ``size * n`` rows is the ranks' local batches of ``n`` rows in index
    order."""

    group: Any
    index: int
    size: int

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the group, differentiable."""
        return _AllReduceSum.apply(x, self.group)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The maximum of ``x`` over the group (a new tensor, no
        gradient)."""
        y = x.detach().clone()
        _call(dist.all_reduce, y, op=dist.ReduceOp.MAX, group=self.group)
        return y

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``x``, drawn over the global batch."""
        n = x.shape[0] // self.size
        return x.narrow(0, self.index * n, n)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' ``x`` concatenated on the first axis, in index
        order (no gradient)."""
        out = x.new_empty((self.size * x.shape[0],) + tuple(x.shape[1:]))
        _call(dist.all_gather_into_tensor, out, x.contiguous(),
               group=self.group)
        return out


def flat_all_reduce(tensors: Sequence[torch.Tensor], group
                    ) -> List[torch.Tensor]:
    """``tensors`` (of one dtype) summed over ``group`` with one collective
    on one flat buffer; returns views of the summed buffer in their
    shapes."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    _call(dist.all_reduce, flat, group=group)
    out, offset = [], 0
    for t in tensors:
        out.append(flat[offset:offset + t.numel()].view(t.shape))
        offset += t.numel()
    return out


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], src: int, group) -> None:
    """``tensors`` overwritten in place with rank ``src``'s values, one
    collective per dtype."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        _call(dist.broadcast, flat, src, group=group)
        offset = 0
        for t in same:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
