"""The rank grid and its placement rules: the counterpart of
``tacotron_tpu/parallel/mesh.py``.

Layout: a 2-D logical grid ``(data, model)`` of ranks, row-major, as
``make_mesh`` lays out ``jax.devices()``.  At Tacotron scale the model fits
one card, so ``model=1`` by default: every rank holds a full replica and
the batch is split over ``data``.  The ``model`` axis exists so the one
wide projection (the ``num_freq``-column linear head) can be split over
columns without touching call sites (:func:`shard_params`).

A rank's plan holds its process groups: ``data_group`` (the ranks of its
grid column: the same model shard, different rows of the batch),
``model_group`` (its grid row: the same rows, different column blocks of
the head), ``mesh_group`` (every rank of the grid) and ``host_group``
(gloo over the grid, for host values that must not wait on the card:
batch shapes, a stop flag; None for a grid of one rank).  ``torch.distributed.new_group``
is collective, so every rank makes every group in one order, and ranks the
grid cuts off take part in that and in nothing else.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..config import MeshConfig
from .collectives import DataShard, _call, broadcast_
from .distributed import local_device


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """One rank's view of the grid: the grid of ranks (rows on the data
    axis), the rank, and its groups (None without a process group, or
    for a rank outside the grid)."""

    grid: Tuple[Tuple[int, ...], ...]
    rank: int
    data_axis: str = "data"
    model_axis: str = "model"
    data_group: Any = None
    model_group: Any = None
    mesh_group: Any = None
    host_group: Any = None
    backend: Optional[str] = None

    @property
    def data_size(self) -> int:
        return len(self.grid)

    @property
    def model_size(self) -> int:
        return len(self.grid[0])

    @property
    def in_mesh(self) -> bool:
        return any(self.rank in row for row in self.grid)

    def _position(self) -> Tuple[int, int]:
        for d, row in enumerate(self.grid):
            if self.rank in row:
                return d, row.index(self.rank)
        raise ValueError(f"rank {self.rank} is outside the grid "
                         f"{self.grid}")

    @property
    def data_index(self) -> int:
        return self._position()[0]

    @property
    def model_index(self) -> int:
        return self._position()[1]

    @property
    def shard(self) -> Optional[DataShard]:
        """The rank's :class:`DataShard` on the data axis; None without a
        process group (the plain single-process path)."""
        if self.data_group is None:
            return None
        return DataShard(self.data_group, self.data_index, self.data_size)


def rank_grid(config: MeshConfig, ranks: Sequence[int]) -> np.ndarray:
    """The ``(data, model)`` grid of ``ranks``, row-major, with JAX's
    checks: the count must divide by ``model_parallelism``;
    ``data_parallelism == -1`` takes every rank the model axis leaves; a
    grid smaller than the ranks cuts off the last ones."""
    ranks = list(ranks)
    model = max(1, config.model_parallelism)
    if len(ranks) % model:
        raise ValueError(
            f"{len(ranks)} devices not divisible by model_parallelism "
            f"{model}")
    data = (len(ranks) // model if config.data_parallelism == -1
            else config.data_parallelism)
    if data * model != len(ranks):
        ranks = ranks[:data * model]
    return np.asarray(ranks).reshape(data, model)


def _group(ranks, world_size: int, backend: Optional[str] = None):
    ranks = sorted(int(r) for r in ranks)
    if backend is None and ranks == list(range(world_size)):
        return dist.group.WORLD
    return dist.new_group(ranks, backend=backend)


def make_mesh(config: MeshConfig = MeshConfig(),
              world: Optional[Sequence[int]] = None) -> MeshPlan:
    """The rank grid over ``world`` (default: every rank of the process
    group, or the one process when there is none) and this rank's groups.
    Every rank of the group must call it, with the same arguments."""
    on = dist.is_initialized()
    if world is None:
        world = range(dist.get_world_size()) if on else [0]
    grid = rank_grid(config, sorted(world))
    axes = dict(data_axis=config.data_axis, model_axis=config.model_axis)
    rows = tuple(tuple(int(r) for r in row) for row in grid)
    if not on:
        if grid.size > 1:
            raise RuntimeError(
                f"a grid of {grid.size} ranks needs a process group "
                f"(parallel.distributed.initialize)")
        return MeshPlan(grid=rows, rank=int(grid[0, 0]), **axes)
    rank, world_size = dist.get_rank(), dist.get_world_size()
    backend = dist.get_backend()
    data, model = grid.shape
    # every rank makes every group, in one order
    data_groups = [_group(grid[:, m], world_size) for m in range(model)]
    model_groups = [_group(grid[d, :], world_size) for d in range(data)]
    mesh_group = _group(grid.reshape(-1), world_size)
    if grid.size == 1:
        host_group = None
    elif backend == "gloo":
        host_group = mesh_group
    else:
        host_group = _group(grid.reshape(-1), world_size, backend="gloo")
    plan = MeshPlan(grid=rows, rank=rank, backend=backend, **axes)
    if not plan.in_mesh:
        return plan
    d, m = plan._position()
    return dataclasses.replace(
        plan, data_group=data_groups[m], model_group=model_groups[d],
        mesh_group=mesh_group, host_group=host_group)


def batch_sharding(plan: MeshPlan) -> Optional[DataShard]:
    """How a global batch is split: the plan's :class:`DataShard` (None
    without a process group: one process holds every row)."""
    return plan.shard


def replicated_sharding(plan: MeshPlan):
    """What holds a replicated tensor: the process group of every rank of
    the grid, over which :func:`shard_params` broadcasts."""
    return plan.mesh_group


def batch_shapes_agree(plan: MeshPlan, batch) -> None:
    """Raise unless every rank of the grid holds a batch of the same field
    shapes: the step's collectives assume one padded shape (as
    ``make_array_from_process_local_data`` takes one global shape), and a
    mismatch would otherwise hang in them or mix rows.  The shapes go over
    the gloo ``host_group``, so the check never waits on the card."""
    if plan.host_group is None:
        return
    sig = []
    for x in batch:
        shape = () if x is None else tuple(x.shape)
        sig.extend([-1 if x is None else len(shape)] + list(shape)
                   + [0] * (4 - len(shape)))
    mine = torch.tensor(sig, dtype=torch.int64)
    every = [torch.empty_like(mine)
             for _ in range(plan.data_size * plan.model_size)]
    dist.all_gather(every, mine, group=plan.host_group)
    if any(not torch.equal(e, every[0]) for e in every):
        shapes = [None if x is None else tuple(x.shape) for x in batch]
        raise ValueError(
            f"the ranks' batches differ in shape (rank {plan.rank}: "
            f"{shapes}; every rank's signature "
            f"{[e.tolist() for e in every]}): every rank's batch of a step "
            f"needs one padded shape (DataConfig.pad_to_corpus_max)")


def shard_batch(plan: MeshPlan, batch, device=None):
    """A host batch of this rank's rows, on the rank's device.

    As in JAX's multi-process contract, each rank's feeder builds its own
    stripe of the corpus (``DataFeeder(process_index=plan.data_index,
    process_count=plan.data_size)``), those rows are the rank's shard, and
    the global batch is ``local_batch * data_size`` rows.  The steps check
    that the ranks' shapes agree (:func:`batch_shapes_agree`)."""
    from ..train.step import batch_to_device
    return batch_to_device(batch, local_device(device))


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient is summed over the model group (each
    rank's column block contributes its part of the input's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        _call(dist.all_reduce, g, group=ctx.group)
        return g, None


class _GatherColumns(torch.autograd.Function):
    """The ranks' column blocks concatenated on the last axis, in model
    order; the gradient is this rank's block."""

    @staticmethod
    def forward(ctx, y, group, index: int, size: int):
        ctx.index, ctx.width = index, y.shape[-1]
        parts = y.new_empty((size * y.shape[0],) + tuple(y.shape[1:]))
        _call(dist.all_gather_into_tensor, parts, y.contiguous(),
               group=group)
        parts = parts.view((size,) + tuple(y.shape))
        return torch.movedim(parts, 0, -2).reshape(
            tuple(y.shape[:-1]) + (size * y.shape[-1],))

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(-1, ctx.index * ctx.width, ctx.width),
                None, None, None)


class ColumnParallelLinear(nn.Module):
    """A ``nn.Linear`` whose output columns are split over the model
    group: this rank keeps block ``index`` of ``size`` (rows of the torch
    weight, columns of the flax kernel), and the forward all-gathers the
    blocks into the full output."""

    def __init__(self, full: nn.Linear, group, index: int, size: int):
        super().__init__()
        out = full.out_features
        if out % size:
            raise ValueError(
                f"linear_projection's {out} output columns do not divide "
                f"over the model axis's {size} ranks")
        width = out // size
        self.group, self.index, self.size = group, index, size
        self.weight = nn.Parameter(
            full.weight.detach()[index * width:(index + 1) * width].clone())
        self.bias = nn.Parameter(
            full.bias.detach()[index * width:(index + 1) * width].clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _CopyToModel.apply(x, self.group)
        y = F.linear(x, self.weight, self.bias)
        return _GatherColumns.apply(y, self.group, self.index, self.size)


@torch.no_grad()
def shard_params(plan: MeshPlan, model: nn.Module) -> nn.Module:
    """Place ``model`` on the grid, in place: its parameters and buffers
    are broadcast from the grid's first rank, so every replica starts
    equal; with ``model_parallelism > 1`` its ``linear_projection`` is then
    split over the model group (:class:`ColumnParallelLinear`; a column
    count the model axis does not divide raises), as JAX shards the head's
    kernel over ``P(None, model)``.  Everything else replicates.  Returns
    the model."""
    if plan.mesh_group is None:
        return model
    broadcast_(list(model.parameters()) + list(model.buffers()),
               plan.grid[0][0], plan.mesh_group)
    if plan.model_size > 1:
        model.linear_projection = ColumnParallelLinear(
            model.linear_projection, plan.model_group, plan.model_index,
            plan.model_size)
    return model
