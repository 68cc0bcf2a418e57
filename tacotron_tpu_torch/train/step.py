"""The train and eval steps: counterparts of ``tacotron_tpu/train/step.py``.

One train step is a teacher-forced forward in training mode (dropout from a
generator seeded by ``(seed, step)``, BatchNorm on batch statistics, the
running statistics moved in place), the losses, ``backward``, and the
clip -> Adam -> schedule update of ``train/optim.py``.  Its metrics are
JAX's keys, kept as device tensors (``diverged`` a device bool) so the loop
never waits on the card; the driver fetches them in batches.  The step can
be captured as one CUDA graph per batch shape (:meth:`TrainStep.prewarm`).

Under a mesh plan (``parallel/mesh.py``) the step is the data-parallel form
of the JAX step, which is one SPMD program over the global batch: each
rank runs its rows with global BatchNorm statistics, dropout masks and loss
denominators (``forward_loss`` with the plan's ``DataShard``), so the sum of
the ranks' gradients is the JAX gradient.  After ``backward`` the gradients
and the loss metrics go through one all-reduce (SUM) of one flat buffer
over the data group; the clip and Adam follow on every rank alike, so the
replicas stay bit-equal and the metrics are the global ones.
``DistributedDataParallel`` would average per-rank means instead, and
per-rank BatchNorm statistics would give another model.
"""

from __future__ import annotations

import gc
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..dsp.chip import features_from_waveform
from ..parallel.collectives import flat_all_reduce
from ..utils import trace
from ..utils.graphs import GraphSet, Graphed, arg_key
from .losses import guided_attention_loss, tacotron_loss
from .optim import Optimizer, global_norm
from .state import TrainState


class Batch(NamedTuple):
    """One training batch: numpy arrays from the feeder, tensors once on
    the device."""

    inputs: Any                  # [N, T_in] int32 token ids
    input_lengths: Any           # [N] int32
    loss_coeff: Any              # [N] float32
    mel_targets: Any             # [N, T_out, num_mels] (None: waveforms)
    linear_targets: Any          # [N, T_out, num_freq] (None: waveforms)
    speaker_id: Any              # [N] int32
    # true frame counts before padding, for the reference-equivalent loss
    # normalization (train/losses.py)
    target_lengths: Any = None   # [N] int32
    # int16 waveforms [N, (T_out-1)*hop] for on-device feature extraction
    # (TrainConfig.on_device_features); mel/linear_targets are None then
    waveforms: Any = None


def to_device(x, device) -> torch.Tensor:
    """An array or tensor on ``device``.  For the card a host array goes
    through pinned memory and copies asynchronously on the current stream
    (the caching host allocator keeps each pinned buffer until its copy has
    run), so the call does not wait for the device."""
    device = torch.device(device)
    t = torch.as_tensor(x)
    if device.type != "cuda":
        return t.to(device)
    if t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def batch_to_device(batch: Batch, device) -> Batch:
    """Every field of ``batch`` through :func:`to_device`."""
    return Batch(*(None if x is None else to_device(x, device)
                   for x in batch))


def dropout_seed(seed: int, step: int) -> int:
    """The dropout generator's seed at ``step``: a hash of (seed, step)
    alone, so a resumed run draws the masks an uninterrupted one does."""
    return int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0] >> 1)


def forward_loss(model, config, batch: Batch,
                 generator: Optional[torch.Generator] = None,
                 guided_weight: Optional[torch.Tensor] = None,
                 shard=None
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Teacher-forced forward (in the model's current mode) and the losses,
    with the ``attention_mass`` telemetry and, when the config turns it on,
    the guided-attention prior (``guided_weight`` overrides the config's
    constant weight).  Returns (losses, model outputs).

    With a ``shard`` (``parallel/collectives.py::DataShard``) the batch is
    this rank's rows of the global batch, and every loss (and the
    ``attention_mass``) is this rank's numerator over the global
    denominator: their sums over the data group are the global values."""
    if config.train.on_device_features and batch.waveforms is not None:
        wav = batch.waveforms.to(torch.float32) / 32767.0
        linear_t, mel_t = features_from_waveform(wav, config.audio)
        batch = batch._replace(mel_targets=mel_t, linear_targets=linear_t)
    speaker = batch.speaker_id if config.model.num_speakers > 1 else None
    out = model(batch.inputs, batch.input_lengths, speaker_id=speaker,
                mel_targets=batch.mel_targets, dropout_generator=generator,
                data_shard=shard)
    losses = tacotron_loss(out["mel_outputs"], out["linear_outputs"],
                           batch.mel_targets, batch.linear_targets,
                           batch.loss_coeff, config.train, config.audio,
                           target_lengths=batch.target_lengths,
                           reduction_factor=config.model.reduction_factor,
                           shard=shard)

    # attention health: mean in-bounds attention mass per true decode step
    # (the monotonic attention leaks mass past the last token as alignment
    # collapses; this falls first)
    with torch.no_grad():
        align = out["alignments"]                       # [N, T_in, T_dec]
        N, T_in, T_dec = align.shape
        dev = align.device
        tok_mask = (torch.arange(T_in, device=dev)[None, :]
                    < batch.input_lengths[:, None])
        if batch.target_lengths is not None:
            r = max(1, config.model.reduction_factor)
            dec_steps = torch.clamp(torch.ceil(
                batch.target_lengths.to(torch.float32) / r), 1.0, float(T_dec))
        else:
            dec_steps = torch.full((N,), float(T_dec), device=dev)
        step_mask = (torch.arange(T_dec, device=dev)[None, :]
                     < dec_steps[:, None])
        in_bounds = (align.to(torch.float32) * tok_mask[:, :, None]
                     * step_mask[:, None, :])
        mass = in_bounds.sum(dim=1).sum(dim=1) / dec_steps
        losses["attention_mass"] = (mass.mean() if shard is None
                                    else mass.mean() / shard.size)

    if config.train.guided_attention_weight > 0.0:
        attn = guided_attention_loss(
            out["alignments"], batch.input_lengths, batch.target_lengths,
            config.model.reduction_factor,
            sigma=config.train.guided_attention_sigma, shard=shard)
        if guided_weight is None:
            guided_weight = config.train.guided_attention_weight
        losses["attention_loss"] = attn
        losses["loss"] = losses["loss"] + guided_weight * attn
    return losses, out


def guided_weight_at(config, step: torch.Tensor) -> Optional[torch.Tensor]:
    """The annealed guided-attention weight at ``step`` (a tensor): linear
    from the configured weight to 0 over ``guided_attention_decay_steps``;
    None when the weight is constant (decay 0) or off."""
    base = config.train.guided_attention_weight
    decay = config.train.guided_attention_decay_steps
    if base <= 0.0 or decay <= 0:
        return None
    frac = 1.0 - step.to(torch.float32) / float(decay)
    return base * torch.clamp(frac, 0.0, 1.0)


class TrainStep:
    """``step(state, batch, seed) -> (state, metrics)``: one update of
    ``state`` in place (``state.step`` advanced by one) from a batch on the
    model's device; ``seed`` with the step seeds the dropout masks.

    The device work reads two slots that the host fills before each call:
    the step as a device scalar (a fill kernel, so no host-to-device copy),
    and one dropout generator re-seeded with :func:`dropout_seed`.  A graph
    captured on them therefore replays any step's schedule and masks, where
    ``torch.full((), step)`` or a fresh generator per step would freeze the
    capture's.

    Each call is a ``train.step`` span (``utils/trace.py``; its unit id
    the step number) around ``train.copy_in`` and ``train.replay``, or
    ``train.eager_step`` for a batch of a shape no graph holds.

    :meth:`prewarm` captures the step once per batch shape, on the state's
    own tensors (a graph keeps their addresses); a batch of a captured shape
    is then copied into its static buffers and replayed, any other runs
    eagerly.  The step's metrics are then the graph's static outputs, which
    the next step overwrites: the caller copies them out first (the driver
    stacks them at once).

    Under a ``plan`` with a process group (see the module docstring) every
    call first checks over the host group that the data group's batches
    have one shape (a mismatch raises instead of hanging in a
    collective).  The gradient all-reduce sits inside the captured step, so
    a replay runs it; capturing it needs NCCL (gloo's collectives are host
    calls a graph cannot hold), and :meth:`prewarm` refuses other
    backends."""

    def __init__(self, config, randomly_initialized: bool = True,
                 plan=None):
        self.config = config
        self.plan = plan
        self.shard = None if plan is None else plan.shard
        self.optimizer = Optimizer(config.train, randomly_initialized)
        self._slots: Optional[Tuple[torch.Tensor, torch.Generator]] = None
        self._graphs: Dict[Tuple, Graphed] = {}
        self._graph_set: Optional[GraphSet] = None
        self._graphed_state: Optional[TrainState] = None

    def _slots_on(self, device) -> Tuple[torch.Tensor, torch.Generator]:
        if self._slots is None or self._slots[0].device != device:
            self._slots = (torch.zeros((), dtype=torch.int32, device=device),
                           torch.Generator(device=device))
        return self._slots

    def _device_step(self, state: TrainState,
                     batch: Batch) -> Dict[str, torch.Tensor]:
        """The device work of one step, on the filled slots."""
        config = self.config
        model = state.model
        params = state.parameters()
        step_t, generator = self._slots
        model.train()
        gw = guided_weight_at(config, step_t)

        shard = self.shard
        losses, _ = forward_loss(model, config, batch, generator, gw, shard)
        for p in params:
            p.grad = None
        losses["loss"].backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if shard is not None:
            # one collective: the gradients and the loss metrics, summed
            keys = [k for k in ("loss", "mel_loss", "linear_loss",
                                "loss_without_coeff", "attention_mass",
                                "attention_loss") if k in losses]
            *grads, sums = flat_all_reduce(
                grads + [torch.stack([losses[k].detach() for k in keys])],
                shard.group)
            losses = dict(zip(keys, sums))
        grad_norm = self.optimizer.update(params, grads, state.opt)
        for p in params:
            p.grad = None

        loss = losses["loss"].detach()
        metrics = {
            "param_norm": global_norm([p.detach() for p in params]),
            "loss": loss,
            "mel_loss": losses["mel_loss"].detach(),
            "linear_loss": losses["linear_loss"].detach(),
            "loss_without_coeff": losses["loss_without_coeff"].detach(),
            "learning_rate": self.optimizer.schedule(step_t),
            "grad_norm": grad_norm,
            # loss-explosion flag (reference train.py:228-230)
            "diverged": torch.logical_or(loss > 100.0, torch.isnan(loss)),
            "attention_mass": losses["attention_mass"],
        }
        if config.train.guided_attention_weight > 0.0:
            metrics["attention_loss"] = losses["attention_loss"].detach()
            if gw is not None:
                metrics["guided_weight"] = gw
        return metrics

    def __call__(self, state: TrainState, batch: Batch,
                 seed: int) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with trace.span("train.step", unit=state.step):
            self._check(state, batch)
            step_t, generator = self._slots_on(state.parameters()[0].device)
            step_t.fill_(state.step)
            generator.manual_seed(dropout_seed(seed, state.step))
            graphed = self._graphs.get(arg_key(batch))
            if graphed is None:
                with trace.span("train.eager_step"):
                    metrics = self._device_step(state, batch)
            elif state is not self._graphed_state:
                raise ValueError(
                    "the step was prewarmed on another TrainState")
            else:
                with trace.span("train.copy_in"):
                    graphed.copy_in(*batch)
                with trace.span("train.replay"):
                    metrics = graphed.replay()
            state.step += 1
        return state, metrics

    def prewarm(self, state: TrainState, batches: Sequence[Batch]) -> int:
        """Capture the step once per shape of ``batches`` (device batches;
        their values are only read by the warm-up) on ``state``'s tensors,
        and leave those tensors as they were: the warm-up step updates the
        parameters, moments, count and BatchNorm statistics, so they are
        snapshot first and restored in place.  No autograd graph of the
        state's parameters may be alive (see ``utils/graphs.py``).  Returns
        the number of shapes the step holds graphs for."""
        if self.shard is not None and self.plan.backend != "nccl":
            raise ValueError(
                f"prewarm captures the step's gradient all-reduce into a "
                f"CUDA graph, which needs the NCCL backend; this process "
                f"group is {self.plan.backend!r} (run without prewarm)")
        self._check(state, None)
        device = state.parameters()[0].device
        gc.collect()  # no graph may be freed inside a capture (utils/graphs)
        if self._graph_set is None:
            self._graph_set = GraphSet(device, owner="train")
        step_t, generator = self._slots_on(device)
        tensors = (state.parameters() + list(state.model.buffers())
                   + state.opt.m + state.opt.v + [state.opt.count])
        saved = [t.detach().clone() for t in tensors]
        step_t.fill_(state.step)
        self._graphed_state = state
        for batch in batches:
            key = arg_key(batch)
            if key in self._graphs:
                continue
            self._graphs[key] = self._graph_set.capture(
                lambda *fields: self._device_step(state, Batch(*fields)),
                *batch, generators=[generator])
        with torch.no_grad():  # in place: the graphs keep these addresses
            for t, s in zip(tensors, saved):
                t.copy_(s)
        return len(self._graphs)


    def _check(self, state: TrainState, batch: Optional[Batch]) -> None:
        """Under a plan: a model whose head is split over the model axis is
        refused (the step keeps the state replicated, as the JAX step
        does), and the data group's batches must have one shape."""
        if self.shard is None:
            return
        from ..parallel.mesh import ColumnParallelLinear, batch_shapes_agree
        if isinstance(state.model.linear_projection, ColumnParallelLinear):
            raise ValueError(
                "the train step keeps the state replicated, as the JAX step "
                "does; a head split by shard_params(model_parallelism > 1) "
                "is for the forward")
        if batch is not None:
            batch_shapes_agree(self.plan, batch)


def make_train_step(config, plan=None,
                    randomly_initialized: bool = True) -> TrainStep:
    """The train step of ``config`` (:class:`TrainStep`); with a mesh
    ``plan`` the data-parallel step over the plan's data group."""
    return TrainStep(config, randomly_initialized, plan)


def make_eval_step(config, plan=None):
    """Teacher-forced eval: losses only, in eval mode (running statistics,
    no dropout), no state change.  Like the JAX eval step it applies the
    config's constant guided-attention weight, not the annealed one.  With
    a mesh ``plan`` the losses are the global batch's (one all-reduce)."""
    shard = None if plan is None else plan.shard
    keys = ("loss", "mel_loss", "linear_loss", "loss_without_coeff")

    @torch.no_grad()
    def eval_fn(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        if shard is not None:
            from ..parallel.mesh import batch_shapes_agree
            batch_shapes_agree(plan, batch)
        model = state.model
        model.eval()
        try:
            losses, _ = forward_loss(model, config, batch, shard=shard)
        finally:
            model.train()
        values = [losses[k] for k in keys]
        if shard is not None:
            values = list(flat_all_reduce([torch.stack(values)],
                                          shard.group)[0])
        return dict(zip(keys, values))

    return eval_fn
