"""The live training loop: ``DataFeeder`` -> ``DevicePrefetcher`` -> the
replayed ``TrainStep``, as the port's train driver runs it.

Set-up first looks up the configuration's model family and stops where
it has no ``TRAIN_REFERENCE``: the comparison, ``check.train_numbers``,
follows Tacotron's training step alone.  It then writes the corpus once
per checkout (``corpus_seed`` of the mix, under ``.perfbench_cache/``: a
dataset on disk, as a training user has one), draws the family's weights
from the run's seed, captures the step for every
bucket shape the feeder can reach, starts the feeder (seeded from the run's
seed, its queue ``feeder_queue`` batches deep) and the prefetcher, and
runs the first ``check_steps`` steps
through the window's own call and feed, keeping what the comparison needs:
their host batches, their losses, the first moments after step 1 and the
state after the last.  The window then runs steps until ``--seconds`` have
passed, copying the stacked losses to the host every ``sync_every`` steps
as the driver does; ``train_frames_per_s`` is the true (unpadded) target
frames of every step over the window's wall time, the device synchronized
at its end.
"""

from __future__ import annotations

import collections
import gc
import hashlib
import json
import os
import shutil
import tempfile
import time
from pathlib import Path

import torch

from .. import check
from ..core import DEFAULT_FAMILY, ROOT, Cell, Run, \
    family as model_family, process_start_time
from ..trace import TraceWindow
from ..traffic import generate


def corpus_dirs(mix: dict, model: dict) -> list:
    """The mix's corpus, written at its first use into a fixed directory
    of the checkout (``ROOT``) named by its parameters."""
    key = json.dumps({k: mix[k] for k in ("speakers", "utterances_per_speaker",
                                          "frames", "frames_median",
                                          "frames_sigma", "tokens",
                                          "corpus_seed")}, sort_keys=True)
    key += f"|{model['num_freq']}|{model['num_mels']}"
    digest = hashlib.sha256(key.encode()).hexdigest()[:16]
    final = ROOT / ".perfbench_cache" / "corpus" / digest
    if not final.exists():
        final.parent.mkdir(parents=True, exist_ok=True)
        tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=final.parent))
        try:
            generate.corpus(mix, model, mix["corpus_seed"], str(tmp))
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
    return [str(final / f"spk{s}") for s in range(mix["speakers"])]


def run(cell: Cell, args, device) -> Run:
    from tacotron_tpu_torch.config import Config
    from tacotron_tpu_torch.data.feeder import DataFeeder
    from tacotron_tpu_torch.parallel.prefetch import DevicePrefetcher
    from tacotron_tpu_torch.params import from_flax
    from tacotron_tpu_torch.train.driver import zero_batch
    from tacotron_tpu_torch.train.optim import AdamState
    from tacotron_tpu_torch.train.state import TrainState, create_model
    from tacotron_tpu_torch.train.step import batch_to_device, \
        make_train_step

    mix = cell.traffic
    cfg = cell.config["config"]
    family = model_family(cell.config)
    if not getattr(family, "TRAIN_REFERENCE", False):
        raise SystemExit(
            f"perfbench: model family "
            f"{cell.config.get('family', DEFAULT_FAMILY)!r} has no training "
            f"reference (check.train_numbers follows Tacotron's step)")
    config = Config.from_dict(cfg)
    out = Run("train", cell.config, mix)
    # the precision the port's train driver sets: float32 without TF32 in
    # products or convolutions, bf16 products summed in float32, and
    # deterministic cuDNN algorithms
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dirs = corpus_dirs(mix, cfg["model"])
    variables = family.make_variables(cfg["model"], args.seed, device)
    model = create_model(config)
    model.load_state_dict(from_flax({k: v.cpu().numpy()
                                     for k, v in variables.items()}))
    model = model.to(device).train()
    state = TrainState(step=0, model=model,
                       opt=AdamState.zeros(list(model.parameters())))
    step_fn = make_train_step(config)
    feeder = DataFeeder(dirs, config, seed=args.seed % (1 << 32))
    batch_size = config.train.batch_size
    # the largest shape first: the graphs share one pool, which its
    # capture sizes for the smaller ones
    step_fn.prewarm(state, (
        batch_to_device(zero_batch(config, batch_size, t, f), device)
        for t, f in sorted(feeder.bucket_shapes(), reverse=True)))
    feeder.start(prefetch=mix["feeder_queue"])
    fed = collections.deque()
    kept = []

    def source():
        batch = feeder.get()
        if len(kept) < mix["check_steps"]:
            kept.append(batch)
        fed.append((int(batch.target_lengths.sum()), batch.inputs.shape[1],
                    batch.mel_targets.shape[1]))
        return batch

    prefetcher = DevicePrefetcher(source, device,
                                  depth=mix["prefetch_depth"])
    dseed = args.seed
    try:
        readings = {"loss": []}
        for i in range(mix["check_steps"]):
            state, metrics = step_fn(state, prefetcher.get(), dseed)
            readings["loss"].append(metrics["loss"].detach().clone())
            if i == 0:
                readings["m1"] = [m.clone() for m in state.opt.m]
            fed.popleft()
        readings["after"] = {k: v.detach().clone()
                             for k, v in model.state_dict().items()}
        if device.type == "cuda":
            torch.cuda.synchronize()
        out.setup_s = time.time() - process_start_time()

        # the window's last trace_seconds are traced, so the host spans
        # before them run without the profiler
        tracer = TraceWindow(device) if args.trace else None
        tracing = False
        trace_from = args.seconds - mix["trace_seconds"]
        pending = []
        t0 = time.perf_counter()
        t_prev = t0
        while True:
            if (tracer is not None and not tracing
                    and time.perf_counter() - t0 >= trace_from):
                tracer.start()
                tracing = True
            with torch.profiler.record_function("bench.get"):
                batch = prefetcher.get()
            t_got = time.perf_counter()
            with torch.profiler.record_function("bench.step"):
                state, metrics = step_fn(state, batch, dseed)
            pending.append(metrics["loss"].detach().clone())
            if len(pending) == mix["sync_every"]:
                with torch.profiler.record_function("bench.flush"):
                    torch.stack(pending).cpu()
                pending.clear()
            frames, t_in, t_out = fed.popleft()
            now = time.perf_counter()
            out.units.append({"frames": frames, "t_in": t_in, "t_out": t_out,
                              "wait_ms": (t_got - t_prev) * 1e3,
                              "wall_s": now - t_prev, "traced": tracing})
            t_prev = now
            if now - t0 >= args.seconds:
                break
        if pending:
            torch.stack(pending).cpu()
        if device.type == "cuda":
            torch.cuda.synchronize()
        out.window_s = time.perf_counter() - t0
        if tracing:
            tracer.stop()
            out.traced = [i for i, u in enumerate(out.units)
                          if u["traced"]]
            out.trace = tracer.summary
    finally:
        prefetcher.stop()
        feeder.stop()
    out.attempted = len(out.units)
    out.end_to_end["train_frames_per_s"] = (
        sum(u["frames"] for u in out.units) / out.window_s)
    if device.type == "cuda":
        out.memory_peak_bytes = torch.cuda.max_memory_allocated()

    program = program_readings(model, readings, cfg["train"])
    del state, model, step_fn, metrics, batch, prefetcher
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check.train_numbers(cell, dseed, kept, dirs, variables,
                                  program, device)
    out.numbers = numbers
    out.checks = check.judged(cell, numbers)
    if getattr(args, "control", False):
        out.control = {check.CONTROL["train"]: check.train_numbers(
            cell, dseed, kept, dirs, variables, program, device,
            control=True)}
    return out


def program_readings(model, readings: dict, train_cfg: dict) -> dict:
    """The program's losses of the check steps, its first gradient as the
    optimizer got it (the first moments after step 1 over 1 - beta1) and
    its variables after the last check step, in the flax layout of the
    port's ``params.to_flax`` (norms are what the comparison reads)."""
    from tacotron_tpu_torch.params import flatten_variables, to_flax
    names = [n for n, _ in model.named_parameters()]
    grads = dict(readings["after"])
    for name, m in zip(names, readings["m1"]):
        grads[name] = m / (1.0 - train_cfg["adam_beta1"])
    grad_flat = flatten_variables(to_flax(grads))
    return {"loss": [float(x) for x in readings["loss"]],
            "grad": {k: v for k, v in grad_flat.items()
                     if k.startswith("params/")},
            "after": flatten_variables(to_flax(readings["after"]))}
