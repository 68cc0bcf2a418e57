"""Where the time of a train step goes, on the card.

    python -m tacotron_tpu_torch.train.profile [--out profile.json]

Builds the full-width Deep Voice 2 model (``Config()``, two speakers,
random weights from ``--seed``) and a synthetic corpus
(``data/synthetic.py``: 2 speakers x 32 utterances of 120-400 frames), and
takes batches of 16 from ``DataFeeder``.  For each layer of a train step
it measures:

- the host wall time, synchronized around the layer alone (median and
  mean over ``--repeats`` batches): ``feeder`` (the next host batch of a
  built group; building a group of ``batches_per_group`` batches, which
  the feeder's thread does once per group, is ``feeder_group_ms``),
  ``copy`` (host to device),
  ``forward`` (teacher-forced, training mode, with the losses),
  ``backward``, ``optimizer`` (clip, Adam, schedule) and ``flush`` (one
  step's metrics stacked and copied to the host);
- one ``torch.profiler`` trace of the forward, the backward and the
  optimizer of one batch, each alone: device kernels, busy time, idle share
  and device time by kernel group;
- the whole step (``make_train_step``): its synchronized wall time
  (``time_train_steps``) and one trace of it;
- the same steps on the same batches replayed as CUDA graphs, one per
  batch shape (``TrainStep.prewarm``): ``replay`` holds their wall time,
  target frames per second and peak memory, ``replay_traced`` one trace,
  and ``prewarm_s`` the capture's time;
- ``roofline``: the matmul FLOPs of each timed step at its batch's padded
  shape (``train/roofline.py``) and the model FLOP utilization of the eager
  and the replayed steps against the H100's float32 peak (median over the
  steps).

Prints one JSON object and writes it to ``--out``.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import tempfile
import time

import torch

from ..config import Config
from ..data.feeder import DataFeeder
from ..data.synthetic import write_synthetic_corpus
from ..synth.profile import TraceWindow
from .optim import Optimizer
from .roofline import H100_FP32_PEAK_TFLOPS, forward_flops, mfu
from .state import create_train_state
from .step import batch_to_device, forward_loss, make_train_step

PHASES = ("feeder", "copy", "forward", "backward", "optimizer", "flush")


def traced(fn, dev) -> dict:
    """Run ``fn`` once in a :class:`TraceWindow`: its wall time and
    ``device_summary``."""
    window = TraceWindow(dev).start()
    fn()
    return window.stop()


def time_train_steps(state, step_fn, batches, seed: int, n: int) -> dict:
    """One warm-up step, then ``n`` train steps on host batches from
    ``batches``, each copied to the device first and then timed alone,
    synchronized, on the host clock: the step times (``step_s``), their
    median (``sec_per_step``), the median target frames per second (a
    batch's true frames over its step's time) and the peak device memory
    over the ``n`` steps (GiB): allocated, and reserved after the cache is
    emptied (``peak_reserved_gib``, which counts a CUDA graph's memory
    pool; the allocated peak does not see a replay's own memory).  The one
    definition of the whole-step numbers (this profile, ``chip_smoke.py``'s
    ``[train]`` and ``[graphs]`` lines)."""
    dev = state.parameters()[0].device
    step_fn(state, batch_to_device(next(batches), dev), seed)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    times, frames = [], []
    for _ in range(n):
        host = next(batches)
        batch = batch_to_device(host, dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        step_fn(state, batch, seed)
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
        frames.append(int(host.target_lengths.sum()))
    return {"step_s": times, "sec_per_step": statistics.median(times),
            "target_frames_per_s": statistics.median(
                f / t for f, t in zip(frames, times)),
            "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
            "peak_reserved_gib": torch.cuda.max_memory_reserved(dev) / 2**30}


def step_flops(config, batch) -> float:
    """The roofline's matmul FLOPs of one train step (forward and backward)
    at ``batch``'s padded shape."""
    n, t_in = batch.inputs.shape
    t_out = (batch.mel_targets.shape[1] if batch.mel_targets is not None
             else batch.waveforms.shape[1] // config.audio.hop_length + 1)
    return 3.0 * forward_flops(config, n, t_in, t_out)["total"]


def roofline(config, batches, *timings) -> dict:
    """FLOPs per step of ``batches`` and, for each timing of
    :func:`time_train_steps` on them, the median MFU (%) against the
    H100's float32 peak."""
    flops = [step_flops(config, b) for b in batches]
    return {"total_flops": flops, "peak_tflops": H100_FP32_PEAK_TFLOPS,
            "mfu_pct": [statistics.median(
                mfu(f, t) for f, t in zip(flops, timing["step_s"]))
                for timing in timings]}


def profile_train_step(dev, seed: int = 0, repeats: int = 5) -> dict:
    base = Config()
    cfg = base.replace(
        model=dataclasses.replace(base.model, model_type="deepvoice",
                                  num_speakers=2),
        train=dataclasses.replace(base.train, decay_learning_rate_mode=1))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True  # as the driver trains
    with tempfile.TemporaryDirectory() as tmp:
        dirs = write_synthetic_corpus(tmp, cfg, seed=seed)
        batches = DataFeeder(dirs, cfg, seed=seed).batches()
        t0 = time.perf_counter()
        first = next(batches)          # builds the first sorted group
        group_ms = (time.perf_counter() - t0) * 1e3
        state = create_train_state(cfg, seed=seed, device=dev)
        model = state.model
        params = state.parameters()
        optimizer = Optimizer(cfg.train)
        step_fn = make_train_step(cfg)
        step_fn(state, batch_to_device(first, dev), 0)  # warm-up
        torch.cuda.synchronize()

        times = {k: [] for k in PHASES}
        frames, padded = [], []
        for _ in range(repeats):
            t0 = time.perf_counter()
            host = next(batches)
            t1 = time.perf_counter()
            batch = batch_to_device(host, dev)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            gen = torch.Generator(device=dev).manual_seed(0)
            losses, outputs = forward_loss(model, cfg, batch, gen)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            losses["loss"].backward()
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            optimizer.update(params, [p.grad for p in params], state.opt)
            for p in params:
                p.grad = None
            torch.cuda.synchronize()
            t5 = time.perf_counter()
            torch.stack([v.detach().float() for v in losses.values()]).cpu()
            t6 = time.perf_counter()
            for k, a, b in zip(PHASES, (t0, t1, t2, t3, t4, t5),
                               (t1, t2, t3, t4, t5, t6)):
                times[k].append((b - a) * 1e3)
            frames.append(int(host.target_lengths.sum()))
            padded.append(tuple(host.mel_targets.shape[:2]))
        # the last step's autograd graph would pin the parameters' gradient
        # accumulators to the default stream and fail the captures below
        del losses, outputs

        batch = batch_to_device(next(batches), dev)
        out: dict = {}
        gen = torch.Generator(device=dev).manual_seed(0)
        out["forward"] = traced(
            lambda: out.setdefault("losses", forward_loss(
                model, cfg, batch, gen)[0]), dev)
        out["backward"] = traced(lambda: out["losses"]["loss"].backward(),
                                 dev)
        del out["losses"]  # its autograd graph would block the captures
        out["optimizer"] = traced(lambda: optimizer.update(
            params, [p.grad for p in params], state.opt), dev)
        for p in params:
            p.grad = None

        # the same batches eagerly, then replayed
        host = [next(batches) for _ in range(repeats + 1)]
        steps = time_train_steps(state, step_fn, iter(host), 0, repeats)
        b = batch_to_device(host[-1], dev)
        whole = traced(lambda: step_fn(state, b, 0), dev)

        graph_fn = make_train_step(cfg)
        t0 = time.perf_counter()
        n_graphs = graph_fn.prewarm(
            state, [batch_to_device(h, dev) for h in host])
        prewarm_s = time.perf_counter() - t0
        replay = time_train_steps(state, graph_fn, iter(host), 0, repeats)
        replay_traced = traced(lambda: graph_fn(state, b, 0), dev)

    return {
        "batch": cfg.train.batch_size, "true_frames": frames,
        "padded_shape": padded,
        "layers_ms": {k: {"median": statistics.median(v),
                          "mean": statistics.fmean(v)}
                      for k, v in times.items()},
        "feeder_group_ms": group_ms,
        "traced": {k: out[k] for k in ("forward", "backward", "optimizer")},
        **steps, "step_traced": whole,
        "graphs": n_graphs, "prewarm_s": prewarm_s, "replay": replay,
        "replay_traced": replay_traced,
        # [eager, replayed] median MFU over the same timed batches
        "roofline": roofline(cfg, host[1:], steps, replay),
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None, help="write the JSON here")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--repeats", type=int, default=5)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train.profile needs a CUDA card")
    result = profile_train_step(torch.device("cuda"), args.seed,
                                args.repeats)
    result["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=2)


if __name__ == "__main__":
    main()
