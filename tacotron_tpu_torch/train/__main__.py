"""Training CLI, with the flags of the JAX package's ``train.py``:

    python -m tacotron_tpu_torch.train --data_paths=spk1/data,spk2/data
    python -m tacotron_tpu_torch.train --data_paths=... --load_path=logs/x
    python -m tacotron_tpu_torch.train --data_paths=... --initialize_path=logs/x

(``--load_path`` resumes a run, ``--initialize_path`` warm-starts from one.)

Runs on the card; ``--device cpu`` runs on the CPU instead.  ``--prewarm``
captures the train step as one CUDA graph per bucket shape before the
first step.  ``--preset tpu`` applies ``Config.tpu_recommended`` (bfloat16
compute, on-device features from stored waveforms, batch 32) to the loaded
config before the other flags, as the JAX CLI does; ``--scan_unroll`` is
an XLA setting and is refused.

``--distributed`` joins the process group of a ``torchrun`` launch (one
process per card, NCCL; gloo with ``--device cpu``) and trains data-
parallel over the ``(data, model)`` grid of ``config.mesh``: each rank
feeds ``--batch_size`` rows, so the global batch is that times the ranks.
Every rank's batch then pads to the corpus maxima (one shape per step):

    torchrun --nproc_per_node=2 -m tacotron_tpu_torch.train --distributed \
        --data_paths=spk1/data,spk2/data
"""

from __future__ import annotations

import argparse
import dataclasses
import os

from ..config import Config, load_config
from ..synth.synthesizer import resolve_device
from ..utils import prepare_dirs
from .driver import PREFETCH_DEPTH, train


def build_config(args, data_paths) -> Config:
    """The run's config: ``--config`` (or the defaults), then ``--preset``,
    then the other flags; one speaker per data dir."""
    config = load_config(args.config) if args.config else Config()
    if args.preset == "tpu":
        config = Config.tpu_recommended(config)
    model_kw = {"num_speakers": len(data_paths)}
    if args.model_type:
        model_kw["model_type"] = args.model_type
    elif len(data_paths) > 1 and config.model.model_type == "single":
        model_kw["model_type"] = "deepvoice"
    train_kw = {}
    if args.batch_size:
        train_kw["batch_size"] = args.batch_size
    if args.on_device_features:
        train_kw["on_device_features"] = True
    if args.device_resident:
        train_kw["device_resident_corpus"] = True
    if args.guided_attention_weight is not None:
        train_kw["guided_attention_weight"] = args.guided_attention_weight
    if args.guided_attention_decay_steps is not None:
        train_kw["guided_attention_decay_steps"] = \
            args.guided_attention_decay_steps
    return config.replace(
        model=dataclasses.replace(config.model, **model_kw),
        train=dataclasses.replace(config.train, **train_kw))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="train the model")
    parser.add_argument("--data_paths", required=True,
                        help="comma-separated npz data dirs (one per speaker)")
    parser.add_argument("--log_dir", default="logs")
    parser.add_argument("--load_path", default=None,
                        help="run dir to resume (keeps step)")
    parser.add_argument("--initialize_path", default=None,
                        help="run dir to warm-start from (resets step)")
    parser.add_argument("--config", default=None,
                        help="config.json overriding the defaults")
    parser.add_argument("--preset", default=None, choices=["tpu"],
                        help="'tpu' applies Config.tpu_recommended() on top "
                             "of the loaded config: bf16 compute, on-device "
                             "feature extraction (a corpus built with "
                             "DataConfig.store_waveform), batch 32")
    parser.add_argument("--num_steps", type=int, default=100000)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--model_type", default=None,
                        choices=["single", "deepvoice", "simple"])
    parser.add_argument("--seed", type=int, default=123)
    parser.add_argument("--skip_path_filter", action="store_true",
                        help="bypass corpus frame/token filtering")
    parser.add_argument("--blacklists", default="",
                        help="comma-separated path substrings to exclude")
    parser.add_argument("--webhook_url", default=None,
                        help="POST notifications here on divergence")
    parser.add_argument("--guided_attention_weight", type=float, default=None,
                        help="weight of the soft-diagonal attention prior; "
                             "0 = off (reference parity)")
    parser.add_argument("--guided_attention_decay_steps", type=int,
                        default=None,
                        help="linearly anneal the guided-attention weight "
                             "to 0 over this many steps")
    parser.add_argument("--profile", action="store_true",
                        help="torch.profiler trace of steps 10-15 into "
                             "<run_dir>/profile")
    parser.add_argument("--prefetch_depth", type=int,
                        default=PREFETCH_DEPTH,
                        help="batches copied to the card ahead of the step "
                             "on a side stream; 0 = copy on the critical "
                             "path")
    parser.add_argument("--sync_every", type=int, default=25,
                        help="steps between host metric flushes; 1 = fully "
                             "synchronous")
    parser.add_argument("--on_device_features", action="store_true",
                        help="ship int16 waveforms and extract the targets "
                             "on the card (a corpus built with "
                             "DataConfig.store_waveform)")
    parser.add_argument("--device_resident", action="store_true",
                        help="copy the whole corpus to the card once and "
                             "gather each batch there")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; raises without "
                             "a card)")
    parser.add_argument("--prewarm", action="store_true",
                        help="capture the train step as one CUDA graph per "
                             "bucket shape before the first step; batches "
                             "of those shapes replay it")
    parser.add_argument("--scan_unroll", default=None,
                        help="refused: an XLA unroll setting")
    parser.add_argument("--distributed", action="store_true",
                        help="join the torchrun process group (RANK, "
                             "WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, "
                             "MASTER_PORT) and train data-parallel; each "
                             "rank pads its batches to the corpus maxima")
    args = parser.parse_args(argv)

    if args.scan_unroll is not None:
        parser.error("--scan_unroll sets the unroll of XLA scans; the port's "
                     "loops are eager PyTorch and take no unroll")
    if args.distributed and "WORLD_SIZE" not in os.environ:
        parser.error("--distributed joins the process group of a torchrun "
                     "launch (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, "
                     "MASTER_PORT); this process has no such environment")

    plan = None
    if args.distributed:
        from ..parallel import (distributed_initialize, make_mesh,
                                runtime_info)
        from ..parallel.distributed import local_device
        device = resolve_device(local_device(args.device))
        distributed_initialize(device=device)
        print(f"[*] distributed: {runtime_info()}", flush=True)
    else:
        device = resolve_device(args.device)
    data_paths = [p for p in args.data_paths.split(",") if p]
    config = build_config(args, data_paths)
    try:
        if args.distributed:
            plan = make_mesh(config.mesh)
            if plan.data_size > 1:
                config = config.replace(data=dataclasses.replace(
                    config.data, pad_to_corpus_max=True))
        run_dir = args.load_path or _shared_run_dir(args.log_dir,
                                                    data_paths, plan)
        train(run_dir, data_paths, config,
              num_steps=args.num_steps,
              initialize_path=args.initialize_path,
              seed=args.seed,
              test_dump_dir=os.path.join(run_dir, "samples"),
              profile_dir=(os.path.join(run_dir, "profile")
                           if args.profile else None),
              webhook_url=args.webhook_url,
              skip_path_filter=args.skip_path_filter,
              blacklists=[b for b in args.blacklists.split(",") if b],
              prewarm=args.prewarm,
              sync_every=args.sync_every,
              prefetch_depth=args.prefetch_depth,
              device=device, plan=plan)
    finally:
        if args.distributed:
            from ..parallel.distributed import shutdown
            shutdown()


def _shared_run_dir(log_root: str, data_paths, plan) -> str:
    """A new run dir, named by rank 0 (its timestamp) and sent to every
    rank of the grid; only rank 0 creates it."""
    if plan is None or plan.mesh_group is None:
        return prepare_dirs(log_root, data_paths)
    import torch.distributed as dist
    name = [prepare_dirs(log_root, data_paths)
            if plan.rank == plan.grid[0][0] else None]
    dist.broadcast_object_list(name, src=plan.grid[0][0],
                               group=plan.host_group or plan.mesh_group)
    return name[0]


if __name__ == "__main__":
    main()
