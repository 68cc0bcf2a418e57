"""Reference-checkpoint interchange CLI of the port.

The migration path for users of the reference, which publishes TF1
``son``/``park`` bundles (its ``download.py:82-109``):

    # inspect how a TF1 bundle maps onto the flax layout
    python -m tacotron_tpu_torch.compat report logs/park/model.ckpt-200000

    # convert it into a run directory the port serves and trains from
    python -m tacotron_tpu_torch.compat import logs/park/model.ckpt-200000 \\
        --run_dir runs/park
    python -m tacotron_tpu_torch.synth --load_path runs/park "text"

    # and back: export a port run as a TF1 bundle the reference's
    # Saver.restore can read
    python -m tacotron_tpu_torch.compat export runs/park out/model.ckpt-1

``import`` writes ``config.json`` and ``checkpoints/0/`` with the weights
(``variables.npz``) and a fresh optimizer state (``optimizer.pt``), so
``python -m tacotron_tpu_torch.train --load_path runs/park`` resumes from
it.  ``import`` and ``export`` build the model on the card (``--device cpu``
for the CPU) to check that the weights fit it; ``report`` reads files only.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence


def _load_config(path: Optional[str]):
    from ..config import Config, load_config
    return load_config(path) if path else Config()


def cmd_report(args) -> int:
    from .tf1 import import_report
    config = _load_config(args.config) if args.config else None
    print(import_report(args.prefix, config))
    return 0


def cmd_import(args) -> int:
    from ..params import from_flax
    from ..train.checkpoint import CheckpointManager
    from ..train.state import create_train_state
    from .tf1 import import_tf1_checkpoint

    config = _load_config(args.config)
    params, stats, unmatched = import_tf1_checkpoint(args.prefix, config)
    if unmatched and not args.force:
        print(f"[!] {len(unmatched)} source variables did not map:",
              file=sys.stderr)
        for name in unmatched:
            print(f"    ? {name}", file=sys.stderr)
        print("[!] pass --force to import anyway (unmatched variables "
              "are dropped), or fix --config to match the bundle's "
              "architecture", file=sys.stderr)
        return 1

    # the imported tree must fill exactly the model built from --config (a
    # mismatch would otherwise surface at load time)
    state = create_train_state(config, device=args.device)
    try:
        state.model.load_state_dict(
            from_flax({"params": params, "batch_stats": stats}), strict=True)
    except (KeyError, RuntimeError) as e:
        print(f"[!] the imported weights do not match the model built from "
              f"--config; run the 'report' subcommand to see the residue\n"
              f"{e}", file=sys.stderr)
        return 1
    CheckpointManager(args.run_dir, config).save(state)
    n_params = sum(1 for _ in state.model.parameters())
    print(f"[*] imported {args.prefix} -> {args.run_dir} "
          f"(step 0, {n_params} parameter tensors)")
    return 0


def cmd_export(args) -> int:
    from ..params import to_flax
    from ..train.checkpoint import (checkpoint_path, checkpoint_steps,
                                    load_run_config, load_weights)
    from ..train.state import create_model
    from ..synth.synthesizer import resolve_device
    from .tf1 import export_tf1_checkpoint

    config = load_run_config(args.run_dir)
    steps = checkpoint_steps(args.run_dir)
    step = args.step if args.step is not None else (steps[-1] if steps
                                                    else None)
    model = create_model(config).to(resolve_device(args.device))
    load_weights(model, checkpoint_path(args.run_dir, step))
    variables = to_flax(model.state_dict())
    os.makedirs(os.path.dirname(os.path.abspath(args.prefix)), exist_ok=True)
    export_tf1_checkpoint(args.prefix, variables["params"],
                          variables.get("batch_stats", {}), config)
    print(f"[*] exported step {step} -> {args.prefix}"
          f"{{.index,.data-00000-of-00001}}")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tacotron_tpu_torch.compat",
        description="TF1 reference-checkpoint interchange")
    sub = parser.add_subparsers(dest="cmd", required=True)
    device_help = "torch device (default: cuda; raises without a card)"

    p = sub.add_parser("report", help="show how a TF1 bundle maps")
    p.add_argument("prefix", help="model.ckpt-N prefix, or a directory "
                                  "(newest bundle is picked)")
    p.add_argument("--config", default=None,
                   help="config.json for the exact rule table "
                        "(omit for the lenient regex mapper)")
    p.set_defaults(fn=cmd_report)

    p = sub.add_parser("import", help="TF1 bundle -> port run dir")
    p.add_argument("prefix")
    p.add_argument("--run_dir", required=True)
    p.add_argument("--config", default=None,
                   help="architecture of the bundle (defaults to the "
                        "reference defaults)")
    p.add_argument("--force", action="store_true",
                   help="import even with unmatched variables (they are "
                        "dropped)")
    p.add_argument("--device", default=None, help=device_help)
    p.set_defaults(fn=cmd_import)

    p = sub.add_parser("export",
                       help="port run dir -> TF1 bundle (reference-readable)")
    p.add_argument("run_dir")
    p.add_argument("prefix", help="output model.ckpt-N prefix")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--device", default=None, help=device_help)
    p.set_defaults(fn=cmd_export)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
