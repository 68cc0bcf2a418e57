"""Synthesis CLI:

    python -m tacotron_tpu_torch.synth --random_init "안녕하세요"
    python -m tacotron_tpu_torch.synth --load_npz weights.npz \
        --config config.json "text"
    python -m tacotron_tpu_torch.synth --load_path logs/run_x "text"
    python -m tacotron_tpu_torch.synth --load_path logs/run_x --long "..."

Runs on the card; ``--device cpu`` runs on the CPU instead.
"""

from __future__ import annotations

import argparse
import os

from ..config import Config, load_config
from .synthesizer import Synthesizer


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="synthesize speech")
    parser.add_argument("text", nargs="+", help="text(s) to synthesize")
    parser.add_argument("--random_init", action="store_true",
                        help="use fresh random weights (smoke testing)")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of --random_init")
    parser.add_argument("--load_npz", default=None,
                        help="flat .npz of '/'-joined flax variable paths")
    parser.add_argument("--load_path", default=None,
                        help="run dir of the port's trainer (its config "
                             "and newest checkpoint)")
    parser.add_argument("--config", default=None,
                        help="config.json of the run (default: Config())")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; raises without "
                             "a card)")
    parser.add_argument("--sample_path", default="samples")
    parser.add_argument("--speaker_id", type=int, default=0)
    parser.add_argument("--checkpoint_step", type=int, default=None,
                        help="checkpoint of --load_path (default: newest)")
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--manual_attention_mode", type=int, default=0,
                        choices=[0, 1, 2, 3],
                        help="post-hoc attention: 0=off, 1=argmax one-hot, "
                             "2=sharpen, 3=prune")
    parser.add_argument("--no_attention_trim", action="store_true")
    parser.add_argument("--no_librosa_trim", action="store_true")
    parser.add_argument("--vocode", default="chip",
                        choices=["chip", "host", "none"],
                        help="chip: Griffin-Lim on the device; host: numpy "
                             "Griffin-Lim; none: spectrograms only")
    parser.add_argument("--long", action="store_true",
                        help="treat each text as a long document: "
                             "sentence-split, decode the chunks in one "
                             "batched call, stitch with silence")
    parser.add_argument("--fast_vocoder", action="store_true",
                        help="30 momentum Griffin-Lim iterations")
    args = parser.parse_args(argv)

    sources = (args.random_init, args.load_npz is not None,
               args.load_path is not None)
    if sum(sources) != 1:
        parser.error("pass exactly one of --random_init, --load_npz and "
                     "--load_path")
    if args.long and args.manual_attention_mode:
        parser.error("--long and --manual_attention_mode are mutually "
                     "exclusive")
    synth = Synthesizer(device=args.device)
    if args.load_path:
        synth.load(args.load_path, step=args.checkpoint_step)
    else:
        config = load_config(args.config) if args.config else Config()
        if args.random_init:
            synth.init_random(config, seed=args.seed)
        else:
            synth.load_npz(args.load_npz, config)

    kwargs = dict(max_steps=args.max_steps,
                  attention_trim=not args.no_attention_trim,
                  librosa_trim=not args.no_librosa_trim, vocode=args.vocode,
                  fast_vocoder=args.fast_vocoder)
    if args.long:
        results = {"wavs": [], "alignments": []}
        for text in args.text:
            out = synth.synthesize_long(text, speaker_id=args.speaker_id,
                                        robust=False, **kwargs)
            print(f"[*] split into {len(out['chunks'])} chunk(s)")
            results["wavs"].append(out["wav"])
            results["alignments"].append(None)
    else:
        results = synth.synthesize(
            texts=args.text, speaker_ids=[args.speaker_id] * len(args.text),
            manual_attention_mode=args.manual_attention_mode, **kwargs)
    for p in synth.save_results(results, args.sample_path):
        print(f"[*] saved {p} ({os.path.getsize(p)} bytes)")


if __name__ == "__main__":
    main()
