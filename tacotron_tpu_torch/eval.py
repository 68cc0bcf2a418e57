"""Batch evaluation CLI, the port's counterpart of the root ``eval.py``:

    python -m tacotron_tpu_torch.eval --load_path_pattern 'logs/*'

Synthesizes a fixed set of evaluation sentences (``EVAL_TEXTS``, or
``--texts``) for every run directory matching ``--load_path_pattern``, for
every requested speaker, in batches, and writes
``<sample_path>/<run>/speaker<k>/eval<lo>_<i>.wav``.  Runs on the card;
``--device cpu`` runs on the CPU instead.
"""

from __future__ import annotations

import argparse
import os
from glob import glob

from .synth import Synthesizer
from .synth.synthesizer import resolve_device
from .text.eval_sentences import EVAL_TEXTS


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="synthesize the evaluation "
                                                 "sentences of run dirs")
    parser.add_argument("--load_path_pattern", required=True,
                        help="glob over run directories")
    parser.add_argument("--sample_path", default="eval_samples")
    parser.add_argument("--speakers", type=int, default=1)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--texts", nargs="*", default=None)
    parser.add_argument("--manual_attention_mode", type=int, default=0,
                        choices=[0, 1, 2, 3],
                        help="post-hoc attention: 0=off, 1=argmax one-hot, "
                             "2=sharpen, 3=prune")
    parser.add_argument("--attention_retry", type=int, default=0,
                        choices=[0, 1, 2],
                        help="per-utterance attention health check; failed "
                             "utterances re-decode with post-hoc manual "
                             "attention of this mode (0=off)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; raises without "
                             "a card)")
    args = parser.parse_args(argv)
    if args.attention_retry and args.manual_attention_mode:
        parser.error("--attention_retry and --manual_attention_mode are "
                     "mutually exclusive")

    device = resolve_device(args.device)
    texts = args.texts or EVAL_TEXTS
    run_dirs = sorted(glob(args.load_path_pattern))
    if not run_dirs:
        parser.error(f"no run dirs match {args.load_path_pattern!r}")

    for run_dir in run_dirs:
        synth = Synthesizer(device).load(run_dir)
        run_name = os.path.basename(os.path.normpath(run_dir))
        for speaker in range(args.speakers):
            for lo in range(0, len(texts), args.batch_size):
                chunk = texts[lo:lo + args.batch_size]
                if args.attention_retry:
                    results = synth.synthesize_robust(
                        texts=chunk, speaker_ids=[speaker] * len(chunk),
                        max_steps=args.max_steps,
                        retry_mode=args.attention_retry)
                    for i in results["retried"]:
                        print(f"[!] attention retry: {chunk[i]!r} "
                              f"{results['attention_health'][i]}")
                else:
                    results = synth.synthesize(
                        texts=chunk, speaker_ids=[speaker] * len(chunk),
                        max_steps=args.max_steps,
                        manual_attention_mode=args.manual_attention_mode)
                out_dir = os.path.join(args.sample_path, run_name,
                                       f"speaker{speaker}")
                paths = synth.save_results(results, out_dir,
                                           prefix=f"eval{lo:03d}")
                for p in paths:
                    print(f"[*] {p}")


if __name__ == "__main__":
    main()
