"""The replayed train step's time in float32 and in bf16, for comparing two
checkouts of the port on one card in one call.

Full width (``Config()``, Deep Voice 2, two speakers), batch 16 on a
corpus written from a seed by ``data/synthetic.py``; per dtype the step is
prewarmed as CUDA graphs on 5 batches, then timed by
:func:`~.profile.time_train_steps` (one warm-up and 8 steps, the median)
three times.  Prints one JSON line: the checkout's label, the package's
path and the three medians per dtype.

The file imports the package of the checkout it is given, so one copy
times an older checkout too::

    python tacotron_tpu_torch/train/step_timing.py /path/to/parent parent
    python tacotron_tpu_torch/train/step_timing.py . change

Run them in turns (parent, change, change, parent) in one call: the card's
speed drifts between and within calls.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    checkout, label = argv
    # the checkout's package, not this file's directory (whose profile.py
    # would shadow the standard library's)
    sys.path[0] = os.path.abspath(checkout)

    import torch

    import tacotron_tpu_torch
    from tacotron_tpu_torch.config import Config
    from tacotron_tpu_torch.data import DataFeeder
    from tacotron_tpu_torch.data.synthetic import write_synthetic_corpus
    from tacotron_tpu_torch.train.profile import time_train_steps
    from tacotron_tpu_torch.train.state import create_train_state
    from tacotron_tpu_torch.train.step import batch_to_device, make_train_step

    if not torch.cuda.is_available():
        raise SystemExit("step_timing needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda")
    base = Config()
    cfg = base.replace(
        model=dataclasses.replace(base.model, model_type="deepvoice",
                                  num_speakers=2),
        train=dataclasses.replace(base.train, decay_learning_rate_mode=1))
    package = os.path.dirname(tacotron_tpu_torch.__file__)
    if not package.startswith(os.path.abspath(checkout)):
        raise SystemExit(f"imported {package}, not the checkout {checkout}")
    out = {"checkout": label, "package": package}
    with tempfile.TemporaryDirectory() as tmp:
        dirs = write_synthetic_corpus(os.path.join(tmp, "corpus"), cfg)
        for name in ("float32", "bfloat16"):
            c = cfg.replace(model=dataclasses.replace(cfg.model,
                                                      compute_dtype=name))
            state = create_train_state(c, seed=0, device=dev)
            batches = DataFeeder(dirs, c, seed=5).batches()
            host = [next(batches) for _ in range(5)]
            step_fn = make_train_step(c)
            step_fn.prewarm(state, [batch_to_device(h, dev) for h in host])
            out[name] = [time_train_steps(state, step_fn, iter(host * 3), 1,
                                          8)["sec_per_step"]
                         for _ in range(3)]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
