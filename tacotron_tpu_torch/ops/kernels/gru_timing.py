"""K4 (``gru_sequence``) timed from several source trees on one card.

Each tree is a checkout of this repo (its root, holding
``tacotron_tpu_torch/``).  The trees' ``libgru.so`` are built first, all at
once; then one process per tree and turn times ``gru_sequence`` at the GRU
path's two shapes (the post-net direction, T=200 N=4 D=256 H=256, and the
encoder direction, T=64 N=4 D=128 H=128) on the same seeded inputs, with
float32 weights and, where the tree takes them, bf16 weights, biases and
mask.  The trees run in the given order and then in reverse (A B B A), so a
drift of the card's clock over the call falls on both sides alike.  Times
are device times: a spin is queued ahead of each timed call, so the host's
launch cost is excluded; each is the median of ``--runs`` calls.

    python -m tacotron_tpu_torch.ops.kernels.gru_timing \\
        --tree parent=_archive/parent --tree change=. \\
        --out gru_timing.json

Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

#: (name, T, N, D, H, lengths) of the timed directions
SHAPES = (("post-net", 200, 4, 256, 256, (200, 181, 150, 97)),
          ("encoder", 64, 4, 128, 128, (64, 57, 40, 23)))
SPIN_CYCLES = 10_000_000


def inputs(T, N, D, H, lengths, seed: int = 0) -> list:
    """float32 ``gru_sequence`` arguments on the card, from a seed."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    arrays = [rng.normal(0, 0.5, (T, N, D)), rng.normal(0, 0.5, (N, H)),
              rng.uniform(-0.1, 0.1, (D + H, 2 * H)),
              rng.uniform(-0.1, 0.1, (2 * H,)),
              rng.uniform(-0.1, 0.1, (D + H, H)),
              rng.uniform(-0.1, 0.1, (H,)),
              np.arange(T)[:, None] < np.asarray(lengths)[None]]
    return [torch.tensor(a, dtype=torch.float32, device="cuda")
            for a in arrays]


def device_ms(fn, runs: int) -> float:
    """Median device time of ``fn()`` behind a spin, after warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_parts(gru, args: list, runs: int) -> dict:
    """The whole call, its input projection alone and its recurrence alone
    (on the projection's outputs), in ms."""
    x, h0, wg, bg, wc, bc, mask = args
    gx, cx = gru.gru_input_projection(x, wg, bg, wc, bc)
    return {"ms": device_ms(lambda: gru.gru_sequence(*args), runs),
            "projection_ms": device_ms(
                lambda: gru.gru_input_projection(x, wg, bg, wc, bc), runs),
            "recurrence_ms": device_ms(
                lambda: gru.gru_recurrence(gx, cx, h0, wg, wc, mask), runs)}


def time_this_tree(runs: int) -> dict:
    """{shape: {"f32": parts, "bf16": parts or None}} of the package on the
    path (:func:`time_parts`)."""
    import torch

    from tacotron_tpu_torch.ops.kernels import gru

    out = {"package": os.path.dirname(gru.__file__)}
    with torch.no_grad():
        for name, T, N, D, H, lengths in SHAPES:
            args = inputs(T, N, D, H, lengths)
            row = {"f32": time_parts(gru, args, runs)}
            low = args[:2] + [t.to(torch.bfloat16) for t in args[2:]]
            try:
                gru.gru_sequence(*low)
            except (ValueError, TypeError, RuntimeError):
                row["bf16"] = None    # a tree that takes float32 only
            else:
                row["bf16"] = time_parts(gru, low, runs)
            out[name] = row
    return out


def describe(parts) -> str:
    if parts is None:
        return "-"
    return (f"{parts['ms']:.4f} ms (projection {parts['projection_ms']:.4f},"
            f" recurrence {parts['recurrence_ms']:.4f})")


def run_tree(root: str, args: list) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
    return subprocess.run([sys.executable, "-P", os.path.abspath(__file__),
                           *args], cwd=root, env=env, capture_output=True,
                          text=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", action="append", default=[],
                        help="name=path of a checkout's root (repeatable)")
    parser.add_argument("--runs", type=int, default=50)
    parser.add_argument("--out", default=None)
    parser.add_argument("--once", action="store_true",
                        help="time the package on the path and print JSON")
    parser.add_argument("--build", action="store_true",
                        help="build the package on the path's libgru.so")
    args = parser.parse_args(argv)
    if args.build:
        from tacotron_tpu_torch.ops.kernels import _build
        _build.build(["gru"])
        return 0
    if args.once:
        print(json.dumps(time_this_tree(args.runs)))
        return 0
    trees = dict(t.split("=", 1) for t in args.tree)
    if not trees:
        parser.error("give at least one --tree name=path")
    t0 = time.perf_counter()
    builds = {name: subprocess.Popen(
        [sys.executable, "-P", os.path.abspath(__file__), "--build"],
        cwd=root, env=dict(os.environ, PYTHONPATH=os.path.abspath(root)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, root in trees.items()}
    for name, proc in builds.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"build of {name} failed:\n{log}", file=sys.stderr)
            return 1
    print(f"[gru_timing] built {len(trees)} trees in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    order = list(trees) + list(trees)[::-1]
    turns = []
    for name in order:
        proc = run_tree(trees[name], ["--once", "--runs", str(args.runs)])
        if proc.returncode != 0:
            print(f"{name} failed:\n{proc.stdout}\n{proc.stderr}",
                  file=sys.stderr)
            return 1
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        turns.append({"tree": name, **row})
        print(f"[gru_timing] {name}: " + "; ".join(
            f"{shape} f32 {describe(row[shape]['f32'])}, bf16 "
            f"{describe(row[shape]['bf16'])}" for shape, *_ in SHAPES),
            flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card)
    report = {"card": card, "runs": args.runs, "turns": turns}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
