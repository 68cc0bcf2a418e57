"""Readings for the limits of ``correct``: runs a cell's program on each
of several seeds in one process, with a short window, and prints one JSON
line a seed with the numbers the comparison reads for the program and for
each control by name (the reference below the configuration's precision,
in the program's place; ``check.py``):

    python3 -m perfbench.calibrate --workload <name> --seeds 1,2,3 \\
        --seconds 3 [--out calibrate.jsonl]

Needs the card, as the benchmark does.
"""

from __future__ import annotations

import argparse
import json
import sys
import types

from perfbench import core


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    core.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("perfbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = core.find_cell(args.workload)
    drv = core.driver(cell.kind)
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            run_args = types.SimpleNamespace(seed=seed, seconds=args.seconds,
                                             trace=0, control=True)
            result = drv.run(cell, run_args, torch.device("cuda"))
            line = json.dumps({"workload": cell.name, "seed": seed,
                               "program": result.numbers,
                               "control": result.control,
                               "setup_s": result.setup_s,
                               "end_to_end": result.end_to_end,
                               "memory_peak_bytes":
                                   result.memory_peak_bytes})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
