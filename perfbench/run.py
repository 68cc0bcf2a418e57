"""The benchmark of ``tacotron_tpu_torch`` on one H100:

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` and prints, as the last line of its
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer ones with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with the
reference beside its limit, which also close standard error.

It exits nonzero and prints no result without a CUDA card (or with fewer
than the cell asks for), and when a module of ``jax``, ``jaxlib``,
``flax`` or ``tacotron_tpu`` (whole top-level names) is loaded once the
window has closed.
"""

from __future__ import annotations

import argparse
import sys

from perfbench import core


def parse(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def report(cell: core.Cell, args, result: core.Run, device: dict) -> str:
    """The result line; metrics a reader finds nothing for are left
    out."""
    from perfbench import trace
    metrics = {}
    for metric in cell.metrics_for(bool(args.trace)):
        name = metric["name"]
        if args.trace:
            value = core.metric_reader(name)(result)
        elif name == "setup_s":
            value = result.setup_s
        else:
            value = result.end_to_end.get(name)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": metric["unit"]}
    breakdown = (trace.breakdown(result.trace)
                 if args.trace and result.trace else None)
    return core.result_line(result, metrics, device, breakdown)


def main(argv=None) -> int:
    args = parse(argv)
    core.set_cache_dirs()
    import torch
    cell = core.find_cell(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = core.driver(cell.kind).run(cell, args, torch.device("cuda"))
    bad = core.forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    line = report(cell, args, result, core.device_line(
        chips, result.memory_peak_bytes, result.trace))
    print(line, flush=True)
    for c in result.checks:
        print(f"check {c['name']} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
