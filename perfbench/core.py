"""What every cell shares: finding a cell's files by name, the process's
start time, the cache directories, the device line, the result line and
the import guard.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names its
configuration, whose file ``configs/<config>.json`` holds the
configuration as it is run, and its traffic, a data file
``traffic/<traffic>.json`` whose ``kind`` picks the driver
(``drivers/<kind>.py``).  A configuration file's top-level ``family``
(``tacotron`` where it names none) picks the model family
(``families/<family>.py``): the variables, the reference, the decode
budget and the FLOP count of the model.  ``limits/<workload>.json`` holds
the limits of the numbers that decide ``correct``.  Each per-layer metric is
read by ``metrics/<metric>.py``.  Adding a cell, a configuration, a model
family, a mix or a metric adds files and entries; no file here changes.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: top-level module names that no run may load (compared whole: the port's
#: own name starts with the JAX package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "tacotron_tpu")


def process_start_time() -> float:
    """The process's start, on the ``time.time()`` clock."""
    try:
        with open("/proc/self/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return time.time() - uptime + int(fields[19]) / ticks
    except (OSError, ValueError, IndexError):
        return _IMPORTED_AT


_IMPORTED_AT = time.time()


def set_cache_dirs(root: Path = ROOT) -> None:
    """Kernel and build caches in fixed directories inside the checkout,
    unless the caller set them: only a cell's first run there compiles."""
    cache = root / ".perfbench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))


def load_json(path: Path) -> Any:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


@dataclass
class Cell:
    """One workload with its files, found by name."""

    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    def metrics_for(self, trace: bool) -> List[dict]:
        """The metrics this cell reports in a ``--trace`` 0 or 1 run."""
        out = []
        for metric in (self.per_layer if trace else self.end_to_end):
            cells = metric.get("workloads")
            if cells is None or self.name in cells:
                out.append(metric)
        return out


def find_cell(workload: str, root: Path = ROOT) -> Cell:
    spec = load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in spec["workloads"]}
    if workload not in entries:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json "
                         f"has {sorted(entries)}")
    entry = entries[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(root / configs[entry["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{workload}.json")
    return Cell(workload, entry, config, traffic, limits,
                spec["end_to_end"], spec["per_layer"])


def load_module(path: Path):
    """A module from a file whose name may hold dots."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_file_" + path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str) -> Callable[["Run"], Optional[float]]:
    """``metrics/<name>.py``'s ``read``."""
    return load_module(HERE / "metrics" / f"{name}.py").read


#: the model family of a configuration file that names none
DEFAULT_FAMILY = "tacotron"


def family(config: dict):
    """The model family of a configuration file: ``families/<family>.py``
    for its top-level ``family``, loaded once per process.  It gives
    ``make_variables(model, seed, device)``, ``reference(variables, model,
    precision)``, ``decode_budget(cfg, n_tokens)``,
    ``frames_per_step(model)`` and ``forward_flops(model, batch, t_in,
    t_out)``; optionally ``SAMPLE_FIELDS`` with ``field_gaps(items, rows)``
    (``check.py``) and ``TRAIN_REFERENCE`` (``drivers/train.py``)."""
    name = config.get("family", DEFAULT_FAMILY)
    path = HERE / "families" / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"perfbench: unknown model family {name!r}: no "
                         f"module {path}")
    return _family_module(path)


@functools.lru_cache(maxsize=None)
def _family_module(path: Path):
    return load_module(path)


def driver(kind: str):
    """``drivers/<kind>.py``, which has ``run(cell, args, device) ->
    Run``."""
    import importlib
    return importlib.import_module(f"perfbench.drivers.{kind}")


@dataclass
class Run:
    """What a run measured and kept, for the end-to-end numbers, the
    metric readers and the comparison.

    ``units`` has one dict per unit of work completed in the window (a
    call, a request or a step), in order, with its shapes and its host
    spans (``*_ms``); ``traced`` the indices of the units inside the traced
    window; ``trace`` the device summary of that window (``trace.py``)."""

    kind: str
    config: dict
    traffic: dict
    setup_s: float = 0.0
    window_s: float = 0.0
    units: List[dict] = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    end_to_end: Dict[str, float] = field(default_factory=dict)
    traced: List[int] = field(default_factory=list)
    trace: Optional[dict] = None
    memory_peak_bytes: int = 0
    checks: List[dict] = field(default_factory=list)
    #: the compared numbers, and each control's by name (``calibrate.py``
    #: only)
    numbers: Dict[str, float] = field(default_factory=dict)
    control: Optional[Dict[str, Dict[str, float]]] = None

    def traced_units(self) -> List[dict]:
        return [self.units[i] for i in self.traced]


def forbidden_modules() -> List[str]:
    loaded = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN_MODULES))


def device_line(count: int, memory_peak_bytes: int,
                trace: Optional[dict]) -> dict:
    import torch
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": count, "memory_peak_bytes": int(memory_peak_bytes)}
    if trace is not None:
        out["busy_s"] = trace["busy_s"]
        out["window_s"] = trace["window_s"]
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> List[dict]:
    """Each compared number beside its limit; ``ok`` when it is at most
    the limit (a number that is missing or not finite fails)."""
    out = []
    for name, limit in limits.items():
        value = numbers.get(name)
        ok = (value is not None and value == value
              and value != float("inf") and value <= limit)
        out.append({"name": name, "value": value, "limit": limit,
                    "ok": bool(ok)})
    return out


def result_line(run: Run, metrics: Dict[str, dict], device: dict,
                breakdown: Optional[dict]) -> str:
    correct = bool(run.checks) and all(c["ok"] for c in run.checks)
    out = {"correct": correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in run.checks}
    return json.dumps(out)
