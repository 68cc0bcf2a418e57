"""The harness: cells, configurations, mixes and metrics found by name;
the result line's shape; the import guard."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path


from perfbench import core
from perfbench.run import report

ROOT = core.ROOT


def test_every_cell_resolves():
    spec = core.load_json(ROOT / "BENCHMARK.json")
    for w in spec["workloads"]:
        cell = core.find_cell(w["name"])
        assert cell.kind in ("offline", "train", "serve")
        core.driver(cell.kind)
        assert set(cell.limits["limits"])
        for metric in cell.metrics_for(True):
            assert callable(core.metric_reader(metric["name"]))
        names = [m["name"] for m in cell.metrics_for(False)]
        assert "setup_s" in names and len(names) >= 2
        assert cell.metrics_for(True)


def test_dummy_cell_found_by_name(tmp_path, monkeypatch):
    """A new cell, configuration, mix and metric are files and entries."""
    bench = tmp_path / "perfbench"
    shutil.copytree(core.HERE, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = core.load_json(ROOT / "BENCHMARK.json")
    spec["configs"].append(dict(spec["configs"][0], name="dummy_cfg",
                                file="perfbench/configs/dummy_cfg.json"))
    spec["workloads"].append({"name": "dummy_cell", "config": "dummy_cfg",
                              "traffic": "dummy_mix", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "dummy.metric", "unit": "ms",
                              "better": "lower", "source": "host_clock",
                              "layer": "device", "moves": "audio_s_per_s",
                              "workloads": ["dummy_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    shutil.copy(bench / "configs" / "tacotron_son_single.json",
                bench / "configs" / "dummy_cfg.json")
    mix = dict(core.load_json(bench / "traffic" / "offline_short.json"),
               texts_per_call=3)
    (bench / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    (bench / "limits" / "dummy_cell.json").write_text(
        json.dumps({"limits": {"align_gap": 1.0}}))
    (bench / "metrics" / "dummy.metric.py").write_text(
        "def read(run):\n    return 42.0 + len(run.units)\n")
    monkeypatch.setattr(core, "HERE", bench)
    cell = core.find_cell("dummy_cell", root=tmp_path)
    assert cell.traffic["texts_per_call"] == 3
    assert cell.kind == "offline"
    assert [m["name"] for m in cell.metrics_for(True)][-1] == "dummy.metric"
    run = core.Run("offline", cell.config, cell.traffic, units=[{}])
    assert core.metric_reader("dummy.metric")(run) == 43.0


def test_result_line_shape():
    cell = core.find_cell("single_offline_long")
    run = core.Run("offline", cell.config, cell.traffic, setup_s=12.5,
                   attempted=64, end_to_end={"audio_s_per_s": 700.0})
    run.checks = core.judge({"align_gap": 1e-7, "wave_gap": 0.2,
                             "length_mismatch": 0.0}, cell.limits["limits"])
    args = type("A", (), {"trace": 0})()
    device = {"platform": "gpu", "kind": "card", "count": 1,
              "memory_peak_bytes": 1}
    line = json.loads(report(cell, args, run, device))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True
    assert line["metrics"] == {"audio_s_per_s": {"value": 700.0,
                                                 "unit": "audio_s/s"},
                               "setup_s": {"value": 12.5, "unit": "s"}}
    assert set(line["checks"]) == set(cell.limits["limits"])
    run.checks = core.judge({"align_gap": float("nan")},
                            cell.limits["limits"])
    assert json.loads(report(cell, args, run, device))["correct"] is False


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_forbidden_import_in_harness():
    """No file the benchmark runs imports a module whose top-level name
    is, whole, one of the JAX package's (the port's name starts with it)."""
    files = [p for p in core.HERE.rglob("*.py") if "tests" not in p.parts]
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in core.FORBIDDEN_MODULES, \
                (path, name)


def test_reference_imports_no_program():
    for path in (core.HERE / "reference").glob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] in ("__future__", "math", "typing",
                                          "torch"), (path, name)


def test_runtime_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tacotron_tpu_torch_fake", object())
    assert "tacotron_tpu" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tacotron_tpu.fake", object())
    assert core.forbidden_modules() == ["tacotron_tpu"]


def _run(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload",
         "single_offline_long", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=120)


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(core.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
