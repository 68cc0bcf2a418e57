"""The model family rule (``core.family``, ``families/<family>.py``) on the
CPU at ``small.py``'s widths: both configurations resolve to the Tacotron
family, which hands over the benchmark's own pieces unchanged; a second
family is a new file and a ``family`` key, which the offline driver's
set-up and check and the MFU reader use with no file edited; an unknown
family, or one without a training reference in a training cell, stops
set-up.  And the reader of ``k3.roofline_pct.offline`` on hand-built
runs."""

import json
import shutil

import pytest
import torch

from perfbench import check, core, flops
from perfbench.drivers.offline import least_call_seconds
from perfbench.reference import weights
from perfbench.reference.tacotron import Reference
from perfbench.tests import small

SEED = 2 ** 31 + 5


@pytest.mark.parametrize("name", ["tacotron_son_single",
                                  "deepvoice2_son_park"])
def test_configs_resolve_to_tacotron(name):
    raw = core.load_json(core.HERE / "configs" / f"{name}.json")
    family = core.family(raw)
    assert family is core.family({"family": "tacotron"})
    assert family.__file__ == str(core.HERE / "families" / "tacotron.py")
    cfg = raw["config"]
    small.shrink(cfg)
    m = cfg["model"]

    got = family.make_variables(m, SEED, small.CPU)
    want = weights.make_variables(m, SEED, small.CPU)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)

    budgets = [family.decode_budget(cfg, n) for n in range(1, 260)]
    assert budgets == [check.decode_budget(cfg, n) for n in range(1, 260)]
    assert set(budgets) <= set(check.STEP_LADDER) | {m["max_iters"]}

    assert family.frames_per_step(m) == m["reduction_factor"]
    assert family.forward_flops(m, 4, 64, 200) == \
        flops.forward_flops(m, 4, 64, 200)["total"]

    gen = torch.Generator().manual_seed(3)
    inputs = torch.randint(1, 60, (2, 32), generator=gen)
    lengths = torch.tensor([32, 20])
    speaker = torch.tensor([0, 1]) if m["num_speakers"] > 1 else None
    for precision in ("float32", "tf32"):
        ours = family.reference(got, m, precision).infer(
            inputs, lengths, speaker, 20)
        theirs = Reference(want, m, precision).infer(inputs, lengths,
                                                     speaker, 20)
        for key in ("alignments", "linear_outputs"):
            assert torch.equal(ours[key], theirs[key])


#: the Tacotron family under another name, with a decode budget ladder of
#: its own, its FLOPs doubled, one further sampled field and no training
#: reference; it records what the offline path asks of it
LADDER_FAMILY = '''
import math

import numpy as np

from perfbench import core

base = core.family({})
LADDER = (50, 250)
CALLS = []
SAMPLE_FIELDS = ("alignments",)


def make_variables(model, seed, device):
    CALLS.append("make_variables")
    return base.make_variables(model, seed, device)


def reference(variables, model, precision):
    CALLS.append("reference")
    return base.reference(variables, model, precision)


def decode_budget(cfg, n_tokens):
    CALLS.append("decode_budget")
    m = cfg["model"]
    need = math.ceil(m["steps_per_token"] * max(1, n_tokens))
    need = min(max(need, cfg["data"]["min_iters"]), m["max_iters"])
    return next((r for r in LADDER if need <= r <= m["max_iters"]),
                m["max_iters"])


def frames_per_step(model):
    CALLS.append("frames_per_step")
    return model["reduction_factor"]


def forward_flops(model, batch, t_in, t_out):
    CALLS.append("forward_flops")
    return 2.0 * base.forward_flops(model, batch, t_in, t_out)


def field_gaps(items, rows):
    CALLS.append("field_gaps")
    gap = 0.0
    for item, row in zip(items, rows):
        a = np.asarray(item["alignments"])
        r = row["alignments"].numpy()[:a.shape[0]]
        gap = max(gap, float(np.abs(a - r).max()) if a.shape == r.shape
                  else float("inf"))
    return {"alignments_gap": gap}
'''


def _snapshot(root):
    return {p.relative_to(root): p.read_bytes()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture
def ladder_tree(tmp_path, monkeypatch):
    """A copy of the benchmark with the ladder family, an offline cell and
    a training cell whose configurations name it; only new files."""
    bench = tmp_path / "perfbench"
    shutil.copytree(core.HERE, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = core.load_json(core.ROOT / "BENCHMARK.json")
    for name, base, traffic in (("ladder_offline", "tacotron_son_single",
                                 "offline_short"),
                                ("ladder_train", "deepvoice2_son_park",
                                 "train_live_b16")):
        raw = dict(core.load_json(bench / "configs" / f"{base}.json"),
                   family="tacotron_ladder")
        (bench / "configs" / f"{name}.json").write_text(json.dumps(raw))
        spec["configs"].append(dict(spec["configs"][0], name=name,
                                    file=f"perfbench/configs/{name}.json"))
        spec["workloads"].append({"name": name, "config": name,
                                  "traffic": traffic, "chips": 1,
                                  "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (bench / "families" / "tacotron_ladder.py").write_text(LADDER_FAMILY)
    limits = dict(core.load_json(bench / "limits" /
                                 "single_offline_short.json")["limits"],
                  alignments_gap=1e-6)
    (bench / "limits" / "ladder_offline.json").write_text(
        json.dumps({"limits": limits}))
    (bench / "limits" / "ladder_train.json").write_text(
        (bench / "limits" / "dv2_train_b16.json").read_text())
    monkeypatch.setattr(core, "HERE", bench)
    return tmp_path


def _small_cell(name, root):
    cell = core.find_cell(name, root=root)
    small.shrink(cell.config["config"])
    if cell.kind == "offline":
        cell.traffic.update(texts_per_call=4, check_sample=3,
                            trace_seconds=0.3)
    return cell


def test_second_family_runs_offline_from_files_alone(ladder_tree):
    before = _snapshot(ladder_tree / "perfbench")
    cell = _small_cell("ladder_offline", ladder_tree)
    family = core.family(cell.config)
    assert family.__file__ == str(core.HERE / "families" /
                                  "tacotron_ladder.py")
    run = small.run(cell, small.args(), ladder_tree)
    assert {"make_variables", "reference", "decode_budget",
            "field_gaps"} <= set(family.CALLS)
    assert run.checks and all(c["ok"] for c in run.checks), run.checks
    assert "alignments_gap" in {c["name"] for c in run.checks}
    assert run.numbers["alignments_gap"] == run.numbers["align_gap"]

    mfu = core.metric_reader("synth.mfu_pct.offline")(run)
    assert mfu is not None and mfu > 0
    assert "forward_flops" in family.CALLS
    unit = run.units[0]
    cfg = cell.config["config"]
    base = core.family({})
    extra = (least_call_seconds(family, cfg, run.traffic, unit)
             - least_call_seconds(base, cfg, run.traffic, unit))
    t_out = unit["steps"] * cfg["model"]["reduction_factor"]
    # 6-12 tokens: one 32-token bucket
    model = base.forward_flops(cfg["model"], unit["texts"], 32, t_out)
    assert extra == pytest.approx(model / flops.PEAK_F32_FLOPS)

    # every file of the copy is the repository's, or new
    after = _snapshot(ladder_tree / "perfbench")
    assert after == before
    for rel, data in _snapshot(core.ROOT / "perfbench").items():
        assert after[rel] == data, rel


def test_family_without_training_reference_stops_train_setup(ladder_tree):
    cell = _small_cell("ladder_train", ladder_tree)
    with pytest.raises(SystemExit, match="'tacotron_ladder'.*training"):
        small.run(cell, small.args(), ladder_tree)
    assert not (ladder_tree / ".perfbench_cache").exists()


@pytest.mark.parametrize("name", ["single_offline_short", "dv2_train_b16"])
def test_unknown_family_stops_setup(tmp_path, name):
    cell = small.cell(name)
    cell.config["family"] = "no_such_family"
    want = str(core.HERE / "families" / "no_such_family.py")
    with pytest.raises(SystemExit, match="no_such_family") as err:
        small.run(cell, small.args(), tmp_path)
    assert want in str(err.value)
    assert not (tmp_path / ".perfbench_cache").exists()


# ------------------------------------------------- k3.roofline_pct.offline

def _traced_long_run(groups, frames=(800, 800), traced=(1, 2)):
    cell = core.find_cell("single_offline_long")
    run = core.Run("offline", cell.config, cell.traffic)
    run.units = [{"frames": f, "traced": i in traced}
                 for i, f in enumerate((800,) + tuple(frames))]
    run.traced = list(traced)
    run.trace = None if groups is None else {"device_s_by_group": groups}
    return run


def test_k3_count_is_chip_smokes():
    # chip_smoke.py's count: the four products over F = n_fft / 2 + 1 bins
    assert flops.k3_iteration_flops(800, 2048) == 8 * 800 * 2048 * 1025
    assert flops.k3_iteration_flops(800, 2048) == pytest.approx(13.4e9,
                                                                rel=3e-3)
    # operations bound it at the long cell's 16 x 800 rows
    rows = 16 * 800
    assert flops.k3_iteration_seconds(rows, 2048) == \
        flops.k3_iteration_flops(rows, 2048) / flops.PEAK_BF16_FLOPS


@pytest.mark.parametrize("groups,want_least_over", [
    # two traced calls, two chunks of 16 x 800 rows, 60 iterations each
    ({"gl_spectral_dft": 0.1, "gl_spectral_idft": 0.08,
      "gl_spectral_cast": 0.02, "ola_centered": 0.5}, 0.2),
    ({"gl_spectral_dft": 0.05}, 0.05),
    ({"ola_centered": 0.5}, None),    # K3 did not run
    (None, None)])                     # no trace
def test_k3_roofline(groups, want_least_over):
    run = _traced_long_run(groups)
    got = core.metric_reader("k3.roofline_pct.offline")(run)
    if want_least_over is None:
        assert got is None
        return
    least = 2 * 2 * 60 * flops.k3_iteration_flops(16 * 800, 2048) \
        / flops.PEAK_BF16_FLOPS
    assert got == pytest.approx(100.0 * least / want_least_over)
