"""On the card, at the cells' own sizes: a sound run passes its limits
and the control (the reference one precision below the configuration's in
the program's place) does not.  ``python3 -m pytest perfbench/tests -q -m
chip``; skips without the card."""

import types

import pytest

from perfbench import check, core


@pytest.mark.chip
@pytest.mark.parametrize("name", ["single_offline_short",
                                  "single_offline_long", "dv2_train_b16"])
def test_sound_run_and_control_on_card(card, name):
    cell = core.find_cell(name)
    args = types.SimpleNamespace(seed=2 ** 31 + 99, seconds=1.0, trace=0,
                                 control=True)
    run = core.driver(cell.kind).run(cell, args, card)
    assert all(c["ok"] for c in run.checks), run.checks
    control = core.judge(run.control[check.CONTROL[cell.kind]],
                         cell.limits["limits"])
    assert not all(c["ok"] for c in control), run.control
