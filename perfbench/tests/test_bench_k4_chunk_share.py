"""The reader of ``synth.k4_chunk_pct.offline`` on hand-built runs: the
share of the untraced calls' chunks whose decode ran the GRU kernel, and
nothing where no untraced call reports ``chunks_k4``."""

import pytest

from perfbench import core


def _offline_run(units, traced=()):
    run = core.Run("offline", {}, {})
    run.units = [dict(u, traced=i in traced) for i, u in enumerate(units)]
    run.traced = list(traced)
    return run


@pytest.mark.parametrize("k4,traced,want", [
    ((2, 2, 0), [2], 100.0),
    ((2, 1, 2), [2], 75.0),
    ((0, 0, 2), [2], 0.0),
    ((2, 2, 2), [0, 1, 2], None),   # no untraced chunks
    (None, [2], None)])             # the parent reports no chunks_k4
def test_k4_chunk_share(k4, traced, want):
    units = [{"chunks": 2, "chunks_replayed": 2} for _ in range(3)]
    if k4 is not None:
        units = [dict(u, chunks_k4=n) for u, n in zip(units, k4)]
    run = _offline_run(units, traced=traced)
    assert core.metric_reader("synth.k4_chunk_pct.offline")(run) == want
