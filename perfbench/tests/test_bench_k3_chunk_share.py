"""The reader of ``synth.k3_chunk_pct.offline`` on hand-built runs: the
share of the untraced calls' chunks whose vocoder ran the spectral-step
engine, and nothing where no untraced call reports ``chunks_k3``."""

import pytest

from perfbench import core


def _offline_run(units, traced=()):
    run = core.Run("offline", {}, {})
    run.units = [dict(u, traced=i in traced) for i, u in enumerate(units)]
    run.traced = list(traced)
    return run


@pytest.mark.parametrize("k3,traced,want", [
    ((2, 2, 0), [2], 100.0),
    ((2, 0, 2), [2], 50.0),
    ((2, 2, 2), [0, 1, 2], None),   # no untraced chunks
    (None, [2], None)])             # the parent reports no chunks_k3
def test_k3_chunk_share(k3, traced, want):
    units = [{"chunks": 2, "chunks_replayed": 2} for _ in range(3)]
    if k3 is not None:
        units = [dict(u, chunks_k3=n) for u, n in zip(units, k3)]
    run = _offline_run(units, traced=traced)
    assert core.metric_reader("synth.k3_chunk_pct.offline")(run) == want
