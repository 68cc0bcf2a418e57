"""The port's span recorder (``utils/trace.py``) and what the program
records with it, on the CPU:

- spans nest by thread: parent ids, unit ids inherited from the parent,
  self time; a bounded buffer keeps the newest records and counts the
  drops, of every thread; many threads at once lose no record;
- the feeder's and the prefetcher's threads record their spans with their
  own parents, the consumer's gets with a wait child when the queue was
  empty;
- ``synthesize`` records its phases under one unit id, a replayed chunk
  with copy-in and replay spans (the replay naming the chunk's engine) and
  an eager one (a capture miss) without, ``chunks_k3`` by the engine,
  a capture is a ``graph.capture`` span, the train step's spans by route;
- ``TraceWindow``'s idle-gap charging (``synth/profile.py::idle_by_span``)
  on synthetic device intervals and spans;
- no span reaches ``torch.profiler``.
"""

import dataclasses
import functools
import itertools
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tacotron_tpu_torch.config import Config as TorchConfig
from tacotron_tpu_torch.dsp.chip import SPECTRAL_STEP_ENGINES, resolve_engine
from tacotron_tpu_torch.synth import synthesizer as tsynth
from tacotron_tpu_torch.synth.profile import idle_by_span
from tacotron_tpu_torch.utils import graphs, trace
from test_torch_prewarm import AUDIO, MODEL, TEXTS, _train_setup


@pytest.fixture
def rec(monkeypatch):
    """A fresh process recorder for the test."""
    fresh = trace.Recorder()
    monkeypatch.setattr(trace, "RECORDER", fresh)
    return fresh


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def test_spans_nest_with_parents_units_and_self_time(rec):
    with trace.span("call", unit=7, texts=3) as call:
        with trace.span("phase.a"):
            time.sleep(0.002)
            with trace.span("phase.inner", unit=9):
                pass
        with trace.span("phase.b") as b:
            b.attrs["late"] = True
    with trace.span("other"):
        pass
    got = _by_name(rec.records())
    (c,) = got["call"]
    (a,) = got["phase.a"]
    (inner,) = got["phase.inner"]
    (pb,) = got["phase.b"]
    (other,) = got["other"]
    assert c.parent is None and other.parent is None
    assert a.parent == pb.parent == c.id and inner.parent == a.id
    assert (c.unit, a.unit, pb.unit, inner.unit) == (7, 7, 7, 9)
    assert other.unit is None
    assert c.attrs == {"texts": 3} and pb.attrs == {"late": True}
    assert c.start_ns <= a.start_ns <= a.end_ns <= pb.start_ns <= c.end_ns
    assert (call.start_ns, call.end_ns) == (c.start_ns, c.end_ns)
    # self time: the call's gaps between its children; a leaf's whole span
    assert trace.self_ns(c, rec.records()) == (
        c.end_ns - c.start_ns - (a.end_ns - a.start_ns)
        - (pb.end_ns - pb.start_ns))
    assert trace.self_ns(a, rec.records()) == (
        a.end_ns - a.start_ns - (inner.end_ns - inner.start_ns))
    assert trace.self_ns(pb, rec.records()) == pb.end_ns - pb.start_ns
    assert a.ms >= 2.0
    # records are listed in the order they closed; by name on request
    assert [r.name for r in rec.records()] == [
        "phase.inner", "phase.a", "phase.b", "call", "other"]
    assert rec.records("phase.a") == [a]


def test_span_closes_on_error(rec):
    with pytest.raises(RuntimeError):
        with trace.span("outer"):
            with trace.span("failing"):
                raise RuntimeError("boom")
    with trace.span("after"):
        pass
    got = _by_name(rec.records())
    assert got["failing"][0].parent == got["outer"][0].id
    assert got["after"][0].parent is None


def test_bounded_buffer_drops_the_oldest(monkeypatch):
    small = trace.Recorder(capacity=4)
    monkeypatch.setattr(trace, "RECORDER", small)
    for i in range(6):
        with trace.span("s", unit=i):
            pass
    assert [r.unit for r in small.records()] == [2, 3, 4, 5]
    assert small.dropped == 2


def _in_threads(threads: int, work) -> None:
    """``work(i)`` on ``threads`` threads at once, with a short switch
    interval."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work, args=(i,))
                for i in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)


def test_drops_counted_over_threads(monkeypatch):
    """Threads that come and go, a buffer far smaller than their spans:
    the kept and the dropped records add up to every span closed."""
    small = trace.Recorder(capacity=100)
    monkeypatch.setattr(trace, "RECORDER", small)
    threads, per = 8, 250

    def work(i):
        for j in range(per):
            with trace.span("s", unit=i):
                pass

    for _ in range(3):
        _in_threads(threads, work)
    assert len(small.records()) == 100
    assert small.dropped == 3 * threads * per - 100


def test_threads_lose_no_record(rec):
    """More threads than cores, a short switch interval: every span
    arrives, each under its own thread's parent."""
    threads, per = 16, 300

    def work(i):
        for j in range(per):
            with trace.span("outer", unit=i):
                with trace.span("inner"):
                    pass

    _in_threads(threads, work)
    got = rec.records()
    assert rec.dropped == 0
    assert len(got) == 2 * threads * per
    outers = {r.id: r for r in got if r.name == "outer"}
    for r in got:
        if r.name == "inner":
            parent = outers[r.parent]
            assert parent.thread == r.thread and parent.unit == r.unit


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from tacotron_tpu_torch.data.synthetic import write_synthetic_corpus
    cfg = _small_train_config()
    return write_synthetic_corpus(str(tmp_path_factory.mktemp("corpus")),
                                  cfg, seed=1)


def _small_train_config():
    cfg = TorchConfig.from_dict({"audio": AUDIO, "model": MODEL})
    return cfg.replace(
        data=dataclasses.replace(cfg.data, batches_per_group=2),
        train=dataclasses.replace(cfg.train, batch_size=2))


def test_feeder_and_prefetcher_threads_keep_their_parents(rec, corpus):
    from tacotron_tpu_torch.data.feeder import DataFeeder
    from tacotron_tpu_torch.parallel.prefetch import DevicePrefetcher
    feeder = DataFeeder(corpus, _small_train_config(), seed=3)
    batches = feeder.batches()

    def slow_source():
        time.sleep(0.05)   # the first get finds the queue empty
        return next(batches)

    prefetcher = DevicePrefetcher(slow_source, "cpu", depth=2)
    try:
        with trace.span("loop", unit=-1) as loop:
            got = [prefetcher.get(timeout=30) for _ in range(5)]
    finally:
        prefetcher.stop()
    assert len(got) == 5
    spans = _by_name(rec.records())
    me = threading.get_ident()
    gets = spans["prefetch.get"]
    assert [r.unit for r in gets] == [0, 1, 2, 3, 4]
    assert all(r.parent == loop.id and r.thread == me for r in gets)
    waits = spans["prefetch.wait"]
    assert waits
    by_id = {r.id: r for r in gets}
    assert all(by_id[w.parent].unit == w.unit for w in waits)
    assert gets[0].id in {w.parent for w in waits}
    copies = spans["prefetch.copy"]
    assert [r.unit for r in copies[:5]] == [0, 1, 2, 3, 4]
    assert all(r.parent is None and r.thread != me for r in copies)
    groups = spans["feeder.group"]
    # built on the producer's thread (it iterates the source), 2 batches a
    # group, outside any span
    assert len(groups) >= 3
    assert all(r.thread == copies[0].thread and r.parent is None
               and r.attrs == {"batches": 2} for r in groups)


def _synth():
    cfg = TorchConfig.from_dict({"audio": AUDIO, "model": MODEL})
    return tsynth.Synthesizer(device="cpu").init_random(cfg, seed=2)


def test_synthesize_spans_and_chunk_routes(rec):
    ts = _synth()
    kw = dict(speaker_ids=[0, 1, 1], max_steps=4, fast_vocoder=True,
              librosa_trim=False, collect_timings=True)
    assert ts.prewarm(**ts.prewarm_args(TEXTS, max_steps=4,
                                        fast_vocoder=True)) == 1
    (cap,) = rec.records("graph.capture")
    assert cap.attrs["owner"] == "synth" and cap.ms > 0.0
    res = ts.synthesize(TEXTS, **kw)
    # another chunk size (one text: a chunk of 1) was not captured: the
    # chunk runs eagerly, with neither copy-in nor replay span
    miss = ts.synthesize(TEXTS[:1], **kw)["timings"]
    assert (miss["chunks"], miss["chunks_replayed"]) == (1, 0)
    assert miss["copy_in_ms"] == miss["replay_ms"] == 0.0

    calls = rec.records("synth.call")
    assert len(calls) == 2 and calls[0].unit != calls[1].unit
    assert calls[1].attrs == {"texts": 1, "chunks": 1, "arch": "tacotron"}
    assert not [r for r in rec.records() if r.unit == calls[1].unit
                and r.name in ("synth.copy_in", "synth.replay")]
    first = calls[0]
    assert first.attrs == {"texts": 3, "chunks": 1, "arch": "tacotron"}
    mine = [r for r in rec.records() if r.unit == first.unit
            and r.name != "synth.call"]
    names = _by_name(mine)
    assert set(names) == {"synth.frontend", "synth.copy_in", "synth.replay",
                          "synth.fetch", "synth.device_wait", "synth.unpack"}
    for r in mine:
        parent = (names["synth.fetch"][0].id if r.name == "synth.device_wait"
                  else first.id)
        assert r.parent == parent, r.name
    t = res["timings"]
    assert t["copy_in_ms"] == names["synth.copy_in"][0].ms
    assert t["replay_ms"] == names["synth.replay"][0].ms
    assert t["device_ms"] == names["synth.device_wait"][0].ms
    assert (t["chunks"], t["chunks_replayed"]) == (1, 1)
    assert t["decode_device_ms"] > 0.0 and t["vocoder_device_ms"] > 0.0
    assert t["total_ms"] <= first.ms


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_replay_spans_name_the_engine_and_k3_chunks_count(rec, impl):
    """Each ``synth.replay`` span carries its chunk's engine, and
    ``chunks_k3`` counts the chunks (replayed or eager) whose engine is the
    spectral-step engine; on the CPU "auto" resolves to matmul_half."""
    cfg = TorchConfig.from_dict({"audio": dict(AUDIO, griffin_lim_impl=impl),
                                 "model": MODEL})
    ts = tsynth.Synthesizer(device="cpu").init_random(cfg, seed=2)
    engine = resolve_engine(cfg.audio, 4 * cfg.model.reduction_factor,
                            "cpu")
    assert engine == {"auto": "matmul_half", "pallas": "pallas"}[impl]
    kw = dict(speaker_ids=[0, 1, 1], max_steps=4, librosa_trim=False,
              collect_timings=True)
    ts.prewarm(**ts.prewarm_args(TEXTS, max_steps=4))
    replayed = ts.synthesize(TEXTS, **kw)["timings"]
    eager = ts.synthesize(TEXTS[:1], **kw)["timings"]
    (replay,) = rec.records("synth.replay")
    # the CPU launches no K4 (tests/test_torch_bigru_route.py counts it)
    assert replay.attrs == {"engine": engine, "k4": 0}
    for t, replays in ((replayed, 1), (eager, 0)):
        assert (t["chunks"], t["chunks_replayed"]) == (1, replays)
        assert t["chunks_k3"] == (t["chunks"] if engine in
                                  SPECTRAL_STEP_ENGINES else 0)


def test_chunk_stamps_are_ordered():
    ts = _synth()
    seqs = torch.zeros((2, 32), dtype=torch.int64)
    seqs[:, 0] = 5
    packed, aligns, stamps = ts._vocode_chunk(
        seqs, torch.ones(2, dtype=torch.int64),
        torch.zeros(2, dtype=torch.int64), None, torch.tensor(False), 4,
        True, True, "int16")
    # before the encoder, after it, after the decoder loop, after the
    # post-net, after the pack
    s0, s1, s2, s3, s4 = stamps.tolist()
    assert stamps.dtype == torch.int64 and 0 < s0 <= s1 <= s2 <= s3 <= s4


def test_train_step_spans_by_route(rec):
    from tacotron_tpu_torch.train.step import make_train_step
    tcfg, batch, new_state = _train_setup()
    state = new_state()
    step_fn = make_train_step(tcfg)
    step_fn.prewarm(state, [batch])
    assert [r.attrs["owner"] for r in rec.records("graph.capture")] == \
        ["train"]
    step_fn(state, batch, 0)
    other = batch._replace(**{k: getattr(batch, k)[:2] for k in (
        "inputs", "input_lengths", "loss_coeff", "mel_targets",
        "linear_targets", "speaker_id", "target_lengths")})
    step_fn(state, other, 0)
    steps = rec.records("train.step")
    assert [r.unit for r in steps] == [0, 1]
    kids = _by_name(r for r in rec.records() if r.parent is not None)
    assert [r.parent for r in kids["train.copy_in"]] == [steps[0].id]
    assert [r.parent for r in kids["train.replay"]] == [steps[0].id]
    assert [r.parent for r in kids["train.eager_step"]] == [steps[1].id]
    assert all(r.unit == 0 for r in kids["train.replay"])


def _rec(name, rid, start_us, end_us, parent=None):
    return trace.Record(name, rid, parent, None, int(start_us * 1e3),
                        int(end_us * 1e3), 0, {})


def test_idle_gaps_charged_to_the_innermost_open_span():
    # device busy [10, 20) and [15, 30) (one union), [50, 60), [95, 120)
    intervals = [("k", 10, 20), ("k", 15, 30), ("k", 50, 60),
                 ("k", 95, 120)]
    spans = [_rec("call", 1, 0, 80), _rec("fetch", 2, 30, 45, parent=1),
             _rec("unpack", 3, 62, 80, parent=1)]
    got = idle_by_span(intervals, spans, (0.0, 100.0))
    # gaps: [0, 10) mid 5 -> call; [30, 50) mid 40 -> fetch;
    # [60, 95) mid 77.5 -> unpack; the window ends inside the last kernel
    assert got == pytest.approx({"call": 0.010, "fetch": 0.020,
                                 "unpack": 0.035})
    # nothing open at a gap's midpoint
    got = idle_by_span([("k", 0, 10)], [], (0.0, 30.0))
    assert got == pytest.approx({"outside the program's spans": 0.020})
    # an idle window is one gap
    assert idle_by_span([], [_rec("x", 1, 0, 10)], (0.0, 10.0)) == \
        pytest.approx({"x": 0.010})


def test_no_span_reaches_the_profiler(rec):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("synth.call"):
            torch.ones(8).sum()
    names = {e.name for e in prof.events()}
    assert "synth.call" not in names
    assert rec.records("synth.call")


def test_graph_capture_span_on_cpu(rec):
    set_ = graphs.GraphSet("cpu", owner="test")
    g = set_.capture(lambda x: x + 1, torch.zeros(3))
    g(torch.ones(3))
    (cap,) = rec.records("graph.capture")
    assert cap.attrs == {"owner": "test",
                         "key": (((3,), torch.float32),)}
    assert g.replays == 1


def test_span_cost_is_small():
    """A guard against an accidental slow path (a profiler range, a
    formatted string): a span on this machine's CPU costs microseconds."""
    r = trace.Recorder()
    n = 20000
    t0 = time.perf_counter()
    for _ in range(n):
        with r.span("x"):
            pass
    per_us = (time.perf_counter() - t0) / n * 1e6
    assert per_us < 50.0, per_us


def test_prefetcher_source_order_with_spans(rec):
    """The spans leave the prefetcher's order as it was."""
    from tacotron_tpu_torch.parallel.prefetch import DevicePrefetcher
    from tacotron_tpu_torch.train.step import Batch
    counter = itertools.count()
    src = functools.partial(
        lambda c: Batch(*([np.full((1,), next(c), np.int32)] * 6)), counter)
    prefetcher = DevicePrefetcher(src, "cpu", depth=3)
    try:
        got = [int(prefetcher.get(timeout=10).inputs[0]) for _ in range(6)]
    finally:
        prefetcher.stop()
    assert got == list(range(6))
    assert [r.unit for r in rec.records("prefetch.get")] == list(range(6))
