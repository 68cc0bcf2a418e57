"""The readers of the program's spans (``metrics/<name>.py`` over the
port's ``utils/trace.py``): each on a hand-built ``Run`` and recorder gives
the expected value, and nothing where its data is missing; the train
readers leave out the check steps and the traced steps.

On the card (``-m chip``): a program span closed at a synchronize holds
the device interval of the kernel it waited for (the profiler and the
recorder share the Unix-epoch clock, to within 1 ms), no program span is
a device event, back-to-back stamps step by at most 10 us; printed: the
two clocks' offsets, the stamps' steps, a span's host cost and the device
cost of a chunk's stamps."""

import json

import pytest

from perfbench import core

trace = pytest.importorskip("tacotron_tpu_torch.utils.trace")

CHECK = 3


@pytest.fixture
def rec(monkeypatch):
    fresh = trace.Recorder()
    monkeypatch.setattr(trace, "RECORDER", fresh)
    return fresh


def _add(rec, name, rid, ms, unit=None, parent=None, start_ms=0.0,
         **attrs):
    """A closed span of ``ms`` from ``start_ms`` in the recorder's
    buffer."""
    start = int(start_ms * 1e6)
    rec._buf.append(trace.Record(name, rid, parent, unit, start,
                                 start + int(ms * 1e6), 0, attrs))


def _read(name, run):
    return core.metric_reader(name)(run)


def _offline_run(units, traced=()):
    run = core.Run("offline", {}, {})
    run.units = [dict(u, traced=i in traced) for i, u in enumerate(units)]
    run.traced = list(traced)
    return run


def _train_run(n_units, traced=()):
    run = core.Run("train", {}, {"check_steps": CHECK})
    run.units = [{"traced": i in traced} for i in range(n_units)]
    run.traced = list(traced)
    return run


@pytest.mark.parametrize("name,key", [
    ("synth.copy_in_ms.offline", "copy_in_ms"),
    ("synth.decode_device_ms.offline", "decode_device_ms"),
    ("synth.vocoder_device_ms.offline", "vocoder_device_ms")])
def test_offline_means_leave_out_the_traced_calls(name, key):
    run = _offline_run([{key: 2.0}, {key: 4.0}, {key: 100.0}], traced=[2])
    assert _read(name, run) == pytest.approx(3.0)
    # a --trace 0 run's units, or the parent's, carry no such key
    assert _read(name, _offline_run([{"wall_s": 1.0}])) is None


def test_graph_hit_share():
    run = _offline_run([{"chunks": 2, "chunks_replayed": 2},
                        {"chunks": 2, "chunks_replayed": 1},
                        {"chunks": 2, "chunks_replayed": 0}], traced=[2])
    assert _read("synth.graph_hit_pct.offline", run) == pytest.approx(75.0)
    assert _read("synth.graph_hit_pct.offline",
                 _offline_run([{"wall_s": 1.0}])) is None


def test_queue_wait_over_the_untraced_window_gets(rec):
    # gets 0-2 are the check steps; window gets 3-6 are units 0-3, unit 3
    # traced
    waits = {0: 50.0, 2: 7.0, 3: 1.5, 5: 4.0, 6: 9.0}
    rid = 0
    for get in range(7):
        _add(rec, "prefetch.get", rid, 10.0, unit=get)
        if get in waits:
            _add(rec, "prefetch.wait", rid + 1, waits[get], unit=get,
                 parent=rid)
        rid += 2
    run = _train_run(4, traced=[3])
    # units 0, 1, 2: gets 3 (1.5), 4 (no wait), 5 (4.0)
    assert _read("train.queue_wait_ms", run) == pytest.approx(5.5 / 3)


def test_step_host_ms_over_the_untraced_window_steps(rec):
    for step, ms in enumerate([90.0, 80.0, 70.0, 1.0, 2.0, 3.0, 60.0]):
        _add(rec, "train.step", step, ms, unit=step)
    assert _read("train.step_host_ms", _train_run(4, traced=[3])) == \
        pytest.approx(2.0)


def test_feeder_build_ms_per_batch(rec):
    # steps 0-2 check, 3-5 the untraced window (100-400 ms), 6 traced
    for step in range(7):
        _add(rec, "train.step", step, 100.0, unit=step,
             start_ms=100.0 * (step - 2))
    run = _train_run(4, traced=[3])
    assert _read("train.feeder_build_ms", run) is None
    for rid, (start, ms) in enumerate([(10.0, 40.0),      # the first fill
                                       (120.0, 80.0),
                                       (250.0, 140.0),
                                       (380.0, 120.0),    # into the trace
                                       (600.0, 8400.0)]):  # the close
        _add(rec, "feeder.group", 10 + rid, ms, start_ms=start, batches=32)
    assert _read("train.feeder_build_ms", run) == \
        pytest.approx(220.0 / 64)


def test_capture_seconds(rec):
    _add(rec, "graph.capture", 0, 1500.0, owner="train")
    _add(rec, "graph.capture", 1, 500.0, owner="train")
    assert _read("setup.capture_s", _train_run(1)) == pytest.approx(2.0)


@pytest.mark.parametrize("name", ["train.queue_wait_ms",
                                  "train.step_host_ms",
                                  "train.feeder_build_ms",
                                  "setup.capture_s"])
def test_span_readers_give_nothing_without_spans(rec, name):
    assert _read(name, _train_run(4)) is None


def test_train_readers_give_nothing_for_the_check_steps_alone(rec):
    for step in range(CHECK):
        _add(rec, "train.step", step, 5.0, unit=step)
        _add(rec, "prefetch.get", 100 + step, 5.0, unit=step)
    run = _train_run(0)
    assert _read("train.step_host_ms", run) is None
    assert _read("train.queue_wait_ms", run) is None


@pytest.mark.chip
def test_spans_beside_the_device_trace_on_card(card):
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tacotron_tpu_torch.ops.kernels.stamp import stamp
    from tacotron_tpu_torch.utils.graphs import GraphSet

    slots = torch.zeros(3, dtype=torch.int64, device=card)

    def stamps(x):
        for i in range(3):
            stamp(x, i)
        return x.clone()

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        graph = GraphSet(card, owner="check").capture(stamps, slots)
        with trace.span("check.sleep") as span:
            torch.cuda._sleep(20_000_000)     # ~10 ms
            torch.cuda.synchronize()
        graph(slots)
        torch.cuda.synchronize()
    device = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    # the spin: the trace's one long kernel
    spin = max(device, key=lambda e: e.duration_ns())
    assert spin.duration_ns() > 5_000_000, spin.name()
    start = spin.start_ns()
    end = start + spin.duration_ns()
    names = {r.name for r in trace.records()}
    s = graph.outputs.tolist()

    # the timer's resolution: back-to-back stamps queued behind a spin run
    # a few us apart on the device, so a tick above 10 us would show as
    # steps of 0 and of a tick or more
    ticks = torch.zeros(256, dtype=torch.int64, device=card)
    torch.cuda._sleep(20_000_000)
    for i in range(ticks.shape[0]):
        stamp(ticks, i)
    steps = sorted((ticks[1:] - ticks[:-1]).tolist())
    # a span's host cost
    r = trace.Recorder()
    n = 100_000
    t0 = time.perf_counter()
    for _ in range(n):
        with r.span("x"):
            pass
    span_us = (time.perf_counter() - t0) / n * 1e6
    # a chunk's stamps on the device: three stamp nodes and the clone,
    # replayed behind a spin so the host's launch is hidden
    reps = 200
    begin, finish = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(20_000_000)
    begin.record()
    for _ in range(reps):
        graph.replay()
    finish.record()
    torch.cuda.synchronize()
    print("clock-check " + json.dumps({
        "launch_to_kernel_us": (start - span.start_ns) / 1e3,
        "kernel_end_to_span_end_us": (span.end_ns - end) / 1e3,
        "stamp_steps_ns": {"min": steps[0], "median": steps[len(steps) // 2],
                           "max": steps[-1]},
        "span_us": span_us,
        "stamps_and_clone_us": begin.elapsed_time(finish) * 1e3 / reps,
        "card": torch.cuda.get_device_name(0)}), flush=True)
    # the span holds the kernel it waited for; the profiler maps the
    # device's clock onto the host's to within a few hundred us (one run
    # on the H100 put the kernel's start 273 us before the span's), so the
    # two intervals are compared to 1 ms
    assert spin.duration_ns() <= span.end_ns - span.start_ns
    assert span.start_ns - 1_000_000 <= start \
        and end <= span.end_ns + 1_000_000, (
            span.start_ns, start, end, span.end_ns)
    assert names & {"check.sleep", "graph.capture"}
    assert not names & {e.name() for e in device}
    assert 0 < s[0] <= s[1] <= s[2]
    assert steps[0] >= 0 and 0 < steps[-1] <= 10_000, steps
