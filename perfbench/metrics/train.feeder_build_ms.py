"""Host time the feeder's thread spends building a batch: the program's
``feeder.group`` spans (``.npz`` loads, sort, padding) over the batches
they built, for the groups built wholly inside the window's untraced steps
(from the first window step's ``train.step`` to the end of the last
untraced one).  Groups of the queue's first fill, of the traced part and
of the run's close, where the profiler or the comparison share the host
with the feeder, are left out."""


def read(run):
    try:
        from tacotron_tpu_torch.utils import trace
    except ImportError:
        return None
    check = run.traffic["check_steps"]
    untraced = len(run.units) - len(run.traced)
    steps = {r.unit: r for r in trace.records("train.step")
             if r.unit is not None and check <= r.unit < check + untraced}
    if check not in steps or check + untraced - 1 not in steps:
        return None
    start = steps[check].start_ns
    end = steps[check + untraced - 1].end_ns
    groups = [r for r in trace.records("feeder.group")
              if start <= r.start_ns and r.end_ns <= end]
    batches = sum(r.attrs.get("batches", 0) for r in groups)
    return sum(r.ms for r in groups) / batches if batches else None
