"""Mean host time a get of the window spends blocked on the prefetcher's
empty queue (the program's ``prefetch.wait`` spans inside each
``prefetch.get``; 0 for a get that found a batch waiting), over the steps
outside the traced part.  The window's gets are those after the check
steps, in the order of ``run.units`` (a get's unit id is its ordinal)."""


def read(run):
    try:
        from tacotron_tpu_torch.utils import trace
    except ImportError:
        return None
    check = run.traffic["check_steps"]
    waits = {}
    for r in trace.records("prefetch.wait"):
        waits[r.parent] = waits.get(r.parent, 0.0) + r.ms
    traced = set(run.traced)
    values = [waits.get(r.id, 0.0)
              for r in trace.records("prefetch.get")
              if r.unit is not None
              and 0 <= r.unit - check < len(run.units)
              and r.unit - check not in traced]
    return sum(values) / len(values) if values else None
