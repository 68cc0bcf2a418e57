"""Mean host time of a window step's call into the train step (the
program's ``train.step`` span: the batch copied into the captured step's
buffers and the replay launched), over the steps outside the traced part.
A step's unit id is its number; the window's steps follow the check
steps."""


def read(run):
    try:
        from tacotron_tpu_torch.utils import trace
    except ImportError:
        return None
    check = run.traffic["check_steps"]
    traced = set(run.traced)
    values = [r.ms for r in trace.records("train.step")
              if r.unit is not None
              and 0 <= r.unit - check < len(run.units)
              and r.unit - check not in traced]
    return sum(values) / len(values) if values else None
