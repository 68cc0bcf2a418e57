"""Seconds of the run spent capturing the program's CUDA graphs (the
program's ``graph.capture`` spans: each warm-up and capture), all in
set-up."""


def read(run):
    try:
        from tacotron_tpu_torch.utils import trace
    except ImportError:
        return None
    captures = trace.records("graph.capture")
    return sum(r.ms for r in captures) / 1e3 if captures else None
