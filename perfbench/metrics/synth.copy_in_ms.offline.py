"""Mean host time a ``synthesize`` call spends copying its chunks' padded
inputs into the captured programs' static buffers (``collect_timings``'
``copy_in_ms``: the program's ``synth.copy_in`` spans summed over the
call's chunks), over the window's calls outside the traced part."""

from perfbench.drivers.offline import per_unit_mean


def read(run):
    value = per_unit_mean(run.units, "copy_in_ms")
    return None if value != value else value
