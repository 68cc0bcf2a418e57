"""Mean host time a ``synthesize`` call spends launching its device
programs (``collect_timings``' ``dispatch_ms``: inputs copied into the
captured programs' buffers, the replays, the outputs cloned), over the
window's calls outside the traced part."""

from perfbench.drivers.offline import per_unit_mean


def read(run):
    value = per_unit_mean(run.units, "dispatch_ms")
    return None if value != value else value
