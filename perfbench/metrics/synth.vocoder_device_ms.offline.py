"""Mean device time of a ``synthesize`` call's vocoder (attention trim,
Griffin-Lim, the pack): ``collect_timings``' ``vocoder_device_ms``, the
device clock stamped inside each chunk's program after the decode and
after the pack, summed over the call's chunks, over the window's calls
outside the traced part."""

from perfbench.drivers.offline import per_unit_mean


def read(run):
    value = per_unit_mean(run.units, "vocoder_device_ms")
    return None if value != value else value
