"""Mean device time of a ``synthesize`` call's decode (encoder, attention
decoder and post-net): ``collect_timings``' ``decode_device_ms``, the
device clock stamped inside each chunk's program before and after the
decode, summed over the call's chunks, over the window's calls outside the
traced part."""

from perfbench.drivers.offline import per_unit_mean


def read(run):
    value = per_unit_mean(run.units, "decode_device_ms")
    return None if value != value else value
