"""Mean device time of a ``synthesize`` call's post-net (with Tacotron 2's
mel -> linear): ``collect_timings``' ``postnet_device_ms``, the device
clock stamped inside each chunk's program after the decoder loop and after
the post-net, summed over the call's chunks, over the window's calls
outside the traced part.  A program that does not report
``postnet_device_ms`` gives nothing."""

from perfbench.drivers.offline import per_unit_mean


def read(run):
    value = per_unit_mean(run.units, "postnet_device_ms")
    return None if value != value else value
