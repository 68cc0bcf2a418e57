"""Mean device time of one decoder step, in microseconds:
``collect_timings``' ``decoder_device_ms`` (the device clock stamped
inside each chunk's program after the encoder and after the decoder loop,
summed over the call's chunks) over the call's decode steps times its
chunks, averaged over the window's calls outside the traced part.  A
program that does not report ``decoder_device_ms`` gives nothing."""

import numpy as np


def read(run):
    values = [1e3 * u["decoder_device_ms"] / (u["steps"] * u["chunks"])
              for u in run.units
              if "decoder_device_ms" in u and not u["traced"]]
    return float(np.mean(values)) if values else None
