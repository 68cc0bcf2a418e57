"""K2 (the overlap-add kernel, ``ops/kernels/ola.py``): the least time of
the traced calls' overlap-adds (each chunk's zero-phase start and one per
Griffin-Lim iteration, bound by their bytes at the HBM peak;
``flops.py``) over K2's device time in the trace."""

from perfbench import flops
from perfbench.drivers.offline import chunks
from perfbench.trace import K2_GROUPS
from perfbench.traffic import generate


def read(run):
    if run.trace is None:
        return None
    device_s = sum(run.trace["device_s_by_group"].get(g, 0.0)
                   for g in K2_GROUPS)
    if device_s <= 0.0:
        return None
    audio = run.config["config"]["audio"]
    n_fft = (audio["num_freq"] - 1) * 2
    hop = int(audio["frame_shift_ms"] / 1000 * audio["sample_rate"])
    iters, _ = generate.griffin_lim(run.traffic, audio)
    least = 0.0
    for unit in run.traced_units():
        for n in chunks(run.traffic):
            nb = 1 << (n - 1).bit_length()
            least += (iters + 1) * flops.k2_call_seconds(
                nb, unit["frames"], n_fft, hop)
    return 100.0 * least / device_s
