"""K3 (the spectral step, ``ops/kernels/griffin_lim.py``): the least time
of the traced calls' steps (one per Griffin-Lim iteration of each chunk,
over the chunk's padded size times the call's frames; the larger of their
operations at the bf16 peak and their bytes at the HBM peak, ``flops.py``)
over the device time of K3's three kernels in the trace."""

from perfbench import flops
from perfbench.drivers.offline import chunks
from perfbench.trace import K3_GROUPS
from perfbench.traffic import generate


def read(run):
    if run.trace is None:
        return None
    device_s = sum(run.trace["device_s_by_group"].get(g, 0.0)
                   for g in K3_GROUPS)
    if device_s <= 0.0:
        return None
    audio = run.config["config"]["audio"]
    n_fft = (audio["num_freq"] - 1) * 2
    iters, _ = generate.griffin_lim(run.traffic, audio)
    least = 0.0
    for unit in run.traced_units():
        for n in chunks(run.traffic):
            nb = 1 << (n - 1).bit_length()
            least += iters * flops.k3_iteration_seconds(nb * unit["frames"],
                                                        n_fft)
    return 100.0 * least / device_s
