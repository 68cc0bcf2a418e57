"""Tacotron 2's decoder step against its roofline: the least time of the
step, the larger of its matrix-product FLOPs (the model family's
``decoder_step_flops`` at each chunk's padded rows and the call's padded
token bucket) at the float32 peak and its weight bytes
(``decoder_step_bytes``) at the HBM peak, over the measured step
(``synth.decoder_step_us.offline``).  At 16 rows the bytes govern: the
step does about 8 FLOP a byte against a ridge of 20.  A family without
those counts, or a program that does not report the decoder's device
time, gives nothing."""

from perfbench import core, flops
from perfbench.drivers.offline import chunks
from perfbench.traffic import generate


def read(run):
    family = core.family(run.config)
    step_us = core.metric_reader("synth.decoder_step_us.offline")(run)
    if step_us is None or not hasattr(family, "decoder_step_flops"):
        return None
    mix = run.traffic
    lo, hi = mix["tokens"]
    t_in = -(-max(generate.token_counts(lo, hi, mix["texts_per_call"]))
             // 32) * 32
    model = run.config["config"]["model"]
    sizes = [1 << (n - 1).bit_length() for n in chunks(mix)]
    step_s = sum(max(family.decoder_step_flops(model, nb, t_in)
                     / flops.PEAK_F32_FLOPS,
                     family.decoder_step_bytes(model) / flops.PEAK_BYTES)
                 for nb in sizes) / len(sizes)
    return 100.0 * step_s / (step_us * 1e-6)
