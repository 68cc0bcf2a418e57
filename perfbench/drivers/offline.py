"""A batch job: back-to-back ``Synthesizer.synthesize`` calls of
``texts_per_call`` texts each, the captured programs replayed.

Set-up looks up the model family of the cell's configuration
(``core.family``), draws its weights from the seed, loads them into the
program,
captures the one program key the job's calls use (every call has the same
token counts in another order, so one token bucket and one decode budget)
and runs one untimed call.  The window then calls until ``--seconds`` have
passed; ``audio_s_per_s`` is the audio of every completed call over the
window's wall time.  A reservoir drawn from the seed keeps
``check_sample`` of the window's utterances, which the reference decodes
and vocodes again once the window has closed, with the family's further
``SAMPLE_FIELDS`` of each.
"""

from __future__ import annotations

import gc
import time
from typing import List

import numpy as np
import torch

from .. import check
from ..core import Cell, Run, family as model_family, process_start_time
from ..trace import TraceWindow
from ..traffic import generate


def program(cell: Cell, family, seed: int, device):
    """The program under test, loaded with the family's weights drawn from
    the seed; returns (synthesizer, variables)."""
    from tacotron_tpu_torch.config import Config
    from tacotron_tpu_torch.synth import Synthesizer
    config = Config.from_dict(cell.config["config"])
    variables = family.make_variables(cell.config["config"]["model"], seed,
                                      device)
    synth = Synthesizer(device=device)
    synth.load_variables({k: v.cpu().numpy() for k, v in variables.items()},
                         config)
    return synth, variables


def run(cell: Cell, args, device) -> Run:
    mix = cell.traffic
    cfg = cell.config["config"]
    out = Run("offline", cell.config, mix)
    family = model_family(cell.config)
    fields = getattr(family, "SAMPLE_FIELDS", ())
    synth, variables = program(cell, family, args.seed, device)
    fast = mix["vocoder"] == "fast"
    kw = dict(attention_trim=mix["attention_trim"],
              librosa_trim=mix["librosa_trim"], fast_vocoder=fast)
    first = generate.texts(mix, args.seed, 0)
    synth.prewarm(**synth.prewarm_args(
        first, attention_trim=mix["attention_trim"], fast_vocoder=fast))
    synth.synthesize(first, **kw)
    if device.type == "cuda":
        torch.cuda.synchronize()
    out.setup_s = time.time() - process_start_time()

    sr = cfg["audio"]["sample_rate"]
    rng = np.random.default_rng([args.seed, 3])
    sample: List[dict] = []
    seen = 0
    # the window's last trace_seconds are traced, so the host spans before
    # them run without the profiler
    tracer = TraceWindow(device) if args.trace else None
    tracing = False
    trace_from = args.seconds - mix["trace_seconds"]
    index = 1
    t0 = time.perf_counter()
    while True:
        texts = generate.texts(mix, args.seed, index)
        if (tracer is not None and not tracing
                and time.perf_counter() - t0 >= trace_from):
            tracer.start()
            tracing = True
        t_call = time.perf_counter()
        with torch.profiler.record_function("bench.synthesize"):
            res = synth.synthesize(texts, collect_timings=bool(args.trace),
                                   **kw)
        now = time.perf_counter()
        unit = {"call": index, "texts": len(texts),
                "audio_s": sum(len(w) for w in res["wavs"]) / sr,
                "steps": int(res["alignments"][0].shape[-1]),
                "frames": int(max(res["ends"])),
                "wall_s": now - t_call, "traced": tracing}
        if "timings" in res:
            unit.update(res["timings"])
        out.units.append(unit)
        for row in range(len(texts)):
            # reservoir sampling of the window's utterances
            slot = (len(sample) if len(sample) < mix["check_sample"]
                    else int(rng.integers(seen + 1)))
            if slot < mix["check_sample"]:
                item = {"call": index, "row": row, "text": texts[row],
                        "wav": res["wavs"][row],
                        "alignment": res["alignments"][row]}
                for key in fields:
                    item[key] = res[key][row]
                if slot == len(sample):
                    sample.append(item)
                else:
                    sample[slot] = item
            seen += 1
        if now - t0 >= args.seconds:
            break
        index += 1
    out.window_s = now - t0
    if tracing:
        tracer.stop()
        out.traced = [i for i, u in enumerate(out.units) if u["traced"]]
        out.trace = tracer.summary
    out.attempted = sum(u["texts"] for u in out.units)
    out.end_to_end["audio_s_per_s"] = (sum(u["audio_s"] for u in out.units)
                                       / out.window_s)
    if device.type == "cuda":
        out.memory_peak_bytes = torch.cuda.max_memory_allocated()
    del synth, res
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    numbers = check.offline_numbers(cell, family, args.seed, sample,
                                    variables, device)
    out.numbers = numbers
    out.checks = check.judged(cell, numbers)
    if getattr(args, "control", False):
        out.control = check.offline_numbers(cell, family, args.seed, sample,
                                            variables, device, control=True)
    return out


def least_call_seconds(family, cfg: dict, mix: dict, unit: dict) -> float:
    """The least time of one call's work on the card: the family's forward
    matrix products at the float32 peak plus the Griffin-Lim products at
    the bf16 peak (``synth.mfu_pct``)."""
    from .. import flops
    m, audio = cfg["model"], cfg["audio"]
    lo, hi = mix["tokens"]
    counts = generate.token_counts(lo, hi, mix["texts_per_call"])
    t_in = -(-max(counts) // 32) * 32
    t_out = unit["steps"] * family.frames_per_step(m)
    model = family.forward_flops(m, unit["texts"], t_in, t_out)
    iters, _ = generate.griffin_lim(mix, audio)
    n_fft = (audio["num_freq"] - 1) * 2
    gl = flops.gl_iteration_flops(unit["texts"] * unit["frames"],
                                  n_fft) * iters
    return model / flops.PEAK_F32_FLOPS + gl / flops.PEAK_BF16_FLOPS


def chunks(mix: dict) -> List[int]:
    """The vocoder's chunk sizes of one call: at most 16 utterances a
    chunk, as the program's synthesizer states."""
    n = mix["texts_per_call"]
    return [min(16, n - lo) for lo in range(0, n, 16)]


def per_unit_mean(units: List[dict], key: str) -> float:
    vals = [u[key] for u in units if key in u and not u["traced"]]
    return float(np.mean(vals)) if vals else float("nan")
