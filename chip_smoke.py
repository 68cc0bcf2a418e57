#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

1. Device: requires CUDA, prints the card's name and power limit, turns TF32
   off for matmuls and cuDNN convolutions.
2. Build: compiles every kernel of ``tacotron_tpu_torch/csrc`` with nvcc for
   sm_90a, one process per source, all at once (four libraries; K4's, by
   far the slowest to compile, is waited for only after phase 4, which
   does not run it), and prints a ``[sass]`` line counting each library's
   wgmma (``HGMMA``), TMA-load (``UTMALDG``), cluster-barrier
   (``UCGABAR``), distributed shared-memory store (``STAS``) and mbarrier
   (``SYNCS``) instructions;
   the K1 and K3 libraries must have the first two, the K4 library the
   last three.
3. Kernels: each kernel against its plain PyTorch version on the card, at
   the serving path's shapes, with CUDA-event device times (the host's
   launch cost excluded) of the kernel, the plain version and (where one
   exists) a single PyTorch library call; for K1 and K3 also the time of
   their bf16 products through ``torch.matmul`` at the same shapes
   (``gemm_library_ms``, a yardstick only) and the achieved TFLOP/s; and
   again at ragged shapes
   (partial tiles, short stacks, a small geometry, each vector width of the
   overlap-add, T = 1, N = 1, zero lengths, widths that are not a multiple
   of 32, GRUs over several clusters and on both of K4's routes).
4. Main path at full width (``Config()``, Deep Voice 2 with two speakers,
   random weights from a seed): ``Synthesizer.synthesize`` on four sentences
   at 50 decode steps with the fast vocoder (200 frames: the fused
   Griffin-Lim kernel chain, call (a)), on two sentences at 200 steps with
   the classic vocoder (800 frames: matmul_half with the overlap-add kernel,
   call (b)), and on four sentences at 50 steps with the fast vocoder and
   ``griffin_lim_impl="pallas"`` (the spectral-step kernel and the
   overlap-add kernel, call (c)).  The kernels' launch counters are zeroed
   before each call and read after, and the waveforms are checked.  The
   same weights on the CPU give the same 10-step greedy decode as on the
   card.
5. The fused GRU's path: the encoder CBHG's and the post-net's BiGRU inputs
   of a full-width decode (four sentences, 50 steps), run through
   ``bigru_from_params`` (the GRU kernel, counted) and held against the
   ``BiGRU`` module, with the weight gradients of a sum of squares through
   the kernel's autograd Function against autograd through the module.
   Both directions' shapes must be on K4's cluster route; each is timed
   whole, its input projection alone, and its schedule with the products
   compiled out (``floor_ms``, the latency floor of the T steps).
6. Training (the port's training path at full width, on a synthetic
   corpus of 2 speakers x 32 utterances written from a seed by
   ``dsp/host.py``): (a) one train step at batch 4 on the card and on the
   CPU from the same weights and batch (``dropout_prob=0``): metrics,
   gradients and BatchNorm statistics agree; (b) ``features_from_waveform``
   on the card and on the CPU agree; (c) ``train()`` for 10 steps at batch
   16 with evals every 5 steps, sample dumps and checkpoints, then a
   resume to step 15 with a ``torch.profiler`` trace of steps 11-15 (20
   steps and a resume to 30 until phase 14 came; cut for time): the loss
   falls, and ``metrics.jsonl`` carries the JAX driver's keys; (d) 5
   steps from a
   device-resident corpus with on-device features; (e)
   ``Synthesizer.load`` of the run directory synthesizes through K1.  A
   ``[train]`` line gives the median step time, target frames per second,
   peak memory and the device idle share of the traced steps.
7. Serving entry points, on phase 4's synthesizer and phase 6's run
   directory, the kernels' launch counters zeroed before each step and read
   after: (a) ``synthesize(manual_attention_mode=1)`` on 4 sentences at 50
   steps (the first pass is the decode alone, the second runs K1); (b)
   ``synthesize_robust(retry_mode=1)`` on them (random weights fail the
   health gate: K1 runs in both passes); (c) ``synthesize_long`` on a
   paragraph of more than 240 tokens (one batched call over 3+ chunks at
   200 steps: K2; the output is the pieces plus the gaps); (d)
   ``vocode="host"`` and ``"none"`` on 2 sentences (no Griffin-Lim kernel;
   the spectrograms equal the chip call's decode, the ends its ends); (e)
   the HTTP server (``app.make_handler`` and ``SynthWorker``) on an
   ephemeral port: one GET, four concurrent GETs (coalesced), a long JSON
   POST (the chunked route), a repeat GET served from the cache, every
   response a WAV at 24 kHz; (f) the eval CLI with ``--attention_retry 1``
   on phase 6's run directory; (g) ``compat`` export of that run to a TF1
   bundle and import into a new run directory: bit-identical waveforms,
   and ``train`` resumes it for one step.  A ``[serve]`` line gives the
   walls of one request, of the burst, of ``synthesize_long``, of the
   robust call and of host against chip vocoding.
8. Graphs (``Synthesizer.prewarm``, the app's ``--prewarm``, the train
   driver's ``prewarm``).  A replay launches its kernels without the
   wrappers, so their counters stay at 0 through it (checked) and its
   K1/K2/K3 launches are counted in a ``torch.profiler`` trace of it, held
   against the eager call's counters.  (a) Phase 4's three calls eagerly,
   then each call's key captured (the count ``prewarm_step_rungs`` gives)
   and replayed: the same ends, alignments and waveforms (limit 1e-6 of
   the peak), the same launches, and both walls and idle shares; (b) 32
   sentences at chunks of 16 (one program replayed twice in one call) and
   replays out of capture order, equal to eager, and the device clock
   stamps (``csrc/stamp.cu``) of one more such call: the last chunk's
   three in order and within the call's wall, the decode and vocoder
   device ms that every chunk's stamps give positive and together within
   it (logged beside the kernels); (c) the app's 21
   programs, then phase 7 (e)'s requests under a trace (K1 on the short
   ones, K2 on the long POST), replayed; (d) ``train(..., prewarm=True)``
   for 10 steps and a resume to 15 on phase 6's corpus and seed: every
   step of a bucket shape replays its graph once; against phase 6's eager
   run, which resumes at step 10 too, every step's loss and the
   parameters at steps 10 and 15, within 1e-5 (relative); a falling
   loss; and eager
   against replayed steps on the same 4 batches (step time, target
   frames/s, peak memory) with the idle share of steps 11-15.  A
   ``[graphs]`` line sums it up.
9. Several processes (``parallel/``), on phase 6's corpus with every batch
   padded to the corpus maxima (one shape).  (a) ``train()`` for 5 steps
   at batch 16 under an NCCL group of world size 1 (the torchrun
   environment on a free port) against the same 5 steps without a plan:
   losses and parameters bit-equal or within 1e-6 relative; then with
   ``prewarm``: every step replays the one graph, equal to the eager run.
   (b) Two ranks on the one card (this script run twice as a worker, a
   gloo group over CUDA tensors, NCCL refusing a device twice) at batch 8
   each, 3 steps with dropout on, against one process at batch 16 over the
   same rows: losses within rtol 1e-5, parameters within rtol 1e-4 and atol
   1e-6, the ranks bit-equal.  (c) ``make_sharded_synthesis`` on the
   world-size-1 plan, 4 sentences at 50 steps: default engines (no kernel),
   ``griffin_lim_impl="pallas", ola_impl="pallas"`` (K3 once per iteration,
   K2 once more), each waveform within 1e-4 of the peak of the same
   computation without a plan, and ``"fused"`` refused.  (d) The plain and
   the data-parallel step timed eagerly and replayed on the same 4 batches,
   the collectives a step calls and a capture records, one traced replay
   (its NCCL kernels), the roofline MFU; a ``[parallel]`` line.
10. The corpus chain (``tools/``, ``data/builder.py``) into a trained voice
   and the speaker eval on the card, at full width: (a) one long 24 kHz
   recording per speaker, five tone-band utterances between silences of
   0.5-1 s written from a seed, split by ``split_on_silence`` into one clip
   per utterance; (b) ``transcribe_batch`` with a seeded recognizer (each
   clip's sentence with one syllable changed; the fifth clip's change
   makes it tie between its sentence and a twin in the script), then
   ``align_batch``: every clip aligned to its own sentence, the tie kept
   as the JAX one-candidate list; (c) ``build_from_path`` with 2 spawned
   workers (CUDA up in this process, under a deadline) and with 1: equal
   ``BuildStats``, every array byte-equal, the utterances the
   ``ignore_recognition_level`` policy keeps (the tie is skipped), and
   ``dataset_totals`` over the clips; (d) ``train()`` for 5 steps on the
   built corpus, with a sample dump (the PNG skipped and logged where
   matplotlib is absent), then 4 more steps timed alone (the median step
   time); (e) ``evaluate_speakers`` on ``Synthesizer.load`` of that run for
   both speakers, at 50 steps (K1) and at the default budget on two long
   texts (K2 where ``fused_supported`` rejects the length), the launch
   counters zeroed before each and held to the counts the iteration count
   and the engine decision give, the kernel that ran held against its
   plain version at the shapes the call gave it (each vocoder chunk's
   padded batch x its frames), the waveforms checked at the exact length
   of their frame ends before the dB trim, and the report holding the JAX
   report's keys; (f) ``python -m
   tacotron_tpu_torch.tools.speaker_eval`` as a subprocess on the card.  A
   ``[corpus]`` line sums it up; (e)'s launches are the kernels'
   ``launches_corpus``.
11. bf16 compute (``ModelConfig.compute_dtype="bfloat16"``) at full width,
   with phase 4's weights and phase 6's corpus: (a) a teacher-forced
   forward on 4 utterances in bf16 on the card against float32 on the card
   and against bf16 on the CPU (each deviation a share of the float32 peak;
   the CPU tests' bounds, 3 % for mel and linear and 1e-2 for the
   alignments); (b) phase 4's rungs (a) and (b) in bf16, eagerly (K1 120
   launches at 50 steps, K2 61 at 200) and replayed after ``prewarm``
   (bit-equal to eager, the same launches in the replay's trace), walls,
   device busy time and idle share beside the float32 figures; (c) one
   bf16 step at batch 4 on the card against the CPU (loss rel 1e-2,
   gradient norm rel 2e-2), 10 bf16 steps at batch 16 (the loss falls),
   eager and replayed steps on the same 4 batches (step time, target
   frames/s, peak memory) beside phase 6's and 8's, and at NCCL world size
   1 the data-parallel bf16 step equal to the plain one over 2 steps; (d)
   ``python -m tacotron_tpu_torch.train --preset tpu --num_steps 3`` on a
   corpus of phase 6's writer with 64 utterances a speaker (the preset's
   batch of 32 is also each speaker's held-out test set), run beside
   phase 14: exit 0, its ``config.json`` bf16 at batch 32.  A ``[bf16]``
   line sums it up; (b)'s launches are the kernels' ``launches_bf16``.
   There is no fallback: a bf16 failure fails the script.
12. Convergence and checkpoints (``studies/``, ``train/checkpoint.py``):
   (a) checkpoint saves at full width on phase 6's config (parameters and
   Adam moments, about 112 MB in float32): how long ``save`` blocks,
   asynchronous against ``async_save=False`` (median of 3), how long the
   write takes to become durable, the replayed train step alone and with
   an asynchronous write in flight, and a checkpoint saved while replayed
   steps update the state in place read back bit-equal to the state at
   its step; (b) ``python -m
   tacotron_tpu_torch.studies.convergence_study`` twice on one ``--work``
   (a 48-a-speaker melody corpus, the preset's batch 32, bf16):
   ``--wall_budget_s 5`` alone on the card, then ``python -m
   tacotron_tpu_torch.studies.mulaw_quality`` on its run, then (beside
   phase 14) 10 steps more, which resume from the first call's
   checkpoint; both calls exit 0 and write the report's keys; the study's
   held-out evaluation run in this process on the resumed run, each
   call's K1/K2 launches held to the counts its iterations, ``_budget``
   and ``fused_supported`` give, the kernel that ran held against its
   plain version at each chunk's shape;
   (c) ``token_tone_accuracy`` of ``melody_wav`` itself reads 1.0 with a
   wrong-token rate of 0 for every held-out sentence, both speakers,
   ``melody`` and ``melody_var``.  A ``[convergence]`` line sums it up;
   (b)'s launches are the kernels' ``launches_convergence``.
13. Studies (``studies/serving_load.py``, ``synth_sweep.py``,
   ``bf16_study.py``, ``batch_study.py``) and K4's last input form: (a)
   K4 with bf16 weights, biases and mask (as JAX's kernel takes them) at
   the forward direction of phase 5's encoder (H=128) and post-net
   (H=256) BiGRU inputs, counted (2 launches), on the cluster route, with
   no copy in the wrapper (no ``copy`` among its aten operations), the
   output within 1e-4 of the plain version on the same bf16 tensors and
   the bf16 weight gradients within 2^-7 of the largest, timed beside
   float32 K4 on the same inputs; (b) the serving load, moved into
   phase 14; (c) one ``pallas`` point of the sweep at batch 16 (30
   momentum iterations): K3 30 and K2 31 launches in its eager call,
   both kernels against their plain versions at its shapes, replay and
   eager times; (d) ``python -m tacotron_tpu_torch.studies.bf16_study
   --steps 10`` and ``batch_study --samples 640`` (10-40 steps an arm),
   started together beside phase 14 (no metric reads their times), exit
   0, the reports' device line and keys.  A ``[studies]`` line
   sums it up; the kernels line gains K4's bf16-weight form and
   ``launches_studies``.
14. The benchmark harness (``tacotron_tpu_torch/bench.py``): its ``run`` in
   this process at full width (``Config()``, random weights from seed 0),
   batch 32 x 50 steps, training at batch 16 and the preset at 32 over
   192 frames, with small counts (one warm-up, 2 repetitions, a chain of
   3, 2 fresh batches, load levels 1 and 4 with 4 requests, ``max_batch``
   4 and 1), beside phase 11 (d)'s CLI, phase 12 (b)'s second call and
   phase 13 (d)'s two studies, whose times no metric reads (nor are
   phase 14's read: the bench's own run is alone on the card).  The
   record holds every key of the committed ``BENCH_DETAIL.json`` through
   ``RENAMED``, every number finite, the card line as its device and a null
   scan unroll; the headline is at most 200 bytes.  The replayed raw and
   fast programs give their eager first calls' waveforms on the same inputs
   (within 1e-6 of the peak).  Each section's first call launched K1 and K2
   as its texts, steps and vocoder give (the raw program K1 240, the fast
   one 120; the adaptive-budget sections K2 31 a vocoder chunk); the
   counters over the run saw those first calls and the eager rows' timed
   calls and nothing else (the captures' launches counted apart): every
   other timed call replayed.  The load section (phase 13 (b) until this
   phase came): every call replayed, no coalescing without concurrency, and
   the replays' K2 launches in a trace of it, 31 a call as the calls' texts
   give.  Each kernel against its plain version at every (padded batch,
   frames) the run gave it: the raw and fast programs' whole batch, each
   section's vocoder chunks and the load's.  A ``[bench]`` line sums it up;
   the kernels line gains ``launches_bench``.
15. Prints the kernels line, the card line, and last the result line
   ``{"ok": true, "device": {...}}``.

Any failure raises, exits nonzero and prints no result line.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import faulthandler
import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (dense): bf16 tensor cores, f32 outside
# them, HBM bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# device clock cycles of the spin queued ahead of each timed run (~10 ms)
SPIN_CYCLES = 20_000_000

KOREAN = ["안녕하세요. 만나서 반갑습니다.",
          "오늘 날씨가 참 좋네요.",
          "음성 합성 시스템을 시험하고 있습니다.",
          "감사합니다, 좋은 하루 되세요!"]


def log(msg: str) -> None:
    print(msg, flush=True)


#: when the script started (``stamp``'s zero)
T_START = time.perf_counter()


def stamp(what: str) -> None:
    """The script's seconds so far, after ``what``: where its time limit
    goes."""
    log(f"[time] {what} done at {time.perf_counter() - T_START:.1f} s")


def require(ok, msg: str) -> None:
    """A check that holds under ``python -O`` too."""
    if not ok:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _events():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def spin_ms(cycles: int) -> float:
    """The device time of ``torch.cuda._sleep(cycles)``."""
    start, end = _events()
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def time_ms(fn, runs: int = 25, warmup: int = 3, redos: int = 10) -> float:
    """Median device time of ``fn()`` over ``runs`` CUDA-event timings,
    after warm-up.  A device-side spin is queued ahead of each timed run, so
    the host has enqueued all of ``fn``'s launches before the start event
    fires and the time excludes the host's launch cost.  A run whose enqueue
    outlasts the spin (a host stall on a shared machine) is thrown away and
    made again behind a spin twice as long, up to 16 times the first; after
    ``redos`` such runs it raises instead of reporting a host-bound time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = SPIN_CYCLES
    spin = spin_ms(cycles)
    times = []
    while len(times) < runs:
        start, end = _events()
        t0 = time.perf_counter()
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        if host_ms < spin:
            times.append(start.elapsed_time(end))
            continue
        redos -= 1
        require(redos >= 0, f"enqueue took {host_ms:.3f} ms, longer than "
                            f"the {spin:.3f} ms spin ahead of it")
        log(f"[time] enqueue took {host_ms:.3f} ms behind a {spin:.3f} ms "
            f"spin: the run is made again behind a longer spin")
        cycles = min(2 * cycles, 16 * SPIN_CYCLES)
        spin = spin_ms(cycles)
    return statistics.median(times)


def graphed(fn):
    """``fn`` captured into a CUDA graph: its replay runs the same kernels
    on the same buffers in one launch, for timing a plain version whose
    thousands of small launches would outlast any spin ahead of them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def bf16_randn(rng, shape, dev) -> torch.Tensor:
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev).to(torch.bfloat16)


#: SASS mnemonics counted in every library: wgmma, TMA load, the cluster
#: barrier's arrive and wait (UCGABAR_ARV, UCGABAR_WAIT), the store into
#: another block's shared memory (STAS, st.async) and the mbarrier
#: operations (SYNCS)
SASS_OPS = ("HGMMA", "UTMALDG", "UCGABAR", "STAS", "SYNCS")


def sass_counts(names) -> dict:
    """{library: {op: n}}: the instructions of ``SASS_OPS`` in each built
    library's SASS (cuobjdump --dump-sass)."""
    from pathlib import Path

    from tacotron_tpu_torch.ops.kernels import _build

    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    counts = {}
    for name in names:
        sass = subprocess.run(
            [str(cuobjdump), "--dump-sass", str(_build.library_path(name))],
            check=True, capture_output=True, text=True, timeout=300).stdout
        counts[name] = {op: sum(line.count(op) for line in sass.splitlines())
                        for op in SASS_OPS}
    return counts


def rel_err(got: torch.Tensor, want: torch.Tensor):
    """(max |got - want|, that over max |want|)."""
    max_abs = float((got - want).abs().max())
    return max_abs, max_abs / float(want.abs().max())


def check_k1(dev, rng):
    """Fused Griffin-Lim iteration at the reference geometry, B=4, T=200."""
    from tacotron_tpu_torch.config import AudioConfig
    from tacotron_tpu_torch.ops.kernels import gl_fused

    cfg = AudioConfig()
    B, T = 4, 200
    Ta = gl_fused.frame_rows(T)
    mag = torch.from_numpy(
        rng.random((B, Ta, cfg.num_freq)).astype(np.float32) ** 1.5).to(dev)
    mag[:, T:] = 0.0
    mag_e_s, mag_o_s = gl_fused.prepare_magnitudes(mag, cfg.n_fft)
    sig = gl_fused.initial_signal_blocks(mag_e_s, mag_o_s, T, cfg)

    got = gl_fused.gl_iteration(sig, mag_e_s, mag_o_s, T, cfg)
    want = gl_fused.gl_iteration_reference(sig, mag_e_s, mag_o_s, T, cfg)
    torch.cuda.synchronize()
    max_abs = float((got - want).abs().max())
    rel = max_abs / float(want.abs().max())
    # both round the same bf16 inputs; the kernel sums its f32 products in
    # another order, which can flip single bf16 roundings of the projected
    # spectra
    require(torch.isfinite(got).all(), "K1 output not finite")
    require(rel <= 2e-3, f"K1 disagrees with its plain version: rel {rel}")

    ms = time_ms(lambda: gl_fused.gl_iteration(sig, mag_e_s, mag_o_s, T,
                                               cfg))
    plain_ms = time_ms(lambda: gl_fused.gl_iteration_reference(
        sig, mag_e_s, mag_o_s, T, cfg))
    M = cfg.n_fft // 2
    ne, no = M // 2 + 1, M // 2
    NBa = sig.shape[1]
    rows, NE, NO = B * Ta, mag_e_s.shape[2], mag_o_s.shape[2]
    # the kernels' four bf16 products through cuBLAS, at the same shapes
    we_t, wo_t, we, wo = gl_fused._kernel_matrices(cfg.n_fft, dev)
    u, v = bf16_randn(rng, (rows, M), dev), bf16_randn(rng, (rows, M), dev)
    xe = bf16_randn(rng, (rows, 2 * NE), dev)
    xo = bf16_randn(rng, (rows, 2 * NO), dev)
    gemm_library_ms = time_ms(lambda: (u @ we_t.T, v @ wo_t.T, xe @ we.T,
                                       xo @ wo.T))
    flops = gl_fused.iteration_flops(B * T, cfg.n_fft)
    nbytes = (2 * B * NBa * cfg.hop_length * 4      # signal in and out
              + B * T * (ne + no) * 4               # target magnitudes
              + 2 * M * (ne + no) * 2               # DFT matrices, bf16
              + cfg.n_fft * 4 + NBa * cfg.hop_length * 4)  # window, norm
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return {
        "name": "gl_iteration", "route": "cuda",
        "source": "tacotron_tpu_torch/csrc/gl_fused.cu",
        "replaces": "tacotron_tpu/ops/pallas/gl_fused.py:139",
        "tpu_kernel": "gl_fused.py::_gl_iter_kernel via gl_iteration",
        "shape": f"B={B} T={T} n_fft={cfg.n_fft} hop={cfg.hop_length}",
        "max_abs_err": max_abs, "max_rel_err": rel,
        "ms": ms, "plain_ms": plain_ms, "library_ms": None,
        "library_note": "no single PyTorch call computes one Griffin-Lim "
                        "iteration",
        "gemm_library_ms": gemm_library_ms,
        "gemm_library_note": "the four bf16 products (forward u and v, "
                             "inverse spectra) through torch.matmul at the "
                             "kernels' shapes",
        "tflops": flops / ms / 1e9,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "flops": flops, "bytes": nbytes,
    }


def check_k2(dev, rng):
    """Overlap-add at the 200-step rung's shape, B=2, T=800."""
    import torch.nn.functional as F

    from tacotron_tpu_torch.config import AudioConfig
    from tacotron_tpu_torch.ops.kernels import ola

    cfg = AudioConfig()
    B, T = 2, 800
    n_fft, hop = cfg.n_fft, cfg.hop_length
    num_samples = (T - 1) * hop
    frames = torch.from_numpy(
        rng.standard_normal((B, T, n_fft)).astype(np.float32)).to(dev)
    got = ola.overlap_add_batched(frames, num_samples, cfg)
    want = ola.overlap_add_reference(frames, num_samples, cfg)
    torch.cuda.synchronize()
    max_abs = float((got - want).abs().max())
    # same f32 products, summed in the same order; the plain version's
    # shifted adds may be reassociated by the library
    require(torch.isfinite(got).all(), "K2 output not finite")
    require(max_abs <= 1e-5, f"K2 disagrees with its plain version: {max_abs}")

    window = ola.window_tensor(cfg, dev)
    out_len = n_fft + hop * (T - 1)
    norm = ola.norm_tensor(T, cfg, dev)

    def library():
        # one fold over the windowed frames, then the norm and the slice
        sig = F.fold((frames * window).transpose(1, 2), (1, out_len),
                     (1, n_fft), stride=(1, hop))
        return (sig.reshape(B, out_len) / norm)[
            :, n_fft // 2:n_fft // 2 + num_samples]

    lib_err = float((library() - want).abs().max())
    require(lib_err <= 1e-5, f"fold yardstick disagrees: {lib_err}")
    ms = time_ms(lambda: ola.overlap_add_batched(frames, num_samples, cfg))
    plain_ms = time_ms(
        lambda: ola.overlap_add_reference(frames, num_samples, cfg))
    library_ms = time_ms(library)
    nbytes = (B * T * n_fft * 4 + B * num_samples * 4 + n_fft * 4
              + out_len * 4)
    flops = 2 * B * T * n_fft + B * num_samples
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return {
        "name": "overlap_add_batched", "route": "cuda",
        "source": "tacotron_tpu_torch/csrc/ola.cu",
        "replaces": "tacotron_tpu/ops/pallas/ola.py:42",
        "tpu_kernel": "ola.py::_ola_kernel via overlap_add_batched",
        "shape": f"B={B} T={T} n_fft={n_fft} hop={hop}",
        "max_abs_err": max_abs, "max_rel_err":
            max_abs / float(want.abs().max()),
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops > t_bytes else "bytes",
        "flops": flops, "bytes": nbytes,
    }


def check_k3(dev, rng):
    """Griffin-Lim spectral step at the "pallas" engine's serving shape:
    4 utterances x 200 frames = 800 rows, n_fft 2048."""
    from tacotron_tpu_torch.ops.kernels import griffin_lim

    rows, n_fft = 4 * 200, 2048
    F = n_fft // 2 + 1
    frames = torch.from_numpy(
        rng.standard_normal((rows, n_fft)).astype(np.float32)).to(dev)
    mag = torch.from_numpy(
        rng.random((rows, F)).astype(np.float32) ** 1.5).to(dev)
    got = griffin_lim.spectral_step(frames, mag, n_fft)
    want = griffin_lim.spectral_step_reference(frames, mag, n_fft)
    torch.cuda.synchronize()
    max_abs, rel = rel_err(got, want)
    # both round the same bf16 frames and spectra; the kernels sum their
    # f32 products in another order, which can flip single bf16 roundings
    # of the projected spectra (the JAX kernel's own tolerance)
    require(torch.isfinite(got).all(), "K3 output not finite")
    require(rel <= 2e-3, f"K3 disagrees with its plain version: rel {rel}")

    ms = time_ms(lambda: griffin_lim.spectral_step(frames, mag, n_fft))
    plain_ms = time_ms(lambda: griffin_lim.spectral_step_reference(
        frames, mag, n_fft))
    # the kernels' two bf16 products through cuBLAS, at the same shapes
    fwd_t, inv_t = griffin_lim._kernel_tensors(n_fft, dev)
    fb = bf16_randn(rng, (rows, fwd_t.shape[1]), dev)
    spec = bf16_randn(rng, (rows, fwd_t.shape[0]), dev)
    gemm_library_ms = time_ms(lambda: (fb @ fwd_t.T, spec @ inv_t.T))
    # the four products over the F bins the step needs (the kernels' bin
    # padding is not counted); each input read once, the output written once
    flops = 8 * rows * n_fft * F
    nbytes = (rows * n_fft * 4 + rows * F * 4    # frames, magnitudes (f32)
              + 4 * n_fft * F * 2                # four DFT matrices (bf16)
              + rows * n_fft * 4)                # new frames (f32)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return {
        "name": "spectral_step", "route": "cuda",
        "source": "tacotron_tpu_torch/csrc/griffin_lim.cu",
        "replaces": "tacotron_tpu/ops/pallas/griffin_lim.py:58",
        "tpu_kernel": "griffin_lim.py::_kernel via spectral_step",
        "shape": f"rows={rows} n_fft={n_fft}",
        "max_abs_err": max_abs, "max_rel_err": rel,
        "ms": ms, "plain_ms": plain_ms, "library_ms": None,
        "library_note": "no single PyTorch call computes the spectral step "
                        "(two DFT products, the phase projection and two "
                        "inverse products)",
        "gemm_library_ms": gemm_library_ms,
        "gemm_library_note": "the two bf16 products (forward frames, "
                             "inverse spectra) through torch.matmul at the "
                             "kernels' shapes",
        "tflops": flops / ms / 1e9,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "flops": flops, "bytes": nbytes,
    }


def gru_inputs(dev, rng, T, N, D, H, lengths=None):
    """Random [T, N, D] inputs, state, weights (flax layout) and mask."""
    def arr(shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32)).to(dev)
    x, h0 = arr((T, N, D)), arr((N, H))
    wg, wc = arr((D + H, 2 * H), 0.1), arr((D + H, H), 0.1)
    bg, bc = 1.0 + arr((2 * H,), 0.1), arr((H,), 0.1)
    if lengths is None:
        mask = torch.ones((T, N), device=dev)
    else:
        lens = torch.tensor(lengths, device=dev)
        mask = (torch.arange(T, device=dev)[:, None] < lens[None]).float()
    return x, h0, wg, bg, wc, bc, mask


def check_k2_at(dev, rng, cfg, B: int, T: int, ns=None) -> float:
    """K2 against its plain version on random frames [B, T, n_fft] into
    ``ns`` samples (default ``(T - 1) * hop``, the vocoder's); the max abs
    error, at most 1e-5 (the same f32 products, summed in the same
    order)."""
    from tacotron_tpu_torch.ops.kernels import ola

    frames = torch.from_numpy(rng.standard_normal(
        (B, T, cfg.n_fft)).astype(np.float32)).to(dev)
    ns = (T - 1) * cfg.hop_length if ns is None else ns
    err = float((ola.overlap_add_batched(frames, ns, cfg)
                 - ola.overlap_add_reference(frames, ns, cfg)).abs().max())
    vec = ola.ola_plan(cfg.n_fft, cfg.hop_length, ns).vec
    require(err <= 1e-5, f"K2 at B={B} T={T} n_fft={cfg.n_fft} hop="
            f"{cfg.hop_length} samples={ns} (vec {vec}): {err}")
    return err


def check_k1_at(dev, rng, cfg, B: int, T: int) -> float:
    """One K1 iteration against its plain version on random magnitudes of
    B utterances x T frames (the rows past T zero, as the vocoder pads
    them); the max error over the output's peak, at most 2e-3 (as in
    :func:`check_k1`)."""
    from tacotron_tpu_torch.ops.kernels import gl_fused

    mag = torch.from_numpy(rng.random(
        (B, gl_fused.frame_rows(T), cfg.num_freq)).astype(np.float32)).to(dev)
    mag[:, T:] = 0.0
    mag_e_s, mag_o_s = gl_fused.prepare_magnitudes(mag, cfg.n_fft)
    sig = gl_fused.initial_signal_blocks(mag_e_s, mag_o_s, T, cfg)
    got = gl_fused.gl_iteration(sig, mag_e_s, mag_o_s, T, cfg)
    want = gl_fused.gl_iteration_reference(sig, mag_e_s, mag_o_s, T, cfg)
    rel = float((got - want).abs().max() / want.abs().max())
    require(rel <= 2e-3, f"K1 at B={B} T={T} n_fft={cfg.n_fft}: {rel}")
    return rel


def check_edge_shapes(dev, rng) -> int:
    """Every kernel against its plain version at ragged shapes: frame
    counts and rows that leave partial tiles, stacks shorter than a frame's
    hop chunks, one item, a small geometry (n_fft 256, hop 128) and an n_fft
    that is not a multiple of the tile (254); for the overlap-add also one
    frame, an output length that is not a multiple of 4 and a hop of 125
    (the 2- and 1-sample paths of ``ola_plan``); GRUs with T = 1, N = 1,
    lengths of 0 and T, H not a multiple of 32, N = 17 (five clusters), and
    H = 512 and 513 on the two sides of ``cluster_plan``'s boundary between
    the cluster and the streaming route, each in float32 and with bf16
    weights, biases and mask (at H >= 512 also bf16 gate or candidate
    operands alone)."""
    from tacotron_tpu_torch.config import AudioConfig
    from tacotron_tpu_torch.ops.kernels import griffin_lim, gru

    small = AudioConfig(num_freq=129, sample_rate=16000, frame_shift_ms=8,
                        frame_length_ms=16)
    odd_hop = AudioConfig(num_freq=129, sample_rate=16000,
                          frame_shift_ms=7.8125, frame_length_ms=16)
    ref = AudioConfig()
    n = 0
    for cfg, B, T, ns in ((ref, 1, 2, None), (ref, 3, 5, None),
                          (ref, 2, 37, None), (small, 2, 21, None),
                          (ref, 2, 1, ref.n_fft // 2), (ref, 2, 9, 2397),
                          (small, 1, 7, 766), (odd_hop, 2, 21, None)):
        check_k2_at(dev, rng, cfg, B, T, ns)
        n += 1
    for cfg, B, T in ((ref, 1, 7), (ref, 3, 130), (small, 2, 21)):
        check_k1_at(dev, rng, cfg, B, T)
        n += 1
    for rows, n_fft in ((70, 256), (130, 2048), (1, 2048), (33, 254)):
        frames = torch.from_numpy(rng.standard_normal(
            (rows, n_fft)).astype(np.float32)).to(dev)
        mag = torch.from_numpy(rng.random(
            (rows, n_fft // 2 + 1)).astype(np.float32)).to(dev)
        _, rel = rel_err(griffin_lim.spectral_step(frames, mag, n_fft),
                         griffin_lim.spectral_step_reference(frames, mag,
                                                             n_fft))
        require(rel <= 2e-3, f"K3 at rows={rows} n_fft={n_fft}: {rel}")
        n += 1
    n17 = [0, 17, 5, 1, 16, 17, 2, 9, 17, 3, 0, 11, 17, 4, 8, 17, 12]
    for T, N, D, H, lengths in ((1, 1, 24, 40, [1]), (1, 1, 8, 8, [0]),
                                (17, 3, 24, 40, [0, 17, 5]),
                                (9, 2, 7, 37, None), (17, 17, 24, 40, n17),
                                (6, 5, 16, 512, [6, 0, 3, 6, 1]),
                                (6, 3, 16, 513, [6, 2, 0])):
        f32 = gru_inputs(dev, rng, T, N, D, H, lengths)
        # float32, then the operands JAX's kernel also takes in bf16: all
        # five, and on both sides of the route boundary the gate or the
        # candidate operands alone (mixed types)
        modes = [(), gru.BF16_OPERANDS]
        if H >= 512:
            modes += [("wg", "bg"), ("wc", "bc", "mask")]
        for low in modes:
            args = list(f32[:2]) + [
                t.to(torch.bfloat16) if name in low else t
                for name, t in zip(gru.BF16_OPERANDS, f32[2:])]
            got = gru.gru_sequence(*args)
            want = gru.gru_reference_scan(*args)
            err = float((got - want).abs().max())
            plan = gru.cluster_plan(N, H)
            require(err <= 1e-5, f"K4 at T={T} N={N} D={D} H={H} ({plan}), "
                                 f"bf16 {low}: {err}")
            if lengths is not None:
                for i, length in enumerate(lengths):
                    require(bool((got[length:, i] == 0).all()),
                            f"K4 emits past length {length}, bf16 {low}")
            n += 1
    torch.cuda.synchronize()
    return n


def check_waveforms(res, hop: int, what: str) -> float:
    """Finite, non-silent, of the length the trimmed frame ends give.
    Returns the samples of audio."""
    n = 0
    for wav, end in zip(res["wavs"], res["ends"]):
        require(wav.ndim == 1 and wav.size > 0, f"{what}: empty waveform")
        require(np.isfinite(wav).all(), f"{what}: waveform not finite")
        require(float(np.abs(wav).max()) > 0.0, f"{what}: silent waveform")
        require(wav.size == end * hop,
                f"{what}: {wav.size} samples for {end} frames")
        n += wav.size
    return n


def main_path(dev):
    import dataclasses

    from tacotron_tpu_torch.config import Config
    from tacotron_tpu_torch.ops.kernels.gl_fused import gl_iteration
    from tacotron_tpu_torch.ops.kernels.griffin_lim import spectral_step
    from tacotron_tpu_torch.ops.kernels.ola import overlap_add_batched
    from tacotron_tpu_torch.synth import Synthesizer

    base = Config()
    cfg = base.replace(model=dataclasses.replace(
        base.model, model_type="deepvoice", num_speakers=2))
    synth = Synthesizer(device="cuda").init_random(cfg, seed=0)
    # the same weights with the "pallas" vocoder engine
    cfg_c = cfg.replace(audio=dataclasses.replace(
        cfg.audio, griffin_lim_impl="pallas"))
    synth_c = Synthesizer(device="cuda").init_random(cfg_c, seed=0)
    sr, hop = cfg.audio.sample_rate, cfg.audio.hop_length
    counters = {"K1": gl_iteration, "K2": overlap_add_batched,
                "K3": spectral_step}
    calls = {
        # (a) the serving setting: 4 sentences, 50 steps (200 frames ->
        # fused engine), momentum vocoder
        "a": (synth, dict(texts=KOREAN, speaker_ids=[0, 1, 0, 1],
                          max_steps=50, fast_vocoder=True)),
        # (b) the 200-step rung: 800 frames -> matmul_half + overlap-add
        "b": (synth, dict(texts=KOREAN[:2], speaker_ids=[1, 0],
                          max_steps=200)),
        # (c) as (a) through the "pallas" engine: spectral step + overlap-add
        "c": (synth_c, dict(texts=KOREAN, speaker_ids=[0, 1, 0, 1],
                            max_steps=50, fast_vocoder=True)),
    }
    launches, results = {}, {}
    for name, (s, kw) in calls.items():
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = s.synthesize(librosa_trim=False, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[name] = {k: fn.launches for k, fn in counters.items()}
        audio = check_waveforms(res, hop, f"call ({name})") / sr
        log(f"[main] call ({name}): {len(kw['texts'])} utterances x "
            f"{kw['max_steps']} steps, engine "
            f"{s.config.audio.griffin_lim_impl}, fast vocoder "
            f"{kw.get('fast_vocoder', False)}: {wall:.3f} s wall, "
            f"{audio:.3f} s audio, ends {res['ends']}, launches "
            f"{launches[name]}")
        results.update({f"wall_{name}": wall, f"audio_{name}": audio})
    la, lb, lc = launches["a"], launches["b"], launches["c"]
    require(la["K1"] > 0, "call (a) launched no fused Griffin-Lim kernel")
    require(lb["K2"] > 0, "call (b) launched no overlap-add kernel")
    require(lb["K1"] == 0, "call (b) should not reach the fused engine")
    # one spectral step per iteration and vocoder chunk (4 utterances fit
    # one chunk of 16)
    chunks = -(-len(KOREAN) // Synthesizer.VOCODER_MAX_BATCH)
    require(lc["K3"] == 30 * chunks,
            f"call (c) launched K3 {lc['K3']} times, not 30 x {chunks}")
    require(lc["K2"] > 0, "call (c) launched no overlap-add kernel")
    require(lc["K1"] == 0, "call (c) should not reach the fused engine")
    results.update(launches=launches, synth=synth, calls=calls)

    # the same weights on the CPU: a 10-step greedy decode agrees
    cpu = Synthesizer(device="cpu").init_random(cfg, seed=0)
    from tacotron_tpu_torch.text import text_to_sequence
    seq = text_to_sequence(KOREAN[0], list(cfg.data.cleaner_names()))
    outs = {}
    for name, s in (("cuda", synth), ("cpu", cpu)):
        with torch.inference_mode():
            ids = torch.from_numpy(seq[None].astype(np.int64)).to(s.device)
            lens = torch.tensor([len(seq)], device=s.device)
            spk = torch.tensor([1], device=s.device)
            out = s.model(ids, lens, speaker_id=spk, max_steps=10)
        outs[name] = {k: v.float().cpu().numpy() for k, v in out.items()}
    lin_c, lin_g = outs["cpu"]["linear_outputs"], outs["cuda"]["linear_outputs"]
    al_c, al_g = outs["cpu"]["alignments"], outs["cuda"]["alignments"]
    lin_rel = float(np.abs(lin_g - lin_c).max() / np.abs(lin_c).max())
    al_abs = float(np.abs(al_g - al_c).max())
    log(f"[main] card vs CPU, 10-step decode: linear rel {lin_rel:.3e}, "
        f"alignments abs {al_abs:.3e}")
    # fp32 on both sides (TF32 off); only summation order differs, and ten
    # recurrent steps amplify it little
    require(lin_rel <= 1e-3, f"card and CPU decodes disagree: {lin_rel}")
    require(al_abs <= 1e-3, f"card and CPU alignments disagree: {al_abs}")
    results.update(card_vs_cpu_linear_rel=lin_rel,
                   card_vs_cpu_alignments_abs=al_abs)
    return results


def capture_bigru_inputs(dev, synth) -> dict:
    """{"encoder"/"post-net": (BiGRU module, its inputs, its output)} of
    the encoder CBHG's BiGRU (4 sentences, with the speaker's
    ``encoder_rnn_init``) and the post-net's (200 frames) in a full-width
    50-step decode."""
    from tacotron_tpu_torch.text import text_to_sequence

    model = synth.model
    seqs = [text_to_sequence(t, synth.cleaner_names()) for t in KOREAN]
    bucket = -(-max(len(q) for q in seqs) // 32) * 32
    ids = np.zeros((len(seqs), bucket), np.int64)
    for i, q in enumerate(seqs):
        ids[i, :len(q)] = q
    captured = {}

    def hook(name):
        def fn(module, args, kwargs, output):
            inputs = list(args) + [None] * (3 - len(args))
            captured[name] = (module, inputs, output.detach().clone())
        return fn

    handles = [model.encoder_cbhg.bigru.register_forward_hook(
                   hook("encoder"), with_kwargs=True),
               model.post_cbhg.bigru.register_forward_hook(
                   hook("post-net"), with_kwargs=True)]
    with torch.no_grad():
        model(torch.from_numpy(ids).to(dev),
              torch.tensor([len(q) for q in seqs], device=dev),
              speaker_id=torch.tensor([0, 1, 0, 1], device=dev),
              max_steps=50)
    for h in handles:
        h.remove()
    require(captured["encoder"][1][2] is not None,
            "the encoder BiGRU got no initial state")
    return captured


def direction_args(dev, captured: dict, name: str) -> list:
    """The forward direction of a captured BiGRU as ``gru_sequence``'s
    float32 arguments: [T, N, D] inputs, state, weights (flax layout),
    biases and mask."""
    mod, (xs, lengths, init), _ = captured[name]
    N, T, D = xs.shape
    cell = mod.fw
    mask = (torch.ones((T, N), device=dev) if lengths is None else
            (torch.arange(T, device=dev)[:, None] < lengths[None]).float())
    h0 = (torch.zeros((N, cell.features), device=dev) if init is None
          else init[:, :cell.features].contiguous())
    return [a.detach() for a in (
        xs.transpose(0, 1).contiguous(), h0,
        cell.gates.weight.t().contiguous(), cell.gates.bias,
        cell.candidate.weight.t().contiguous(), cell.candidate.bias, mask)]


def check_k4(dev, synth, rng):
    """The fused GRU's path: capture the inputs of the encoder CBHG's BiGRU
    and of the post-net's BiGRU in a full-width decode
    (:func:`capture_bigru_inputs`), run both through ``bigru_from_params``
    with the launch counter zeroed before and read after, and hold them and
    the weight gradients against the ``BiGRU`` module.  Then time one
    direction at the post-net and at the encoder shape: whole, its input
    projection alone, and its latency floor."""
    from tacotron_tpu_torch.ops.kernels import gru

    captured = capture_bigru_inputs(dev, synth)
    gru.gru_sequence.launches = 0
    with torch.no_grad():
        outs = {name: gru.bigru_from_params(mod, *inputs)
                for name, (mod, inputs, _) in captured.items()}
    launches = gru.gru_sequence.launches
    require(launches == 4, f"K4 path launched {launches} times, not 4")
    errs, grad_errs = {}, {}
    for name, (mod, inputs, want) in captured.items():
        max_abs, rel = rel_err(outs[name], want)
        errs[name] = max_abs
        # f32 on both sides (no TF32); the kernel sums in another order and
        # the recurrence carries that through every step
        require(max_abs <= 1e-4, f"K4 at the {name} BiGRU: {max_abs}")
        params = list(mod.parameters())
        with torch.enable_grad():
            g_k = torch.autograd.grad(
                (gru.bigru_from_params(mod, *inputs) ** 2).sum(), params)
            g_m = torch.autograd.grad((mod(*inputs) ** 2).sum(), params)
        grad_errs[name] = max(rel_err(a, b)[1] for a, b in zip(g_k, g_m))
        require(grad_errs[name] <= 1e-3,
                f"K4 gradient at the {name} BiGRU: rel {grad_errs[name]}")
        log(f"[k4] {name} BiGRU {tuple(inputs[0].shape)}: max abs err "
            f"{max_abs:.3e} (rel {rel:.3e}), weight gradients max rel err "
            f"{grad_errs[name]:.3e}")

    def timings(name):
        """The direction's device times: the kernel (``ms``), the input
        projection alone, the recurrence's schedule with its products
        compiled out (the latency floor), and its plan."""
        args = direction_args(dev, captured, name)
        x, h0, wg, bg, wc, bc, mask = args
        gx, cx = gru.gru_input_projection(x, wg, bg, wc, bc)
        plan = gru.cluster_plan(x.shape[1], h0.shape[1])
        return args, {
            "ms": time_ms(lambda: gru.gru_sequence(*args)),
            "projection_ms": time_ms(
                lambda: gru.gru_input_projection(x, wg, bg, wc, bc)),
            "floor_ms": time_ms(lambda: gru.gru_recurrence(
                gx, cx, h0, wg, wc, mask, products=False)),
            "plan": plan._asdict(),
            "shape": "T={} N={} D={} H={}".format(*x.shape, h0.shape[1])}

    with torch.no_grad():
        args, post = timings("post-net")
        # the plain scan's ~3,000 small launches run from one CUDA graph
        plain_ms = time_ms(graphed(lambda: gru.gru_reference_scan(*args)))
        _, enc = timings("encoder")
    for name, t in (("post-net", post), ("encoder", enc)):
        require(t["plan"]["route"] == "cluster",
                f"the {name} direction is not on the cluster route: "
                f"{t['plan']}")
        log(f"[k4] {name} direction {t['shape']}: plan {t['plan']}, "
            f"{t['ms']:.4f} ms, projection {t['projection_ms']:.4f} ms, "
            f"floor {t['floor_ms']:.4f} ms")
    T, N, D = args[0].shape
    H = args[1].shape[1]
    flops = 2 * T * N * (D + H) * 3 * H
    nbytes = ((D + H) * 3 * H * 4 + 3 * H * 4      # weights and biases
              + T * N * D * 4 + N * H * 4 + T * N * 4  # x, h0, mask
              + T * N * H * 4)                     # outputs
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    bound_ms = max(t_ops, t_bytes) * 1e3
    return {
        "name": "gru_sequence", "route": "cuda",
        "source": "tacotron_tpu_torch/csrc/gru.cu",
        "replaces": "tacotron_tpu/ops/pallas/gru.py:47",
        "tpu_kernel": "gru.py::_gru_kernel via _gru_pallas_raw / "
                      "gru_sequence",
        "shape": f"one direction of the post-net BiGRU: {post['shape']}",
        "max_abs_err": max(errs.values()), "errors_by_site": errs,
        "grad_max_rel_err": grad_errs,
        "ms": post["ms"], "plain_ms": plain_ms, "library_ms": None,
        "library_note": "torch.nn.GRU (cuDNN) applies the reset gate after "
                        "the recurrent product, a different function",
        "projection_ms": post["projection_ms"],
        "floor_ms": post["floor_ms"], "plan": post["plan"],
        "encoder_direction": enc, "ms_encoder_direction": enc["ms"],
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bound_with_floor_ms": max(bound_ms, post["floor_ms"]),
        "bound_with_floor_by": ("latency floor" if post["floor_ms"] > bound_ms
                                else "operations" if t_ops >= t_bytes
                                else "bytes"),
        "bound_note": f"bound_ms counts operations and bytes only; floor_ms "
                      f"is the {T} steps of the cluster schedule with the "
                      f"products compiled out (two cluster barriers, the "
                      f"distributed shared-memory writes and the stores "
                      f"per step), measured on this card",
        "flops": flops, "bytes": nbytes, "launches": launches,
    }


# ---------------------------------------------------------------- training

#: the train step's metric keys in metrics.jsonl: the JAX driver's (its
#: train step's metrics but ``diverged``, plus ``sec_per_step``)
TRAIN_KEYS = {"attention_mass", "grad_norm", "learning_rate", "linear_loss",
              "loss", "loss_without_coeff", "mel_loss", "param_norm",
              "sec_per_step", "step", "kind", "wall_time"}


def train_config(**train_kw):
    """The full-width model: ``Config()`` with Deep Voice 2 and two
    speakers, batch 16 (the default), the train settings given."""
    import dataclasses

    from tacotron_tpu_torch.config import Config

    base = Config()
    return base.replace(
        model=dataclasses.replace(base.model, model_type="deepvoice",
                                  num_speakers=2),
        train=dataclasses.replace(base.train, **train_kw))


def check_train_step_card_vs_cpu(dev, dirs):
    """(a) One full-width train step at batch 4 (utterances of 120-160
    frames, ``dropout_prob=0``) from the same weights and batch on the card
    and on the CPU: every metric rel 1e-5, each gradient (through Adam's
    first moment, ``(1 - b1)`` times the clipped gradient) max abs over the
    global norm 1e-4, the new BatchNorm statistics 1e-5."""
    import dataclasses

    from tacotron_tpu_torch.data import DataFeeder
    from tacotron_tpu_torch.train.state import create_train_state
    from tacotron_tpu_torch.train.step import batch_to_device, make_train_step

    cfg = train_config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dropout_prob=0.0),
                      data=dataclasses.replace(cfg.data, min_iters=30,
                                               max_iters=41))
    feeder = DataFeeder(dirs, cfg, batch_size=4, n_test=0, seed=3)
    host_batch = next(feeder.batches())
    frames = host_batch.target_lengths
    require(bool((frames >= 120).all() and (frames <= 160).all()),
            f"(a) batch frames {frames} outside 120-160")
    out = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        state = create_train_state(cfg, seed=0, device=d)
        state, metrics = make_train_step(cfg)(
            state, batch_to_device(host_batch, d), 0)
        names = [n for n, _ in state.model.named_parameters()]
        out[name] = dict(
            metrics={k: float(v) for k, v in metrics.items()},
            m={n: t.cpu() for n, t in zip(names, state.opt.m)},
            stats={k: v.cpu() for k, v in state.model.named_buffers()})
    c, g = out["cpu"], out["cuda"]
    metric_rel = {k: abs(g["metrics"][k] - v) / max(abs(v), 1e-30)
                  for k, v in c["metrics"].items()}
    worst = max(metric_rel, key=metric_rel.get)
    require(metric_rel[worst] <= 1e-5,
            f"(a) metric {worst}: card {g['metrics'][worst]} vs CPU "
            f"{c['metrics'][worst]}")
    g_norm = c["metrics"]["grad_norm"]
    scale = (min(1.0, cfg.train.grad_clip_norm / g_norm) * g_norm
             * (1.0 - cfg.train.adam_beta1))
    grad_err = max(float((g["m"][n] - c["m"][n]).abs().max()) / scale
                   for n in c["m"])
    require(grad_err <= 1e-4, f"(a) gradient max abs / norm {grad_err}")
    stat_err = max(float((g["stats"][n] - c["stats"][n]).abs().max())
                   for n in c["stats"])
    require(stat_err <= 1e-5, f"(a) BatchNorm statistics {stat_err}")
    log(f"[train] (a) card vs CPU, one step at batch 4 x {int(frames.max())} "
        f"frames: loss {g['metrics']['loss']:.6f} vs "
        f"{c['metrics']['loss']:.6f}, worst metric rel {metric_rel[worst]:.3e} "
        f"({worst}), gradient max abs / norm {grad_err:.3e}, BatchNorm "
        f"statistics max abs {stat_err:.3e}")
    return {"metric_rel": metric_rel[worst], "grad_err": grad_err,
            "stat_err": stat_err}


def check_features_card_vs_cpu(dev, dirs):
    """(b) ``features_from_waveform`` at n_fft 2048 on the card and on the
    CPU, on a padded batch of the corpus's waveforms: max abs 1e-4 on the
    normalized targets."""
    from tacotron_tpu_torch.data import DataFeeder
    from tacotron_tpu_torch.dsp.chip import features_from_waveform

    cfg = train_config(on_device_features=True)
    batch = next(DataFeeder(dirs, cfg, n_test=0, seed=4).batches())
    wav = torch.from_numpy(batch.waveforms.astype(np.float32) / 32767.0)
    want = features_from_waveform(wav, cfg.audio)
    got = features_from_waveform(wav.to(dev), cfg.audio)
    errs = [float((a.cpu() - b).abs().max()) for a, b in zip(got, want)]
    require(max(errs) <= 1e-4, f"(b) features card vs CPU: {errs}")
    log(f"[train] (b) features_from_waveform {tuple(wav.shape)}, n_fft "
        f"{cfg.audio.n_fft}: linear max abs {errs[0]:.3e}, mel {errs[1]:.3e}")
    return max(errs)


def time_steps_from_checkpoint(dev, dirs, run_dir, n: int = 8):
    """``train/profile.py::time_train_steps`` at batch 16 from the run's
    last checkpoint: median sec/step, target frames per second and the peak
    memory allocated over ``n`` steps."""
    from tacotron_tpu_torch.data import DataFeeder
    from tacotron_tpu_torch.train.checkpoint import CheckpointManager
    from tacotron_tpu_torch.train.profile import time_train_steps
    from tacotron_tpu_torch.train.state import create_train_state
    from tacotron_tpu_torch.train.step import make_train_step

    cfg = train_config(decay_learning_rate_mode=1)
    state = CheckpointManager(run_dir, cfg).restore(
        create_train_state(cfg, seed=0, device=dev))
    return time_train_steps(state, make_train_step(cfg),
                            DataFeeder(dirs, cfg, seed=5).batches(), 1, n)


def train_phase(dev, tmp: str) -> dict:
    """Phase 6: training, (a)-(e) of the module docstring, in ``tmp``.
    Every check raises; nothing here falls back to the CPU but (a)'s and
    (b)'s reference runs.  Returns the numbers, the run dir and the
    corpus."""
    import os

    from tacotron_tpu_torch.data.synthetic import write_synthetic_corpus
    from tacotron_tpu_torch.ops.kernels.gl_fused import gl_iteration
    from tacotron_tpu_torch.synth import Synthesizer
    from tacotron_tpu_torch.train.checkpoint import checkpoint_steps
    from tacotron_tpu_torch.data import DataFeeder
    from tacotron_tpu_torch.synth.synthesizer import trim_silence_db
    from tacotron_tpu_torch.train.driver import train
    from tacotron_tpu_torch.train.profile import time_train_steps
    from tacotron_tpu_torch.train.step import make_train_step
    from tacotron_tpu_torch.utils import read_metrics

    t_phase = time.perf_counter()
    cfg = train_config(decay_learning_rate_mode=1, test_interval=5,
                       checkpoint_interval=10)
    dirs = write_synthetic_corpus(os.path.join(tmp, "corpus"), cfg)
    a = check_train_step_card_vs_cpu(dev, dirs)
    b = check_features_card_vs_cpu(dev, dirs)

    # (c) the driver: GRAPH_FIRST steps, then a resume to GRAPH_STEPS with
    # steps 11-15 traced: phase 8 (d)'s eager reference, whose graph run
    # resumes at GRAPH_FIRST too
    run = os.path.join(tmp, "run")
    samples = os.path.join(run, "samples")
    profile = os.path.join(tmp, "profile")
    t0 = time.perf_counter()
    for steps, trace in ((GRAPH_FIRST, None), (GRAPH_STEPS, profile)):
        state = train(run, dirs, cfg, num_steps=steps, device=dev,
                      test_dump_dir=samples, profile_dir=trace)
        require(state.step == steps, f"(c) a run to step {steps} ended at "
                                     f"{state.step}")
    wall_c = time.perf_counter() - t0
    records = read_metrics(os.path.join(run, "metrics.jsonl"))
    trains = [r for r in records if r["kind"] == "train"]
    evals = [r for r in records if r["kind"] == "eval"]
    require([r["step"] for r in trains] == list(range(1, GRAPH_STEPS + 1)),
            f"(c) train steps {[r['step'] for r in trains]}")
    require(all(set(r) == TRAIN_KEYS for r in trains),
            f"(c) metric keys {sorted(trains[0])}")
    require(all(np.isfinite(r["loss"]) for r in trains),
            "(c) a loss is not finite")
    require([r["step"] for r in evals] == [5, 10, 15],
            f"(c) eval steps {[r['step'] for r in evals]}")
    first = float(np.mean([r["loss"] for r in trains[:5]]))
    last = float(np.mean([r["loss"] for r in trains[-5:]]))
    require(last < first, f"(c) loss did not fall: steps 1-5 {first}, "
                          f"{GRAPH_STEPS - 4}-{GRAPH_STEPS} {last}")
    # every 10 steps, and where the resumed call ended
    require(checkpoint_steps(run) == [10, 15],
            f"(c) checkpoints {checkpoint_steps(run)}")
    wavs = sorted(n for n in os.listdir(samples) if n.endswith(".wav"))
    require(wavs == [f"step{s:09d}.wav" for s in (5, 10, 15)],
            f"(c) sample dumps {wavs}")
    with open(os.path.join(profile, "summary.json")) as fh:
        prof = json.load(fh)
    require(prof["device_kernels"] > 0,
            "(c) the profiler saw no device kernel in steps 11-15")
    log(f"[train] (c) driver: {GRAPH_STEPS} steps ({GRAPH_FIRST}, then "
        f"resumed) in {wall_c:.1f} s, loss {first:.4f} (steps 1-5) -> "
        f"{last:.4f} ({GRAPH_STEPS - 4}-{GRAPH_STEPS}), evals at 5/10/15, "
        f"checkpoints "
        f"{checkpoint_steps(run)}, steps 11-15 traced: "
        f"{prof['device_kernels']} kernels, device busy "
        f"{prof['device_busy_ms']:.1f} ms of {prof['wall_s']:.3f} "
        f"s, idle share {prof['device_idle_share']:.4f}")
    timing = time_steps_from_checkpoint(dev, dirs, run)

    # (d) resident corpus with on-device features
    cfg_d = train_config(decay_learning_rate_mode=1,
                         device_resident_corpus=True,
                         on_device_features=True, test_interval=1000,
                         checkpoint_interval=1000)
    run_d = os.path.join(tmp, "run_resident")
    state = train(run_d, dirs, cfg_d, num_steps=5, device=dev)
    rec_d = read_metrics(os.path.join(run_d, "metrics.jsonl"), "train")
    require([r["step"] for r in rec_d] == [1, 2, 3, 4, 5]
            and all(np.isfinite(r["loss"]) for r in rec_d),
            f"(d) resident run: {rec_d}")
    with open(os.path.join(run_d, "train.log")) as fh:
        require("resident corpus:" in fh.read(),
                "(d) the run did not use the resident corpus")
    log(f"[train] (d) resident corpus, on-device features: losses "
        f"{[round(r['loss'], 5) for r in rec_d]}")

    # (e) from training back to serving: the port's checkpoint through
    # K1
    synth = Synthesizer(device=dev).load(run)
    gl_iteration.launches = 0
    res = synth.synthesize(texts=KOREAN[:1], speaker_ids=[1],
                           max_steps=50, fast_vocoder=True,
                           librosa_trim=False)
    torch.cuda.synchronize()
    k1 = gl_iteration.launches
    require(k1 > 0, "(e) the trained checkpoint's synthesis launched "
                    "no fused Griffin-Lim kernel")
    audio = check_waveforms(res, cfg.audio.hop_length, "(e)")
    log(f"[train] (e) Synthesizer.load(run dir) at step {GRAPH_STEPS}: one "
        f"sentence, 50 steps, fast vocoder: {audio} samples, K1 "
        f"launches {k1}")
    wall = time.perf_counter() - t_phase
    log(f"[train] phase 6 wall time {wall:.1f} s")
    return {"card_vs_cpu": a, "features_max_abs": b,
            "loss_first5": first, "loss_last5": last,
            "profile": prof, "timing": timing, "k1_launches": k1,
            "wall_s": wall, "run_dir": run, "corpus": dirs, "config": cfg}


# ----------------------------------------------------------------- serving

#: short phrases of at most 12 tokens: the server's adaptive budget gives
#: them the 50-step rung (200 frames), the fused engine's (K1) range
SHORT = ["안녕", "좋아요", "반가워요", "고마워요", "잘 자요"]


def kernel_counters() -> dict:
    from tacotron_tpu_torch.ops.kernels.gl_fused import gl_iteration
    from tacotron_tpu_torch.ops.kernels.griffin_lim import spectral_step
    from tacotron_tpu_torch.ops.kernels.ola import overlap_add_batched
    return {"K1": gl_iteration, "K2": overlap_add_batched,
            "K3": spectral_step}


def zero_counts() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in kernel_counters().items()}


class CallLog:
    """Wraps ``obj.name`` (on the instance) to record the kernel launch
    counts after each call, so a step can tell its passes apart."""

    def __init__(self, obj, name: str):
        self.obj, self.name, self.after = obj, name, []

    def __enter__(self):
        inner = getattr(self.obj, self.name)

        def wrapped(*args, **kwargs):
            out = inner(*args, **kwargs)
            self.after.append(read_counts())
            return out

        setattr(self.obj, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        delattr(self.obj, self.name)


def timed(fn):
    """(result, wall seconds) of a call that returns host arrays."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def wav_rate(body: bytes) -> tuple:
    """(sample rate, frames) of a WAV response body."""
    import io
    import wave
    require(body[:4] == b"RIFF", f"not a WAV: {body[:16]!r}")
    with wave.open(io.BytesIO(body)) as fh:
        return fh.getframerate(), fh.getnframes()


def http(port: int, method: str, path: str, body=None, ctype=None):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    headers = {"Content-Type": ctype} if ctype else {}
    conn.request(method, path, body=body, headers=headers)
    resp = conn.getresponse()
    out = (resp.status, resp.getheader("Content-Type"), resp.read())
    conn.close()
    return out


def check_server(synth, tmp: str, sr: int, long_text: str,
                 zero=zero_counts, read=read_counts) -> dict:
    """(e) ``make_handler`` and ``SynthWorker`` on the card synthesizer, on
    an ephemeral port with the worker on a thread: one GET, four
    concurrent GETs (coalesced), a long POST (the chunked route) and a
    cached repeat.  ``zero``/``read`` count the kernels (the wrappers'
    counters, or a trace)."""
    import json as _json
    import os
    import threading
    import urllib.parse
    from http.server import ThreadingHTTPServer

    from tacotron_tpu_torch.app import SynthWorker, make_handler

    worker = SynthWorker(synth)
    httpd = ThreadingHTTPServer(
        ("127.0.0.1", 0),
        make_handler(worker, os.path.join(tmp, "web_cache"), "random"))
    stop = threading.Event()

    def serve():
        while not stop.is_set():
            worker.run_once()

    threads = [threading.Thread(target=httpd.serve_forever, daemon=True),
               threading.Thread(target=serve, daemon=True)]
    for t in threads:
        t.start()
    port = httpd.server_address[1]

    def get(text, speaker=0):
        query = urllib.parse.urlencode({"text": text, "speaker_id": speaker})
        return http(port, "GET", "/generate?" + query)

    out = {}
    try:
        with CallLog(synth, "synthesize") as calls:
            zero()
            (status, ctype, body), out["single_s"] = timed(
                lambda: get(SHORT[0]))
            require(status == 200 and ctype == "audio/wav",
                    f"(e) GET: {status} {ctype} {body[:200]!r}")
            rates, first_body = [wav_rate(body)], body

            before = worker.batched_calls
            walls = [None] * 4

            def client(i):
                t0 = time.perf_counter()
                walls[i] = (get(SHORT[1 + i], i % 2),
                            time.perf_counter() - t0)

            burst = [threading.Thread(target=client, args=(i,))
                     for i in range(4)]
            t0 = time.perf_counter()
            for t in burst:
                t.start()
            for t in burst:
                t.join(300)
            out["burst_s"] = time.perf_counter() - t0
            require(all(w is not None and w[0][0] == 200 for w in walls),
                    f"(e) burst: {[w and w[0][:2] for w in walls]}")
            rates += [wav_rate(w[0][2]) for w in walls]
            out["burst_request_s"] = [w[1] for w in walls]
            out["batched_calls"] = worker.batched_calls - before
            require(out["batched_calls"] > 0,
                    "(e) four concurrent GETs were not coalesced")
            out["launches_short"] = read()
            require(out["launches_short"]["K1"] > 0,
                    "(e) the short requests launched no fused Griffin-Lim "
                    "kernel")

            zero()
            (status, ctype, body), out["post_s"] = timed(lambda: http(
                port, "POST", "/generate",
                _json.dumps({"text": long_text, "speaker_id": 1}),
                "application/json"))
            require(status == 200, f"(e) POST: {status} {body[:200]!r}")
            rates.append(wav_rate(body))
            out["launches_post"] = read()
            require(out["launches_post"]["K2"] > 0,
                    "(e) the long POST launched no overlap-add kernel")

            n_calls = len(calls.after)
            status, _, body = get(SHORT[0])
            require(status == 200 and body == first_body,
                    "(e) the repeat GET was not served from the cache")
            require(len(calls.after) == n_calls,
                    "(e) a cached request synthesized again")
        require(all(rate == sr and n > 0 for rate, n in rates),
                f"(e) responses (rate, frames): {rates}")
        out["responses"] = len(rates) + 1
    finally:
        stop.set()
        worker.jobs.put(("job", lambda: None))  # wake the worker to exit
        httpd.shutdown()
        httpd.server_close()
        for t in threads:
            t.join(60)
    return out


def serve_phase(dev, synth, trained: dict, tmp: str) -> dict:
    """Phase 7: the serving entry points on the card, (a)-(h) of the module
    docstring, on phase 4's synthesizer and phase 6's run dir."""
    import os

    from tacotron_tpu_torch import compat
    from tacotron_tpu_torch.compat.__main__ import main as compat_main
    from tacotron_tpu_torch.eval import main as eval_main
    from tacotron_tpu_torch.synth import Synthesizer
    from tacotron_tpu_torch.text import text_to_sequence
    from tacotron_tpu_torch.text.eval_sentences import EVAL_TEXTS
    from tacotron_tpu_torch.train.checkpoint import checkpoint_steps
    from tacotron_tpu_torch.train.driver import train

    t_phase = time.perf_counter()
    cfg = synth.config
    sr, hop = cfg.audio.sample_rate, cfg.audio.hop_length
    serve = {}
    kw = dict(texts=KOREAN, speaker_ids=[0, 1, 0, 1], max_steps=50,
              fast_vocoder=True, librosa_trim=False)

    # (a) post-hoc manual attention: a decode alone, then one through K1
    with CallLog(synth, "_forward") as passes:
        zero_counts()
        res, serve["manual_s"] = timed(
            lambda: synth.synthesize(manual_attention_mode=1, **kw))
        launches = read_counts()
    require(len(passes.after) == 2 and passes.after[0]["K1"] == 0,
            f"(a) passes {passes.after}")
    require(launches["K1"] > 0, f"(a) launches {launches}")
    serve["launches"] = {"a": launches}
    check_waveforms(res, hop, "(a)")
    require(all(set(np.unique(al)) <= {0.0, 1.0} for al in res["alignments"]),
            "(a) the second pass did not attend one-hot")
    log(f"[serve] (a) manual_attention_mode=1, 4 x 50 steps: "
        f"{serve['manual_s']:.3f} s, launches after the first pass "
        f"{passes.after[0]}, after the call {launches}")

    # (b) the health check and the retry pass, with the sharpness gate:
    # random weights give diffuse attention, while their soft-monotonic
    # argmax path may still sweep the text
    with CallLog(synth, "synthesize") as calls:
        zero_counts()
        res, serve["robust_s"] = timed(lambda: synth.synthesize_robust(
            retry_mode=1, health_kwargs={"soft_monotonic": False}, **kw))
    require(res["retried"], "(b) random weights passed the health gate")
    require(len(calls.after) == 2 and calls.after[0]["K1"] > 0
            and calls.after[1]["K1"] > calls.after[0]["K1"],
            f"(b) K1 launches after each pass: {calls.after}")
    check_waveforms(res, hop, "(b)")
    serve["launches"]["b"] = calls.after[-1]
    gate = res["attention_health"][0]["gate"]
    log(f"[serve] (b) synthesize_robust(retry_mode=1), 4 x 50 steps: "
        f"{serve['robust_s']:.3f} s, gate {gate}, retried {res['retried']}, "
        f"focus {[round(h['focus'], 3) for h in res['attention_health']]}, "
        f"coverage "
        f"{[round(h['coverage'], 3) for h in res['attention_health']]}, "
        f"launches after each pass {calls.after}")

    # (c) a long paragraph: one batched call over its chunks, through K2
    paragraph = ". ".join(EVAL_TEXTS[:5]) + "."
    n_tokens = len(text_to_sequence(paragraph, synth.cleaner_names()))
    with CallLog(synth, "synthesize") as calls:
        zero_counts()
        out, serve["long_s"] = timed(lambda: synth.synthesize_long(
            paragraph, speaker_id=1, max_chunk_tokens=120, robust=False,
            fast_vocoder=True, librosa_trim=False))
        launches = read_counts()
    chunks = out["chunks"]
    require(n_tokens > 240 and len(chunks) >= 3,
            f"(c) {n_tokens} tokens in {len(chunks)} chunks")
    require(len(calls.after) == 1, f"(c) {len(calls.after)} synthesize calls")
    require(launches["K2"] > 0, f"(c) launches {launches}")
    serve["launches"]["c"] = launches
    check_waveforms(out["parts"], hop, "(c)")
    gaps = sum(int(sr * (0.18 if c.rstrip()[-1] in ".!?" else 0.08))
               for c in chunks[:-1])
    require(out["wav"].size == sum(w.size for w in out["parts"]["wavs"])
            + gaps, "(c) stitched length is not the pieces plus the gaps")
    require(np.isfinite(out["wav"]).all(), "(c) waveform not finite")
    serve["long_audio_s"] = out["wav"].size / sr
    log(f"[serve] (c) synthesize_long: {n_tokens} tokens in {len(chunks)} "
        f"chunks, {serve['long_s']:.3f} s for {serve['long_audio_s']:.2f} s "
        f"of audio, launches {launches}")

    # (d) host and spectrogram-only vocoding against the chip's decode
    kw2 = dict(texts=KOREAN[:2], speaker_ids=[0, 1], max_steps=50,
               fast_vocoder=True, librosa_trim=False)
    decoded = []
    hook = synth.model.register_forward_hook(
        lambda m, a, o: decoded.append(o["linear_outputs"].float().cpu()))
    try:
        chip, serve["chip_s"] = timed(lambda: synth.synthesize(**kw2))
    finally:
        hook.remove()
    results = {}
    for vocode in ("none", "host"):
        zero_counts()
        results[vocode], serve[f"{vocode}_s"] = timed(
            lambda: synth.synthesize(vocode=vocode, **kw2))
        require(read_counts() == {"K1": 0, "K2": 0, "K3": 0},
                f"(d) vocode={vocode} launched {read_counts()}")
        require(results[vocode]["ends"] == chip["ends"],
                f"(d) vocode={vocode} ends {results[vocode]['ends']} != "
                f"chip {chip['ends']}")
    card = decoded[0].numpy()
    lin_err = max(float(np.abs(spec - card[i, :len(spec)]).max())
                  / float(np.abs(card[i]).max())
                  for i, spec in enumerate(results["none"]["linear"]))
    require(lin_err <= 1e-3, f"(d) linear differs from the chip decode by "
                             f"{lin_err} of the peak")
    for wav, end in zip(results["host"]["wavs"], results["host"]["ends"]):
        # the host inversion gives (frames - 1) hops, as in JAX
        require(wav.size == (end - 1) * hop and np.isfinite(wav).all()
                and float(np.abs(wav).max()) > 0.0,
                f"(d) host: {wav.size} samples for {end} frames")
    require(all(w.size == 0 for w in results["none"]["wavs"]),
            "(d) vocode='none' returned audio")
    log(f"[serve] (d) 2 x 50 steps: chip {serve['chip_s']:.3f} s, host "
        f"{serve['host_s']:.3f} s, none {serve['none_s']:.3f} s, ends "
        f"{chip['ends']}, linear vs the chip decode {lin_err:.3e} of the "
        f"peak")

    # (e) the HTTP server
    serve.update(check_server(synth, tmp, sr,
                              ". ".join(EVAL_TEXTS[5:]) + "."))
    serve["launches"].update(e_short=serve["launches_short"],
                             e_post=serve["launches_post"])
    log(f"[serve] (e) server: one GET {serve['single_s']:.3f} s, burst of 4 "
        f"{serve['burst_s']:.3f} s (requests "
        f"{[round(x, 3) for x in serve['burst_request_s']]}), coalesced "
        f"calls {serve['batched_calls']}, long POST {serve['post_s']:.3f} s,"
        f" launches short {serve['launches_short']} post "
        f"{serve['launches_post']}, {serve['responses']} WAV responses at "
        f"{sr} Hz")

    # (f) the eval CLI on phase 6's run dir
    run = trained["run_dir"]
    samples = os.path.join(tmp, "eval_samples")
    t0 = time.perf_counter()
    eval_main(["--load_path_pattern", run, "--sample_path", samples,
               "--attention_retry", "1", "--max_steps", "50",
               "--texts", *KOREAN[:2]])
    serve["eval_s"] = time.perf_counter() - t0
    d = os.path.join(samples, os.path.basename(run), "speaker0")
    names = sorted(os.listdir(d))
    require([n for n in names if n.endswith(".wav")]
            == ["eval000_0.wav", "eval000_1.wav"], f"(f) wrote {names}")
    log(f"[serve] (f) eval CLI with --attention_retry 1: {names} in "
        f"{serve['eval_s']:.1f} s")

    # (g) TF1 interchange: export, import, the same waveforms, a resume
    prefix = os.path.join(tmp, "tf1", "model.ckpt-30")
    imported = os.path.join(tmp, "run_imported")
    t0 = time.perf_counter()
    require(compat_main(["export", run, prefix]) == 0, "(g) export failed")
    require(compat_main(["import", prefix, "--run_dir", imported, "--config",
                         os.path.join(run, "config.json")]) == 0,
            "(g) import failed")
    n_vars = len(compat.read_checkpoint(prefix))
    wavs = [Synthesizer(dev).load(r).synthesize(
        texts=KOREAN[:1], speaker_ids=[1], max_steps=50, fast_vocoder=True,
        librosa_trim=False)["wavs"][0] for r in (run, imported)]
    require(wavs[0].size > 0 and np.array_equal(wavs[0], wavs[1]),
            "(g) the imported run dir does not give bit-identical audio")
    state = train(imported, trained["corpus"], trained["config"],
                  num_steps=1, device=dev)
    require(state.step == 1 and checkpoint_steps(imported) == [0, 1],
            f"(g) resume: step {state.step}, checkpoints "
            f"{checkpoint_steps(imported)}")
    serve["compat_s"] = time.perf_counter() - t0
    log(f"[serve] (g) compat: {n_vars} TF1 variables, export -> import -> "
        f"bit-identical waveforms ({wavs[0].size} samples), resumed to step "
        f"1, {serve['compat_s']:.1f} s")

    serve["wall_s"] = time.perf_counter() - t_phase
    return serve


# ------------------------------------------------------------------ graphs

def median_wall(fn, n: int = 3):
    """(last result, median wall seconds) of ``n`` synchronized calls."""
    walls = []
    for _ in range(n):
        out, wall = timed(fn)
        walls.append(wall)
    return out, statistics.median(walls)


#: the port's kernels in a trace (``synth/profile.py::kernel_group``), by
#: the wrapper whose count they match: a K1 count is one of its four
#: kernels, a K2 count its one kernel, a K3 count one C call of three
#: kernels (cast, forward and inverse product), counted by its forward one
TRACE_GROUPS = {"K1": ("gl_frame_uv", "gl_dft_project", "gl_idft_window",
                       "gl_ola_norm"),
                "K2": ("ola_centered",), "K3": ("gl_spectral_dft",)}


def trace_counts(summary: dict) -> dict:
    """K1/K2/K3 launches in a trace summary (``TraceWindow.stop``): what a
    graph's replay launched, which the wrappers' counters do not see."""
    by = summary["device_launches_by_group"]
    k3 = [by.get(g, 0) for g in ("gl_spectral_cast", "gl_spectral_dft",
                                 "gl_spectral_idft")]
    require(len(set(k3)) == 1, f"K3's three kernels ran {k3} times")
    return {k: sum(by.get(g, 0) for g in groups)
            for k, groups in TRACE_GROUPS.items()}


def traced(fn):
    """(result, trace summary) of one synchronized call of ``fn``."""
    from tacotron_tpu_torch.synth.profile import TraceWindow
    window = TraceWindow(torch.device("cuda")).start()
    out = fn()
    return out, window.stop()


class TraceCounts:
    """``zero``/``read`` for :func:`check_server` that count the port's
    kernels in a trace from one to the other (:func:`trace_counts`)."""

    def zero(self) -> None:
        from tacotron_tpu_torch.synth.profile import TraceWindow
        self.window = TraceWindow(torch.device("cuda")).start()

    def read(self) -> dict:
        return trace_counts(self.window.stop())


def replays(synth) -> int:
    return sum(g.replays for g in synth._graphs.values())


def compare_results(got, want, what: str) -> float:
    """Replayed against eager: the same ends, alignments and waveforms.
    Returns the largest waveform difference over the peak."""
    require(got["ends"] == want["ends"],
            f"{what}: ends {got['ends']} != eager {want['ends']}")
    err = 0.0
    for a, b in zip(got["wavs"], want["wavs"]):
        require(a.shape == b.shape, f"{what}: {a.shape} != {b.shape}")
        err = max(err, float(np.abs(a - b).max()) / float(np.abs(b).max()))
    al = max(float(np.abs(a - b).max())
             for a, b in zip(got["alignments"], want["alignments"]))
    # the same kernels on the same inputs: bit-equal is expected; the limit
    # is 1e-6 of the peak
    require(err <= 1e-6 and al <= 1e-6,
            f"{what}: waveforms differ by {err} of the peak, alignments by "
            f"{al}")
    return err


def replay_once(s, call, what: str, want: dict) -> None:
    """One call that must replay one graph per chunk and launch nothing
    through the kernel wrappers, equal to the eager result ``want``."""
    chunks = len(s._chunks(len(want["ends"])))
    before = replays(s)
    zero_counts()
    got = call()
    torch.cuda.synchronize()
    require(replays(s) == before + chunks,
            f"{what}: {replays(s) - before} replays, not {chunks}")
    require(not any(read_counts().values()),
            f"{what}: the wrappers launched {read_counts()} during replays")
    compare_results(got, want, what)


def check_chunk_stamps(s, call, what: str) -> dict:
    """The device clock stamps of a replayed call (``csrc/stamp.cu``, three
    a chunk): the last replay's, read from its graph's static output, in
    order and within the call's wall time; the call's decode and vocoder
    device ms (``collect_timings``, from every chunk's stamps) positive and
    together within it."""
    before = {k: g.replays for k, g in s._graphs.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = call(collect_timings=True)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    (key,) = [k for k, g in s._graphs.items() if g.replays > before[k]]
    s0, s1, s2 = s._graphs[key].outputs[2].tolist()
    require(0 < s0 <= s1 <= s2 and (s2 - s0) / 1e6 <= wall_ms,
            f"{what}: the last chunk's stamps {[s0, s1, s2]} are out of "
            f"order or span more than the call's {wall_ms:.3f} ms")
    t = res["timings"]
    decode, vocoder = t["decode_device_ms"], t["vocoder_device_ms"]
    require(t["chunks_replayed"] == t["chunks"] > 0 and decode > 0.0
            and vocoder > 0.0 and decode + vocoder <= wall_ms,
            f"{what}: stamps give decode {decode} ms and vocoder {vocoder} "
            f"ms over {t['chunks_replayed']} of {t['chunks']} chunks "
            f"replayed, against a {wall_ms:.3f} ms call")
    return dict(chunks=t["chunks"], wall_ms=wall_ms, decode_ms=decode,
                vocoder_ms=vocoder, last_chunk_ms=[(s1 - s0) / 1e6,
                                                   (s2 - s1) / 1e6])


def serving_graphs(main: dict, tmp: str) -> dict:
    """Phase 8 (a)-(c): the main path's three calls replayed against eager,
    two chunks of one program and replays out of capture order, then the
    server after the app's ``--prewarm``.  A replay's kernel launches are
    counted in a trace of it and held against the eager call's counts."""
    import os

    from tacotron_tpu_torch.app import prewarm_server
    from tacotron_tpu_torch.synth.synthesizer import prewarm_step_rungs

    out, eager = {}, {}
    synth = main["synth"]

    def key_args(s, kw):
        return s.prewarm_args(kw["texts"], max_steps=kw["max_steps"],
                              fast_vocoder=kw.get("fast_vocoder", False))

    # (a) each call eagerly, then its key captured and replayed
    for name, (s, kw) in main["calls"].items():
        kw = dict(kw, librosa_trim=False)
        call = (lambda s=s, kw=kw: s.synthesize(**kw))
        zero_counts()
        want = call()
        torch.cuda.synchronize()
        counts_e = read_counts()
        _, wall_e = median_wall(call)
        _, trace_e = traced(call)
        require(trace_counts(trace_e) == counts_e,
                f"(a) call ({name}): the eager trace counts "
                f"{trace_counts(trace_e)}, the wrappers {counts_e}")
        eager[name] = want
        args = key_args(s, kw)
        t0 = time.perf_counter()
        n = s.prewarm(**args)
        capture_s = time.perf_counter() - t0
        rungs = prewarm_step_rungs(s.config, args["token_buckets"],
                                   args["max_steps"])
        require(n == sum(map(len, rungs.values())) * len(args["batch_sizes"]),
                f"(a) call ({name}): prewarm returned {n}")
        replay_once(s, call, f"(a) call ({name})", want)
        _, wall_g = median_wall(call)
        _, trace_g = traced(call)
        counts_g = trace_counts(trace_g)
        require(counts_g == counts_e, f"(a) call ({name}): launches in the "
                f"replay's trace {counts_g} != eager {counts_e}")
        idle_e, idle_g = (t["device_idle_share"] for t in (trace_e, trace_g))
        out[name] = dict(eager_s=wall_e, replay_s=wall_g, eager_idle=idle_e,
                         replay_idle=idle_g, capture_s=capture_s,
                         launches=counts_g)
        log(f"[graphs] (a) call ({name}): eager {wall_e:.4f} s (idle "
            f"{idle_e:.4f}), replay {wall_g:.4f} s (idle {idle_g:.4f}), "
            f"capture {capture_s:.2f} s, launches {counts_e} eager (wrappers"
            f" and trace), {counts_g} in the replay's trace, waveforms "
            f"bit-equal within 1e-6 of the peak")

    # (b) 32 sentences at chunks of 16: one program twice in one call
    s, kw = main["calls"]["a"]
    kw32 = dict(kw, texts=KOREAN * 8, speaker_ids=[i % 2 for i in range(32)],
                librosa_trim=False)
    call32 = (lambda: s.synthesize(**kw32))
    zero_counts()
    want32 = call32()
    torch.cuda.synchronize()
    counts_e = read_counts()
    args = key_args(s, kw32)
    require(args["batch_sizes"] == (16,), f"(b) chunk sizes {args}")
    s.prewarm(**args)
    replay_once(s, call32, "(b) two chunks of one program", want32)
    out["stamps"] = check_chunk_stamps(
        s, lambda **kw: s.synthesize(**kw32, **kw), "(b) stamps")
    _, trace = traced(call32)
    require(trace_counts(trace) == counts_e and counts_e["K1"] > 0,
            f"(b) launches in the replays' trace {trace_counts(trace)} vs "
            f"eager {counts_e}")
    # out of capture order: the batch-16 program, then (b)'s, then (a)'s
    replay_once(s, call32, "(b) reordered, 32 sentences", want32)
    for name in ("b", "a"):
        s_, kw_ = main["calls"][name]
        replay_once(s_, lambda: s_.synthesize(**dict(kw_, librosa_trim=False)),
                    f"(b) reordered, call ({name})", eager[name])
    st = out["stamps"]
    log(f"[graphs] (b) 32 sentences in two chunks of one program: equal to "
        f"eager (launches {counts_e}, the same in the replays' trace); "
        f"replays out of capture order equal to eager; the chunks' device "
        f"clock stamps in order, decode {st['decode_ms']:.3f} ms and "
        f"vocoder {st['vocoder_ms']:.3f} ms of a {st['wall_ms']:.3f} ms "
        f"call")

    # (c) the server after the app's --prewarm; kernels counted in a trace
    t0 = time.perf_counter()
    n = prewarm_server(synth)
    out["server_prewarm_s"] = time.perf_counter() - t0
    rungs = prewarm_step_rungs(synth.config, (32, 64, 96, 128))
    require(n == 3 * sum(map(len, rungs.values())) == 21,
            f"(c) the app's prewarm returned {n}")
    before = replays(synth)
    from tacotron_tpu_torch.text.eval_sentences import EVAL_TEXTS
    counter = TraceCounts()
    server = check_server(synth, os.path.join(tmp, "graphs"),
                          synth.config.audio.sample_rate,
                          ". ".join(EVAL_TEXTS[5:]) + ".",
                          zero=counter.zero, read=counter.read)
    out["server_replays"] = replays(synth) - before
    require(out["server_replays"] >= 4,
            f"(c) the server replayed {out['server_replays']} times")
    out["server"] = {k: server[k] for k in (
        "single_s", "burst_s", "burst_request_s", "post_s",
        "launches_short", "launches_post", "batched_calls")}
    log(f"[graphs] (c) server after --prewarm ({n} programs in "
        f"{out['server_prewarm_s']:.1f} s), traced: one GET "
        f"{server['single_s']:.4f} s, burst of 4 {server['burst_s']:.4f} s "
        f"(requests {[round(x, 4) for x in server['burst_request_s']]}), "
        f"long POST {server['post_s']:.4f} s, {out['server_replays']} "
        f"replays, launches in the trace: short {server['launches_short']}"
        f" post {server['launches_post']}")
    return out


def run_losses_and_params(run: str, steps=None, at=None):
    """The train losses of a run's first ``steps`` steps (default all) and
    the parameters of its checkpoint at step ``at`` (default the
    newest)."""
    import os

    from tacotron_tpu_torch.train.checkpoint import checkpoint_path
    from tacotron_tpu_torch.utils import read_metrics

    losses = [r["loss"] for r in read_metrics(
        os.path.join(run, "metrics.jsonl"), "train")][:steps]
    return losses, dict(np.load(checkpoint_path(run, at)))


#: phase 8 (d)'s runs: this many steps, then a resume to GRAPH_STEPS (20
#: and 30 until phase 13 came; cut for time); phase 6 (c) resumes at the
#: same steps
GRAPH_FIRST, GRAPH_STEPS = 10, 15
#: graph run against eager: the largest loss difference over the loss and
#: parameter difference over the largest parameter (phase 8 (d) held them
#: to twice the spread of two eager runs, or this where it was smaller;
#: the spread was 0 in every run)
GRAPH_LIMIT = 1e-5


def run_spread(a, b, steps: int = GRAPH_STEPS) -> tuple:
    """(largest per-step loss difference over the loss, largest parameter
    difference over the largest parameter) between two runs of
    ``steps`` steps."""
    (la, pa), (lb, pb) = a, b
    require(len(la) == len(lb) == steps, f"{len(la)} and {len(lb)} steps")
    loss = max(abs(x - y) / abs(x) for x, y in zip(la, lb))
    peak = max(float(np.abs(v).max()) for v in pa.values())
    param = max(float(np.abs(pa[k] - pb[k]).max()) for k in pa) / peak
    return loss, param


def train_graphs(dev, trained: dict, tmp: str) -> dict:
    """Phase 8 (d): ``train(..., prewarm=True)`` for ``GRAPH_FIRST`` steps
    and a resume to ``GRAPH_STEPS`` on phase 6's corpus, config and seed,
    against phase 6's eager run, which resumes at ``GRAPH_FIRST`` too
    (every loss to ``GRAPH_STEPS``, the parameters at ``GRAPH_FIRST`` and
    ``GRAPH_STEPS``); then eager and replayed steps timed on the same
    batches."""
    import os

    from tacotron_tpu_torch.data import DataFeeder
    from tacotron_tpu_torch.train.checkpoint import CheckpointManager
    from tacotron_tpu_torch.train.driver import train
    from tacotron_tpu_torch.train.profile import time_train_steps
    from tacotron_tpu_torch.train.state import create_train_state
    from tacotron_tpu_torch.train.step import (TrainStep, batch_to_device,
                                               make_train_step)

    cfg, dirs = trained["config"], trained["corpus"]
    graph_run = os.path.join(tmp, "run_graphs")
    profile = os.path.join(tmp, "profile_graphs")
    shapes = DataFeeder(dirs, cfg, data_type="train",
                        seed=123).bucket_shapes()
    # every step of the graph run: its padded (tokens, frames) and whether
    # it replayed a graph
    hop = cfg.audio.hop_length
    steps_seen = []
    step_call = TrainStep.__call__

    def counted(self, state, batch, seed):
        before = sum(g.replays for g in self._graphs.values())
        out = step_call(self, state, batch, seed)
        frames = (batch.mel_targets.shape[1] if batch.mel_targets is not None
                  else batch.waveforms.shape[1] // hop + 1)
        steps_seen.append(((batch.inputs.shape[1], frames), sum(
            g.replays for g in self._graphs.values()) - before))
        return out

    TrainStep.__call__ = counted
    t0 = time.perf_counter()
    try:
        train(graph_run, dirs, cfg, num_steps=GRAPH_FIRST, device=dev,
              prewarm=True)
        # the trace of the resumed steps (the driver's window, steps 11-15)
        state = train(graph_run, dirs, cfg, num_steps=GRAPH_STEPS,
                      device=dev, profile_dir=profile, prewarm=True)
    finally:
        TrainStep.__call__ = step_call
    graph_s = time.perf_counter() - t0
    require(state.step == GRAPH_STEPS,
            f"(d) graph run ended at {state.step}")
    ladder = {tuple(map(int, sh)) for sh in shapes}
    replayed = sum(n for _, n in steps_seen)
    require(len(steps_seen) == GRAPH_STEPS and all(
        n == (sh in ladder) for sh, n in steps_seen) and replayed > 0,
        f"(d) steps (shape, replays) {steps_seen}: a step of a bucket shape "
        f"{sorted(ladder)} must replay once, any other none")
    with open(os.path.join(graph_run, "train.log")) as fh:
        text = fh.read()
    require(text.count(f"prewarming {len(shapes)} bucket program(s)") == 2
            and text.count("prewarm done") == 2,
            f"(d) the graph run's log lacks the prewarm lines for "
            f"{len(shapes)} shapes")
    # phase 6's run and the graph run resume at GRAPH_FIRST alike (one
    # data order): every step's loss, the parameters where each call ended
    eager, graphs = (run_losses_and_params(run, GRAPH_STEPS, GRAPH_STEPS)
                     for run in (trained["run_dir"], graph_run))
    err = run_spread(eager, graphs)
    require(max(err) <= GRAPH_LIMIT,
            f"(d) graph run against phase 6 over {GRAPH_STEPS} steps: loss "
            f"{err[0]}, parameters at {GRAPH_STEPS} {err[1]} (limit "
            f"{GRAPH_LIMIT})")
    eager_head, graphs_head = (
        run_losses_and_params(run, GRAPH_FIRST, GRAPH_FIRST)
        for run in (trained["run_dir"], graph_run))
    err_head = run_spread(eager_head, graphs_head, GRAPH_FIRST)
    require(max(err_head) <= GRAPH_LIMIT,
            f"(d) graph run against phase 6 over {GRAPH_FIRST} steps: loss "
            f"{err_head[0]}, parameters at {GRAPH_FIRST} {err_head[1]} "
            f"(limit {GRAPH_LIMIT})")
    losses = graphs[0]
    first, last = (float(np.mean(losses[:5])),
                   float(np.mean(losses[GRAPH_STEPS - 5:])))
    require(last < first, f"(d) loss did not fall: {first} -> {last}")
    with open(os.path.join(profile, "summary.json")) as fh:
        prof = json.load(fh)

    # eager and replayed steps on the same 4 batches (after one warm-up
    # step each), from the graph run's last checkpoint
    state = CheckpointManager(graph_run, cfg).restore(
        create_train_state(cfg, seed=0, device=dev))
    batches = DataFeeder(dirs, cfg, seed=5).batches()
    host = [next(batches) for _ in range(5)]
    eager_t = time_train_steps(state, make_train_step(cfg), iter(host), 1, 4)
    step_fn = make_train_step(cfg)
    t0 = time.perf_counter()
    n = step_fn.prewarm(state, [batch_to_device(h, dev) for h in host])
    capture_s = time.perf_counter() - t0
    replay_t = time_train_steps(state, step_fn, iter(host), 1, 4)
    out = dict(graph_runs_s=graph_s, replayed_steps=replayed,
               graph_err=err, graph_err_head=err_head,
               loss_first5=first,
               loss_last5=last, bucket_shapes=len(shapes),
               replay_idle=prof["device_idle_share"],
               eager_idle=trained["profile"]["device_idle_share"],
               eager=eager_t, replay=replay_t, timing_graphs=n,
               timing_capture_s=capture_s)
    log(f"[graphs] (d) train(prewarm=True) {GRAPH_FIRST} + resume to "
        f"{GRAPH_STEPS} on {len(shapes)} bucket shapes ({replayed} of "
        f"{GRAPH_STEPS} steps replayed, "
        f"each step of a bucket shape): {graph_s:.1f} s; loss {first:.4f} "
        f"-> {last:.4f}; against phase 6's eager run over {GRAPH_STEPS} "
        f"steps: loss {err[0]:.3e}, parameters {err[1]:.3e}; at step "
        f"{GRAPH_FIRST}: loss {err_head[0]:.3e}, parameters "
        f"{err_head[1]:.3e}; steps 11-15 idle "
        f"{prof['device_idle_share']:.4f} (eager "
        f"{out['eager_idle']:.4f}); the same 4 batches: eager "
        f"{eager_t['sec_per_step']:.4f} s a step, "
        f"{eager_t['target_frames_per_s']:.1f} frames/s, peak "
        f"{eager_t['peak_memory_gib']:.2f} GiB allocated "
        f"({eager_t['peak_reserved_gib']:.2f} reserved); replayed "
        f"{replay_t['sec_per_step']:.4f} s, "
        f"{replay_t['target_frames_per_s']:.1f} frames/s, peak "
        f"{replay_t['peak_memory_gib']:.2f} GiB allocated "
        f"({replay_t['peak_reserved_gib']:.2f} reserved), {n} graphs "
        f"captured in {capture_s:.1f} s")
    return out


# ---------------------------------------------------------------- parallel

def parallel_config():
    """Phase 6's config with every batch padded to the corpus maxima: one
    batch shape (one graph to capture; one shape on every rank)."""
    import dataclasses

    cfg = train_config(decay_learning_rate_mode=1, test_interval=1000,
                       checkpoint_interval=10)
    return cfg.replace(data=dataclasses.replace(cfg.data,
                                                pad_to_corpus_max=True))


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rows_steps(cfg, dirs, dev, plan, rows, n: int = 3) -> dict:
    """``n`` train steps from seed 0 on ``rows`` of the first ``n`` global
    batches of 16 (a plan's rank: its rows through ``shard_batch``):
    the losses, the first step's gradient norm and Adam first moment
    (``(1 - b1)`` times its clipped gradient, by name) and the final
    parameters."""
    from tacotron_tpu_torch.data import DataFeeder
    from tacotron_tpu_torch.parallel import shard_batch, shard_params
    from tacotron_tpu_torch.train.state import create_train_state
    from tacotron_tpu_torch.train.step import (Batch, batch_to_device,
                                               make_train_step)

    state = create_train_state(cfg, seed=0, device=dev)
    if plan is not None:
        shard_params(plan, state.model)
    names = [k for k, _ in state.model.named_parameters()]
    step = make_train_step(cfg, plan)
    batches = DataFeeder(dirs, cfg, batch_size=16, seed=6).batches()
    out = {"losses": [], "m1": None}
    for _ in range(n):
        part = Batch(*(None if x is None else x[rows] for x in next(batches)))
        batch = (batch_to_device(part, dev) if plan is None
                 else shard_batch(plan, part, dev))
        state, metrics = step(state, batch, 1)
        out["losses"].append(float(metrics["loss"]))
        if out["m1"] is None:
            out["grad_norm1"] = float(metrics["grad_norm"])
            out["m1"] = {k: m.cpu().numpy()
                         for k, m in zip(names, state.opt.m)}
    out["params"] = {k: p.detach().cpu().numpy()
                     for k, p in state.model.named_parameters()}
    return out


def parallel_worker(argv) -> int:
    """Phase 9 (b): one of two ranks on the one card, a gloo group over
    CUDA tensors; writes its losses and parameters."""
    import argparse
    import os

    ap = argparse.ArgumentParser()
    ap.add_argument("--parallel-rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--corpus", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    os.environ.update(RANK=str(args.parallel_rank), WORLD_SIZE="2",
                      LOCAL_RANK="0", MASTER_ADDR="localhost",
                      MASTER_PORT=str(args.port))
    from tacotron_tpu_torch.parallel import distributed_initialize, make_mesh
    from tacotron_tpu_torch.parallel.distributed import shutdown

    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    distributed_initialize(device=dev, backend="gloo")
    try:
        cfg = parallel_config()
        plan = make_mesh(cfg.mesh)
        require(plan.data_size == 2 and plan.backend == "gloo",
                f"(b) plan {plan.grid} on {plan.backend}")
        r = plan.data_index
        got = rows_steps(cfg, args.corpus.split(","), dev, plan,
                         slice(8 * r, 8 * r + 8))
        np.savez(os.path.join(args.out, f"rank{r}.npz"),
                 losses=np.asarray(got["losses"]),
                 grad_norm1=got["grad_norm1"],
                 **{f"m1/{k}": v for k, v in got["m1"].items()},
                 **{f"p/{k}": v for k, v in got["params"].items()})
    finally:
        shutdown()
    return 0


def start_two_ranks(dirs, out: str, dev):
    """Phase 9 (b)'s two worker processes, started."""
    port = free_port()
    return [subprocess.Popen(
        [sys.executable, __file__, "--parallel-rank", str(r), "--port",
         str(port), "--corpus", ",".join(dirs), "--out", out, "--device",
         str(dev)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]


#: phase 9 (a)'s runs (10 steps each until phase 14 came; cut for time)
PARALLEL_STEPS = 5


def parallel_phase(dev, main: dict, trained: dict, tmp: str) -> dict:
    """Phase 9 (a)-(d) of the module docstring.  Returns its numbers."""
    import dataclasses
    import os

    import torch.distributed as dist

    from tacotron_tpu_torch.data import DataFeeder
    from tacotron_tpu_torch.parallel import (collectives,
                                             distributed_initialize,
                                             make_mesh, runtime_info)
    from tacotron_tpu_torch.parallel.distributed import shutdown
    from tacotron_tpu_torch.synth.synthesizer import make_sharded_synthesis
    from tacotron_tpu_torch.text import text_to_sequence
    from tacotron_tpu_torch.train.checkpoint import CheckpointManager
    from tacotron_tpu_torch.train.driver import train
    from tacotron_tpu_torch.train.profile import roofline, time_train_steps
    from tacotron_tpu_torch.train.state import create_train_state
    from tacotron_tpu_torch.train.step import (TrainStep, batch_to_device,
                                               make_train_step)

    t_phase = time.perf_counter()
    cfg, dirs = parallel_config(), trained["corpus"]
    # (b)'s ranks run beside (a), which is not timed
    b_out = os.path.join(tmp, "two_ranks")
    os.makedirs(b_out)
    workers = start_two_ranks(dirs, b_out, dev)
    out: dict = {}
    try:
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                          MASTER_ADDR="localhost",
                          MASTER_PORT=str(free_port()))
        distributed_initialize(device=dev)
        info = runtime_info()
        backend = "nccl" if dev.type == "cuda" else "gloo"
        require(info["backend"] == backend and info["process_count"] == 1,
                f"(a) process group {info}")
        plan = make_mesh(cfg.mesh)
        require(plan.shard is not None and plan.data_size == 1,
                f"(a) plan {plan}")

        # (a) PARALLEL_STEPS steps plain, data-parallel, data-parallel
        # replayed
        runs = {k: os.path.join(tmp, f"run_{k}")
                for k in ("plain", "dp", "dp_graphs")}
        steps_made = []
        prewarm = TrainStep.prewarm

        def keep(self, state, batches):
            steps_made.append(self)
            return prewarm(self, state, batches)

        t0 = time.perf_counter()
        n = PARALLEL_STEPS
        train(runs["plain"], dirs, cfg, num_steps=n, device=dev)
        train(runs["dp"], dirs, cfg, num_steps=n, device=dev, plan=plan)
        TrainStep.prewarm = keep
        try:
            train(runs["dp_graphs"], dirs, cfg, num_steps=n, device=dev,
                  plan=plan, prewarm=True)
        finally:
            TrainStep.prewarm = prewarm
        wall_a = time.perf_counter() - t0
        replayed = sum(g.replays for s in steps_made
                       for g in s._graphs.values())
        require(len(steps_made) == 1 and replayed == n,
                f"(a) {replayed} of {n} steps replayed a graph")
        got = {k: run_losses_and_params(v) for k, v in runs.items()}
        dp_err = run_spread(got["plain"], got["dp"], n)
        graph_err = run_spread(got["dp"], got["dp_graphs"], n)
        require(max(dp_err + graph_err) <= 1e-6,
                f"(a) data-parallel vs plain {dp_err}, replayed vs eager "
                f"{graph_err} (loss, parameters; limit 1e-6)")
        out.update(dp_vs_plain=dp_err, replay_vs_eager=graph_err,
                   wall_a_s=wall_a, runtime_info=info)
        log(f"[parallel] (a) NCCL world size 1, {n} steps at batch 16 "
            f"(corpus-max shape): data-parallel against plain: loss "
            f"{dp_err[0]:.3e}, parameters {dp_err[1]:.3e} (relative); "
            f"prewarmed ({n} of {n} steps replayed) against eager: loss "
            f"{graph_err[0]:.3e}, parameters {graph_err[1]:.3e}; "
            f"{wall_a:.1f} s for the three runs")

        # (b) two ranks on the one card
        single = rows_steps(cfg, dirs, dev, None, slice(0, 16))
        logs = []
        for p in workers:
            logs.append(p.communicate(timeout=300)[0])
        for p, text in zip(workers, logs):
            require(p.returncode == 0,
                    f"(b) a rank failed (exit {p.returncode}):\n"
                    f"{text[-3000:]}")
        two = []
        for r in range(2):
            raw = np.load(os.path.join(b_out, f"rank{r}.npz"))
            two.append(dict(
                losses=raw["losses"], grad_norm1=float(raw["grad_norm1"]),
                **{g: {k[len(g) + 1:]: raw[k] for k in raw.files
                       if k.startswith(g + "/")} for g in ("m1", "p")}))
        require(all(np.array_equal(two[0][g][k], two[1][g][k])
                    for g in ("m1", "p") for k in two[0][g]),
                "(b) the ranks' parameters differ")
        got = two[0]
        loss_rel = (np.abs(got["losses"] - single["losses"])
                    / np.abs(single["losses"]))
        # the first step's gradients through Adam's first moment, over the
        # global norm (the measure of tests/test_torch_train_step.py)
        g = single["grad_norm1"]
        scale = (min(1.0, cfg.train.grad_clip_norm / g) * g
                 * (1.0 - cfg.train.adam_beta1))
        grad_err = max(float(np.abs(got["m1"][k] - v).max()) / scale
                       for k, v in single["m1"].items())
        # After step 1 the runs part: Adam's first updates are about
        # lr * sign(g), so an element whose gradient lies within the two
        # summation orders' rounding moves the other way in one run; its
        # change then feeds the next forward.  Steps 2-3 are held within
        # the 2 lr a step such a flip can open (a broken collective
        # exceeds it at once); how far they stay within the CPU test's
        # rtol 1e-4 / atol 1e-6 (tests/test_torch_parallel.py, small
        # widths) is reported.
        lr_bound = 2 * cfg.train.initial_learning_rate * 3
        drift = max(float(np.abs(got["p"][k] - v).max())
                    for k, v in single["params"].items())
        beyond = sum(int(np.sum(np.abs(got["p"][k] - v)
                                > 1e-6 + 1e-4 * np.abs(v)))
                     for k, v in single["params"].items())
        total = sum(v.size for v in single["params"].values())
        param_rel = run_spread((single["losses"], single["params"]),
                               (got["losses"], got["p"]), 3)[1]
        log(f"[parallel] (b) two ranks on one card (gloo over CUDA "
            f"tensors), batch 8 each, 3 steps, dropout on, against one "
            f"process at batch 16: losses {got['losses'].tolist()} vs "
            f"{single['losses']} (rel {loss_rel.tolist()}); step 1 "
            f"gradients max abs / norm {grad_err:.3e}; after 3 steps the "
            f"parameters at most {drift:.3e} apart (bound {lr_bound}), "
            f"{beyond} of {total} elements beyond rtol 1e-4 / atol 1e-6; "
            f"ranks bit-equal")
        require(loss_rel[0] <= 1e-5 and grad_err <= 1e-4
                and drift <= lr_bound,
                f"(b) two ranks vs one process: step-1 loss rel "
                f"{loss_rel[0]} (limit 1e-5), step-1 gradients {grad_err} "
                f"of the norm (limit 1e-4), parameters after 3 steps "
                f"{drift} apart (limit {lr_bound})")
        out.update(two_ranks_loss_rel=loss_rel.tolist(),
                   two_ranks_grad_err=grad_err, two_ranks_drift=drift,
                   two_ranks_beyond=(beyond, total),
                   two_ranks_param_rel=param_rel)

        # (c) sharded synthesis on the world-size-1 plan
        synth = main["synth"]
        cleaners = list(synth.config.data.cleaner_names())
        seqs = [text_to_sequence(t, cleaners) for t in KOREAN]
        inputs = np.zeros((len(seqs), max(map(len, seqs))), np.int64)
        for i, q in enumerate(seqs):
            inputs[i, :len(q)] = q
        lengths = np.asarray([len(q) for q in seqs], np.int64)
        speakers = np.asarray([0, 1, 0, 1], np.int64)
        synth_out = {}
        for name, kw in (("default", {}),
                         ("pallas", dict(griffin_lim_impl="pallas",
                                         ola_impl="pallas"))):
            c = synth.config.replace(audio=dataclasses.replace(
                synth.config.audio, **kw))
            fn = make_sharded_synthesis(c, plan, 50)
            zero_counts()
            t0 = time.perf_counter()
            wavs, aligns = fn(synth.model, inputs, lengths, speakers)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
            want_w, want_a = make_sharded_synthesis(c, None, 50)(
                synth.model, inputs, lengths, speakers)
            err = float((wavs - want_w).abs().max() / want_w.abs().max())
            al = float((aligns - want_a).abs().max())
            require(wavs.shape == want_w.shape and bool(
                torch.isfinite(wavs).all()) and err <= 1e-4 and al <= 1e-4,
                f"(c) {name}: waveforms {err} of the peak, alignments {al}")
            synth_out[name] = dict(counts=counts, wall_s=wall, err=err)
        iters = synth.config.audio.griffin_lim_iters
        require(not any(synth_out["default"]["counts"].values()),
                f"(c) default engines launched {synth_out['default']}")
        require(synth_out["pallas"]["counts"] == {
            "K1": 0, "K2": iters + 1, "K3": iters},
            f"(c) pallas engines launched {synth_out['pallas']['counts']}, "
            f"not K3 {iters} and K2 {iters + 1}")
        fused = synth.config.replace(audio=dataclasses.replace(
            synth.config.audio, griffin_lim_impl="fused"))
        try:
            make_sharded_synthesis(fused, plan, 50)
            require(False, "(c) 'fused' was not refused")
        except ValueError:
            pass
        out["synthesis"] = synth_out
        log(f"[parallel] (c) make_sharded_synthesis, 4 sentences x 50 "
            f"steps, {iters} iterations: default engines "
            f"{synth_out['default']['wall_s']:.3f} s, launches "
            f"{synth_out['default']['counts']}, waveforms "
            f"{synth_out['default']['err']:.3e} of the peak from the "
            f"unsharded call; pallas engines "
            f"{synth_out['pallas']['wall_s']:.3f} s, launches "
            f"{synth_out['pallas']['counts']}, "
            f"{synth_out['pallas']['err']:.3e}; 'fused' refused")

        # (d) the plain and data-parallel steps on the same 4 batches
        state = CheckpointManager(runs["plain"], cfg).restore(
            create_train_state(cfg, seed=0, device=dev))
        batches = DataFeeder(dirs, cfg, seed=5).batches()
        host = [next(batches) for _ in range(4)]
        timing, traces, graph_fns = {}, {}, {}
        for name, p in (("plain", None), ("dp", plan)):
            collectives.calls = 0
            timing[f"{name}_eager"] = time_train_steps(
                state, make_train_step(cfg, p), iter(host), 1, 3)
            per_step = collectives.calls / 4    # the warm-up and 3 steps
            graph_fns[name] = make_train_step(cfg, p)
            collectives.calls = 0
            graph_fns[name].prewarm(state, [batch_to_device(host[0], dev)])
            out[f"{name}_collectives"] = (per_step, collectives.calls)
        # the replays alternate, twice each: 6 timed steps of each
        for _ in range(2):
            for name in ("plain", "dp"):
                t = time_train_steps(state, graph_fns[name], iter(host), 1,
                                     3)
                timing.setdefault(f"{name}_replay", []).extend(t["step_s"])
        b = batch_to_device(host[0], dev)
        collectives.calls = 0
        for name in ("plain", "dp"):
            _, traces[name] = traced(lambda: graph_fns[name](state, b, 1))
        require(collectives.calls == 0,
                "(d) a replay called a collective from Python")
        by = traces["dp"]
        nccl_n = by["device_launches_by_group"].get("collectives (NCCL)", 0)
        nccl_ms = by["device_ms_by_group"].get("collectives (NCCL)", 0.0)
        step_s = {k: (v["step_s"] if isinstance(v, dict) else v)
                  for k, v in timing.items()}
        roof = roofline(cfg, host[1:] * 2, {"step_s": step_s["dp_eager"]},
                        {"step_s": step_s["dp_replay"]})
        out.update(timing={k: statistics.median(v)
                           for k, v in step_s.items()},
                   step_s=step_s, nccl_kernels=nccl_n, nccl_ms=nccl_ms,
                   roofline=roof,
                   replay_kernels={k: v["device_kernels"]
                                   for k, v in traces.items()},
                   replay_busy_ms={k: v["device_busy_ms"]
                                   for k, v in traces.items()},
                   replay_traced_s={k: v["wall_s"]
                                    for k, v in traces.items()})
        t = out["timing"]
        (pe, pc), (de, dc) = out["plain_collectives"], out["dp_collectives"]
        busy, tw = out["replay_busy_ms"], out["replay_traced_s"]
        log(f"[parallel] (d) step at batch 16 (corpus-max shape), median "
            f"of 3 eager and 6 replayed (alternating): plain "
            f"{t['plain_eager']:.4f} s eager, "
            f"{t['plain_replay']:.4f} s replayed; data-parallel (NCCL, "
            f"world size 1) {t['dp_eager']:.4f} s eager, "
            f"{t['dp_replay']:.4f} s replayed; a data-parallel step calls "
            f"{de:g} collectives (plain {pe:g}), its capture recorded {dc} "
            f"with the warm-up's; one traced replay: {nccl_n} NCCL kernels, "
            f"{nccl_ms:.4f} ms (of {out['replay_kernels']['dp']} kernels, "
            f"device busy {busy['dp']:.1f} ms of {tw['dp']:.4f} s; plain "
            f"{out['replay_kernels']['plain']} kernels, {busy['plain']:.1f} "
            f"ms of {tw['plain']:.4f} s); roofline "
            f"{roof['total_flops'][0] / 1e9:.1f} GFLOP a step, MFU "
            f"{roof['mfu_pct'][0]:.3f} % eager, {roof['mfu_pct'][1]:.3f} % "
            f"replayed of {roof['peak_tflops']:.0f} TFLOP/s fp32")
    finally:
        for p in workers:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutdown()
    out["wall_s"] = time.perf_counter() - t_phase
    return out


# ------------------------------------------------------------------ corpus

#: phase 10's script, per speaker: five sentences of at least 50 tokens
#: (the feeder's ``min_tokens``), each read by one utterance of that
#: speaker's long recording; the script also holds a twin of the fifth,
#: one syllable apart (``twin``)
CORPUS_SCRIPT = {
    0: ["바람이 부는 언덕 위에서 아이들이 연을 날리며 즐겁게 뛰어놀았다.",
        "도서관 창가에 앉아 오래된 소설책을 천천히 읽어 내려갔다.",
        "시장 골목에는 따뜻한 호떡과 어묵을 파는 가게가 줄지어 있었다.",
        "기차는 새벽 안개를 가르며 남쪽 바닷가 마을로 달려갔다.",
        "우리는 주말마다 공원 호숫가를 따라 자전거를 타곤 했다."],
    1: ["첫눈이 내리던 날 할머니께서 손수 뜨개질한 목도리를 주셨다.",
        "연구실의 불빛은 자정이 넘도록 꺼지지 않고 환하게 빛났다.",
        "작은 카페 구석에서 피아노 연주가 잔잔하게 흘러나오고 있었다.",
        "산 정상에 오르자 구름 사이로 붉은 해가 천천히 떠올랐다.",
        "그녀는 편지 마지막 줄에 다시 만나자는 약속을 적어 두었다."],
}
#: utterance k of a recording lasts 3.4 + 0.3 k seconds: distinct enough
#: for the fake recognizer to tell the clips apart by length
UTTERANCE_S = [3.4 + 0.3 * k for k in range(5)]
#: the position of the syllable in which the fifth sentence and its twin
#: differ
TWIN_AT = 12

#: the JAX report's keys (``tacotron_tpu/tools/speaker_eval.py``)
REPORT_KEYS = {
    "utterance": {"text", "num_tokens", "attention", "audio"},
    "attention": {"ok", "gate", "ok_sharpness", "ok_soft_monotonic",
                  "coverage", "focus", "monotonicity", "path_coverage"},
    "audio": {"duration_s", "rms", "peak", "silence_fraction",
              "spectral_centroid_hz"},
    "aggregate": {"num_utterances", "attention_ok_rate", "attention_gate",
                  "attention_ok_rate_sharpness",
                  "attention_ok_rate_soft_monotonic", "mean_coverage",
                  "mean_focus", "mean_monotonicity", "mean_path_coverage",
                  "mean_duration_s", "mean_rms", "mean_silence_fraction",
                  "mean_spectral_centroid_hz", "mean_seconds_per_token"},
    "cross_speaker": {"num_speakers", "attention_gate",
                      "worst_attention_ok_rate",
                      "worst_attention_ok_rate_sharpness",
                      "worst_attention_ok_rate_soft_monotonic",
                      "worst_path_coverage", "rms_spread_ratio",
                      "seconds_per_token_spread_ratio"},
}
#: launches of K1 (``gl_iteration``: its four kernels) per Griffin-Lim
#: iteration
K1_PER_ITERATION = 4


def twin(sentence: str) -> str:
    """The fifth sentence's twin in the script: one syllable apart."""
    return (sentence[:TWIN_AT] + chr(ord(sentence[TWIN_AT]) + 1)
            + sentence[TWIN_AT + 1:])


def write_recording(path: str, spk: int, audio_cfg, rng) -> None:
    """One speaker's long-form recording: the utterances of
    ``UTTERANCE_S`` as tone bands (three sines in the speaker's band under
    an envelope that never falls below 0.2) between silences of 0.5-1 s."""
    from tacotron_tpu_torch.dsp import host as dsp_host

    sr = audio_cfg.sample_rate
    lo, hi = ((150.0, 400.0), (400.0, 900.0))[spk]
    parts = [np.zeros(int(sr * rng.uniform(0.5, 1.0)), np.float32)]
    for seconds in UTTERANCE_S:
        t = np.arange(int(sr * seconds)) / sr
        env = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(1.0, 3.0) * t)
        utt = env * sum(rng.uniform(0.1, 0.25)
                        * np.sin(2 * np.pi * rng.uniform(lo, hi) * t)
                        for _ in range(3))
        parts += [utt.astype(np.float32),
                  np.zeros(int(sr * rng.uniform(0.5, 1.0)), np.float32)]
    dsp_host.save_audio(np.concatenate(parts), path, audio_cfg)


def fake_recognizer(sentences, rng, calls: list):
    """A seeded ``recognize_fn``: the clip is told by its length (the
    nearest of ``UTTERANCE_S``); it returns that clip's sentence with one
    syllable changed at a seeded position, and for the fifth clip the
    syllable in which the sentence and its twin differ, to a third one
    (a tie between the two: the low-confidence form)."""
    def recognize(audio_16k, language):
        k = int(np.argmin([abs(len(audio_16k) / 16000 - s)
                           for s in UTTERANCE_S]))
        text = sentences[k]
        if k == len(sentences) - 1:
            at, new = TWIN_AT, chr(ord(text[TWIN_AT]) + 2)
        else:
            syllables = [i for i, c in enumerate(text)
                         if "가" <= c <= "힣"]
            at = syllables[int(rng.integers(len(syllables)))]
            new = text[at]
            while new == text[at]:
                new = chr(0xAC00 + int(rng.integers(11172)))
        calls.append((k, language))
        return text[:at] + new + text[at + 1:]
    return recognize


def npz_arrays(data_dir: str) -> dict:
    """{file name: {key: array}} of a directory of ``.npz`` files."""
    import os

    out = {}
    for name in sorted(os.listdir(data_dir)):
        with np.load(os.path.join(data_dir, name)) as d:
            out[name] = {k: d[k] for k in d.files}
    return out


def check_report(report: dict, speakers, n_texts: int, what: str) -> None:
    """Every key of the JAX report, per speaker and utterance, and JSON."""
    require(set(report) == {"speakers", "cross_speaker"},
            f"{what}: report keys {sorted(report)}")
    require(set(report["speakers"]) == {str(s) for s in speakers},
            f"{what}: speakers {sorted(report['speakers'])}")
    require(set(report["cross_speaker"]) == REPORT_KEYS["cross_speaker"],
            f"{what}: cross-speaker keys {sorted(report['cross_speaker'])}")
    for rec in report["speakers"].values():
        require(set(rec["aggregate"]) == REPORT_KEYS["aggregate"],
                f"{what}: aggregate keys {sorted(rec['aggregate'])}")
        require(len(rec["utterances"]) == n_texts,
                f"{what}: {len(rec['utterances'])} utterances")
        for u in rec["utterances"]:
            require(set(u) == REPORT_KEYS["utterance"]
                    and set(u["attention"]) == REPORT_KEYS["attention"]
                    and set(u["audio"]) == REPORT_KEYS["audio"],
                    f"{what}: utterance keys {sorted(u)}")
            require(all(np.isfinite(v) for v in u["audio"].values())
                    and u["audio"]["duration_s"] > 0,
                    f"{what}: acoustic stats {u['audio']}")
    json.dumps(report)


def corpus_phase(dev, tmp: str) -> dict:
    """Phase 10 (a)-(f) of the module docstring, in ``tmp``.  Returns its
    numbers."""
    import dataclasses
    import importlib.util
    import os

    from tacotron_tpu_torch.data.builder import (build_from_path,
                                                 read_metadata,
                                                 resolve_loss_coeffs)
    from tacotron_tpu_torch.ops.kernels.gl_fused import fused_supported
    from tacotron_tpu_torch.synth import Synthesizer
    from tacotron_tpu_torch.text import text_to_sequence
    from tacotron_tpu_torch.text.eval_sentences import EVAL_TEXTS
    from tacotron_tpu_torch.tools.alignment import align_batch, similarity
    from tacotron_tpu_torch.tools.asr import transcribe_batch
    from tacotron_tpu_torch.tools.duration import (audio_duration,
                                                   dataset_totals)
    from tacotron_tpu_torch.tools.silence import split_on_silence
    from tacotron_tpu_torch.tools.speaker_eval import evaluate_speakers
    from tacotron_tpu_torch.data import DataFeeder
    from tacotron_tpu_torch.synth.synthesizer import trim_silence_db
    from tacotron_tpu_torch.train.driver import train
    from tacotron_tpu_torch.train.profile import time_train_steps
    from tacotron_tpu_torch.train.step import make_train_step
    from tacotron_tpu_torch.utils import read_metrics

    t_phase = time.perf_counter()
    rng = np.random.default_rng(10)
    out = {}
    cfg = train_config(decay_learning_rate_mode=1, test_interval=5,
                       checkpoint_interval=5)
    audio = cfg.audio
    root = os.path.join(tmp, "corpus10")

    # (a) one long recording per speaker, split on silence
    clips, scripts = {}, {}
    for spk, sentences in CORPUS_SCRIPT.items():
        d = os.path.join(root, f"spk{spk}")
        os.makedirs(d)
        scripts[spk] = os.path.join(d, "script.txt")
        with open(scripts[spk], "w", encoding="utf-8") as fh:
            fh.write("\n".join(sentences + [twin(sentences[-1])]) + "\n")
        write_recording(os.path.join(d, "long.wav"), spk, audio, rng)
        clips[spk] = split_on_silence(os.path.join(d, "long.wav"), audio)
        require(len(clips[spk]) == len(sentences),
                f"(a) speaker {spk}: {len(clips[spk])} clips for "
                f"{len(sentences)} utterances")
    out["clips"] = sum(len(v) for v in clips.values())
    log(f"[corpus] (a) split_on_silence: {out['clips']} clips from 2 "
        f"recordings of {len(UTTERANCE_S)} utterances")

    # (b) ASR with a seeded fake recognizer, then alignment to the script
    aligned = {}
    for spk, sentences in CORPUS_SCRIPT.items():
        d = os.path.dirname(scripts[spk])
        calls = []
        rec = transcribe_batch(os.path.join(d, "long.*.wav"),
                               recognize_fn=fake_recognizer(sentences, rng,
                                                            calls))
        require(sorted(k for k, _ in calls) == list(range(len(sentences)))
                and len(rec) == len(clips[spk]),
                f"(b) speaker {spk}: recognized clips {calls}")
        result = align_batch(os.path.join(d, "recognition.json"),
                             scripts[spk])
        with open(os.path.join(d, "alignment.json"), encoding="utf-8") as fh:
            require(json.load(fh) == result,
                    f"(b) speaker {spk}: alignment.json differs")
        lines = sentences + [twin(sentences[-1])]
        for path in clips[spk]:
            k = int(np.argmin([abs(audio_duration(path) - s)
                               for s in UTTERANCE_S]))
            got = result[path]
            if k < len(sentences) - 1:
                require(got == sentences[k],
                        f"(b) {path}: aligned to {got!r}, not "
                        f"{sentences[k]!r}")
            else:
                # the tie: kept uncertain, as the ASR text alone
                require(got == [rec[path]],
                        f"(b) {path}: the tie aligned to {got!r}")
                best = max(similarity(c, rec[path]) for c in lines)
                require(similarity(sentences[k], rec[path]) == best,
                        f"(b) {path}: its own sentence is not a best match")
        aligned[spk] = result
    log(f"[corpus] (b) transcribe_batch + align_batch: "
        f"{sum(isinstance(v, str) for r in aligned.values() for v in r.values())}"
        f" confident, "
        f"{sum(isinstance(v, list) for r in aligned.values() for v in r.values())}"
        f" uncertain (the twin ties)")

    # (c) build the corpus in a spawned pool of 2 (CUDA is up in this
    # process), then in-process; byte-equal arrays
    require(torch.cuda.is_initialized(), "(c) CUDA is not initialised")
    dirs, built, skipped, walls = [], 0, 0, {1: 0.0, 2: 0.0}
    frames = []
    for spk in CORPUS_SCRIPT:
        meta = os.path.join(os.path.dirname(scripts[spk]), "alignment.json")
        kept, _ = resolve_loss_coeffs(read_metadata(meta), cfg.train)
        t0 = time.perf_counter()
        # a hung pool ends the script with every thread's traceback
        faulthandler.dump_traceback_later(180, exit=True)
        stats2 = build_from_path(meta, cfg, "data", num_workers=2)
        faulthandler.cancel_dump_traceback_later()
        walls[2] += time.perf_counter() - t0
        t0 = time.perf_counter()
        stats1 = build_from_path(meta, cfg, "data1", num_workers=1)
        walls[1] += time.perf_counter() - t0
        require(dataclasses.asdict(stats2) == dataclasses.asdict(stats1),
                f"(c) speaker {spk}: {stats2} vs {stats1}")
        require(stats2.num_built == len(kept),
                f"(c) speaker {spk}: built {stats2.num_built}, the policy "
                f"keeps {len(kept)}")
        a2 = npz_arrays(os.path.join(os.path.dirname(meta), "data"))
        a1 = npz_arrays(os.path.join(os.path.dirname(meta), "data1"))
        require(sorted(a2) == sorted(a1) and len(a2) == len(kept),
                f"(c) speaker {spk}: files {sorted(a2)} vs {sorted(a1)}")
        for name, arrays in a1.items():
            for key, want in arrays.items():
                got = a2[name][key]
                require(got.dtype == want.dtype and got.shape == want.shape
                        and got.tobytes() == want.tobytes(),
                        f"(c) {name}/{key} differs between 2 workers and 1")
        kept_s = sum(audio_duration(p) for p in kept)
        built_s = sum(stats2.n_frames) * audio.hop_length / audio.sample_rate
        require(abs(built_s - kept_s) <= len(kept) * audio.hop_length
                / audio.sample_rate,
                f"(c) speaker {spk}: {built_s} s built for {kept_s} s kept")
        built += stats2.num_built
        skipped += len(clips[spk]) - stats2.num_built
        frames += stats2.n_frames
        dirs.append(os.path.join(os.path.dirname(meta), "data"))
    totals = dataset_totals([os.path.join(root, f"spk{s}", "long.*.wav")
                             for s in CORPUS_SCRIPT])
    clip_s = sum(s for _, s in totals.values())
    require(sum(n for n, _ in totals.values()) == out["clips"]
            and abs(clip_s - 2 * sum(UTTERANCE_S)) <= out["clips"] * 0.1,
            f"(c) dataset_totals {totals}")
    out.update(built=built, skipped=skipped, build_s=walls,
               corpus_s=sum(frames) * audio.hop_length / audio.sample_rate,
               clip_s=clip_s)
    log(f"[corpus] (c) build_from_path: {built} built, {skipped} skipped by "
        f"ignore_recognition_level {cfg.train.ignore_recognition_level}, "
        f"2 workers {walls[2]:.2f} s, 1 worker {walls[1]:.2f} s, byte-equal;"
        f" {out['corpus_s']:.2f} s of audio built, clips "
        f"{clip_s:.2f} s (dataset_totals)")

    # (d) train on it: the batch the corpus allows (half of the smaller
    # speaker's utterances; the feeder holds a batch out per speaker)
    batch = min(len(os.listdir(d)) for d in dirs) // 2
    cfg_d = cfg.replace(train=dataclasses.replace(cfg.train,
                                                  batch_size=batch))
    run = os.path.join(tmp, "run_corpus")
    samples = os.path.join(run, "samples")
    state = train(run, dirs, cfg_d, num_steps=5, device=dev,
                  test_dump_dir=samples)
    recs = read_metrics(os.path.join(run, "metrics.jsonl"), "train")
    require(state.step == 5 and [r["step"] for r in recs] == [1, 2, 3, 4, 5]
            and all(np.isfinite(r["loss"]) for r in recs),
            f"(d) train records {recs}")
    names = sorted(os.listdir(samples))
    require({"step000000005.wav", "step000000005_alignment.npy"}
            <= set(names), f"(d) sample dumps {names}")
    with open(os.path.join(run, "train.log"), encoding="utf-8") as fh:
        skipped_png = "alignment PNG" in fh.read()
    if importlib.util.find_spec("matplotlib") is None:
        require(skipped_png and "step000000005.png" not in names,
                "(d) no matplotlib, but no skipped PNG in train.log")
    else:
        require("step000000005.png" in names, f"(d) no PNG in {names}")
    # the driver's sec_per_step is a running mean over its flushes; the
    # step time is timed alone: one warm-up and 4 steps on from step 5
    timing = time_train_steps(state, make_train_step(cfg_d),
                              DataFeeder(dirs, cfg_d, seed=5).batches(), 1, 4)
    out["step_s"] = timing["sec_per_step"]
    log(f"[corpus] (d) train on the built corpus: 5 steps at batch {batch}"
        f", losses {[round(r['loss'], 4) for r in recs]}; then 4 timed "
        f"steps {[round(t, 4) for t in timing['step_s']]}, median "
        f"{out['step_s']:.4f} s/step; sample dump {names} (PNG "
        f"{'skipped and logged' if skipped_png else 'written'})")

    # (e) the speaker eval on the card: 50 steps (K1), then the default
    # budget on two long texts (K2 where fused_supported rejects it)
    synth = Synthesizer(device=dev).load(run)
    r = synth.config.model.reduction_factor
    iters = synth.FAST_GRIFFIN_LIM_ITERS
    results = []
    inner = synth.synthesize

    def capture(**kw):
        # the waveforms are held at the exact lengths of their frame ends,
        # then given the dB trim that synthesize applies by default
        trim = kw.pop("librosa_trim", True)
        res = inner(**kw, librosa_trim=False)
        results.append(res)
        return dict(res, wavs=[trim_silence_db(w) if trim else w
                               for w in res["wavs"]])

    synth.synthesize = capture
    long_texts = sorted(EVAL_TEXTS, key=len)[-2:]
    runs = {"steps50": dict(max_steps=50, texts=EVAL_TEXTS),
            "default": dict(max_steps=None, texts=long_texts)}
    out["eval"] = {}
    for name, kw in runs.items():
        zero_counts()
        t0 = time.perf_counter()
        report = evaluate_speakers(synth, speakers=[0, 1], **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        res = results[-1]
        n = 2 * len(kw["texts"])
        seqs = [text_to_sequence(t, synth.cleaner_names(),
                                 symbol_set=synth.config.data.symbol_set)
                for t in kw["texts"]]
        steps = synth._budget([len(s) for s in seqs], kw["max_steps"],
                              32)[1]
        fused = fused_supported(synth.config.audio, steps * r)
        chunks = len(synth._chunks(n))
        want = {"K1": K1_PER_ITERATION * iters * chunks if fused else 0,
                "K2": 0 if fused else (iters + 1) * chunks, "K3": 0}
        require(counts == want, f"(e) {name}: launches {counts}, derived "
                                f"{want} ({steps} steps, fused {fused})")
        check_waveforms(res, synth.config.audio.hop_length, f"(e) {name}")
        check_report(report, [0, 1], len(kw["texts"]), f"(e) {name}")
        # the kernel that ran, against its plain version at each shape the
        # path gave it: a chunk's padded batch x steps * r frames
        errs = {nb: (check_k1_at if fused else check_k2_at)(
                    dev, rng, synth.config.audio, nb, steps * r)
                for nb in sorted({nb for _, _, nb in synth._chunks(n)})}
        out["eval"][name] = dict(wall_s=wall, launches=counts, steps=steps,
                                 fused=fused, kernel_err=errs)
        cross = report["cross_speaker"]
        log(f"[corpus] (e) evaluate_speakers {name}: {n} utterances x "
            f"{steps} steps ({steps * r} frames, fused {fused}) in "
            f"{wall:.3f} s, launches {counts}; "
            f"{'K1 rel' if fused else 'K2 abs'} error against its plain "
            f"version at {steps * r} frames "
            f"{', '.join(f'B={b} {e:.3e}' for b, e in errs.items())}; worst "
            f"attention_ok {cross['worst_attention_ok_rate']:.2f}, rms "
            f"spread {cross['rms_spread_ratio']:.3f}")
    del synth.synthesize

    # (f) the CLI as a user runs it: on the card, no --device
    report_path = os.path.join(tmp, "speaker_report.json")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tacotron_tpu_torch.tools.speaker_eval",
         "--load_path", run, "--max_steps", "50", "--out", report_path],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=300)
    out["cli_s"] = time.perf_counter() - t0
    require(proc.returncode == 0,
            f"(f) speaker_eval CLI exited {proc.returncode}: "
            f"{proc.stderr[-2000:]}")
    with open(report_path, encoding="utf-8") as fh:
        cli_report = json.load(fh)
    check_report(cli_report, [0, 1], len(EVAL_TEXTS), "(f)")
    log(f"[corpus] (f) python -m tacotron_tpu_torch.tools.speaker_eval: "
        f"exit 0 in {out['cli_s']:.1f} s, speakers "
        f"{sorted(cli_report['speakers'])}")
    out["wall_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------- bf16

def bf16_config(cfg):
    """``cfg`` computing in bfloat16."""
    import dataclasses
    return cfg.replace(model=dataclasses.replace(cfg.model,
                                                 compute_dtype="bfloat16"))


#: the CPU tests' bounds of the bf16 model (tests/test_torch_bf16_model.py):
#: mel and linear within 3 % of the float32 peak, alignments within 1e-2
BF16_SHARE, BF16_ALIGN = 0.03, 1e-2
#: and of the bf16 train step (tests/test_torch_bf16.py)
BF16_LOSS_REL, BF16_GRAD_NORM_REL = 1e-2, 2e-2
#: phase 11 (c)'s eager bf16 run (30 until phase 12 came, 20 until phase
#: 13; cut for time)
BF16_STEPS = 10


def bf16_forward(dev, main: dict, dirs) -> dict:
    """(a) A teacher-forced full-width forward in eval mode on 4 utterances
    of phase 6's corpus (120-160 frames), with phase 4's weights: bf16 on
    the card against float32 on the card and against bf16 on the CPU.
    Each deviation is a share of the float32 output's peak."""
    import dataclasses

    from tacotron_tpu_torch.data import DataFeeder
    from tacotron_tpu_torch.synth import Synthesizer

    cfg = main["synth"].config
    cfg_bf = bf16_config(cfg)
    feed = train_config()
    feed = feed.replace(data=dataclasses.replace(feed.data, min_iters=30,
                                                 max_iters=41))
    host = next(DataFeeder(dirs, feed, batch_size=4, n_test=0,
                           seed=3).batches())
    models = {"f32": main["synth"].model,
              "bf16": Synthesizer(device=dev).init_random(cfg_bf, 0).model,
              "cpu": Synthesizer(device="cpu").init_random(cfg_bf, 0).model}
    outs = {}
    for name, model in models.items():
        d = next(model.parameters()).device
        with torch.inference_mode():
            out = model(torch.from_numpy(host.inputs).long().to(d),
                        torch.from_numpy(host.input_lengths).to(d),
                        speaker_id=torch.from_numpy(host.speaker_id).long()
                        .to(d),
                        mel_targets=torch.from_numpy(host.mel_targets).to(d))
        require(all(v.dtype == torch.float32 for v in out.values()),
                f"(a) {name}: outputs {[v.dtype for v in out.values()]}")
        outs[name] = {k: v.cpu().numpy() for k, v in out.items()}
    require(models["bf16"].compute_dtype == torch.bfloat16
            and all(p.dtype == torch.float32
                    for p in models["bf16"].parameters()),
            "(a) the bf16 model's parameters are not float32")
    dev_ = {}
    for pair in (("bf16", "cpu"), ("bf16", "f32")):
        for key in ("mel_outputs", "linear_outputs", "alignments"):
            a, b = outs[pair[0]][key], outs[pair[1]][key]
            require(np.isfinite(a).all(), f"(a) {pair[0]} {key} not finite")
            err = float(np.abs(a - b).max())
            if key == "alignments":
                share, ok = err, err <= BF16_ALIGN
            else:
                share = err / float(np.abs(outs["f32"][key]).max())
                ok = share <= BF16_SHARE
            dev_[f"{pair[0]}_vs_{pair[1]}/{key}"] = share
            require(ok, f"(a) {pair[0]} against {pair[1]}, {key}: {share}")
    log(f"[bf16] (a) teacher-forced forward, 4 x "
        f"{host.mel_targets.shape[1]} frames, phase 4's weights: card bf16 "
        f"against CPU bf16: mel {dev_['bf16_vs_cpu/mel_outputs']:.3e}, "
        f"linear {dev_['bf16_vs_cpu/linear_outputs']:.3e} of the peak, "
        f"alignments {dev_['bf16_vs_cpu/alignments']:.3e}; card bf16 "
        f"against card f32: mel {dev_['bf16_vs_f32/mel_outputs']:.3e}, "
        f"linear {dev_['bf16_vs_f32/linear_outputs']:.3e} of the peak, "
        f"alignments {dev_['bf16_vs_f32/alignments']:.3e} (bounds "
        f"{BF16_SHARE} of the peak, {BF16_ALIGN})")
    return dev_


def bf16_serving(dev, main: dict, graphs: dict) -> dict:
    """(b) Phase 4's rungs (a) and (b) in bf16 with phase 4's weights:
    eagerly (the wrappers' counters: K1 120 on (a), K2 61 on (b)), then
    each key prewarmed and replayed (bit-equal to eager, the same launches
    in the replay's trace), with walls and the traced device busy time and
    idle share beside phase 4's and 8's float32 figures."""
    from tacotron_tpu_torch.synth import Synthesizer

    cfg_bf = bf16_config(main["synth"].config)
    synth = Synthesizer(device=dev).init_random(cfg_bf, seed=0)
    hop = cfg_bf.audio.hop_length
    expect = {"a": {"K1": 120, "K2": 0, "K3": 0},
              "b": {"K1": 0, "K2": 61, "K3": 0}}
    out = {}
    for name in ("a", "b"):
        kw = dict(main["calls"][name][1], librosa_trim=False)
        call = (lambda kw=kw: synth.synthesize(**kw))
        zero_counts()
        want = call()
        torch.cuda.synchronize()
        counts = read_counts()
        require(counts == expect[name], f"(b) call ({name}) launched "
                f"{counts}, not {expect[name]}")
        audio = check_waveforms(want, hop, f"(b) bf16 call ({name})")
        _, wall_e = median_wall(call)
        _, trace_e = traced(call)
        require(trace_counts(trace_e) == counts,
                f"(b) call ({name}): the eager trace counts "
                f"{trace_counts(trace_e)}, the wrappers {counts}")
        t0 = time.perf_counter()
        synth.prewarm(**synth.prewarm_args(
            kw["texts"], max_steps=kw["max_steps"],
            fast_vocoder=kw.get("fast_vocoder", False)))
        capture_s = time.perf_counter() - t0
        replay_once(synth, call, f"(b) bf16 call ({name})", want)
        _, wall_g = median_wall(call)
        _, trace_g = traced(call)
        require(trace_counts(trace_g) == counts,
                f"(b) call ({name}): launches in the replay's trace "
                f"{trace_counts(trace_g)} != eager {counts}")
        f32 = graphs[name]
        out[name] = dict(
            launches=counts, audio_s=audio / cfg_bf.audio.sample_rate,
            eager_s=wall_e, replay_s=wall_g, capture_s=capture_s,
            eager_busy_ms=trace_e["device_busy_ms"],
            replay_busy_ms=trace_g["device_busy_ms"],
            eager_idle=trace_e["device_idle_share"],
            replay_idle=trace_g["device_idle_share"])
        o = out[name]
        log(f"[bf16] (b) call ({name}): launches {counts}; eager "
            f"{wall_e:.4f} s (f32 phase 4 {main[f'wall_{name}']:.4f}, phase "
            f"8 {f32['eager_s']:.4f}), busy {o['eager_busy_ms']:.2f} ms, "
            f"idle {o['eager_idle']:.4f} (f32 {f32['eager_idle']:.4f}); "
            f"replay {wall_g:.4f} s (f32 {f32['replay_s']:.4f}), busy "
            f"{o['replay_busy_ms']:.2f} ms, idle {o['replay_idle']:.4f} "
            f"(f32 {f32['replay_idle']:.4f}); capture {capture_s:.2f} s; "
            f"{o['audio_s']:.2f} s audio; replay bit-equal to eager")
    return out


def bf16_step_card_vs_cpu(dev, dirs) -> dict:
    """(c) One bf16 train step at batch 4 (120-160 frames,
    ``dropout_prob=0``) from the same weights and batch on the card and on
    the CPU: loss rel 1e-2, gradient norm rel 2e-2 (the CPU test's bounds
    against JAX); parameters and Adam moments float32."""
    import dataclasses

    from tacotron_tpu_torch.data import DataFeeder
    from tacotron_tpu_torch.train.state import create_train_state
    from tacotron_tpu_torch.train.step import batch_to_device, make_train_step

    cfg = bf16_config(train_config())
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dropout_prob=0.0),
                      data=dataclasses.replace(cfg.data, min_iters=30,
                                               max_iters=41))
    host = next(DataFeeder(dirs, cfg, batch_size=4, n_test=0,
                           seed=3).batches())
    got = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        state = create_train_state(cfg, seed=0, device=d)
        state, metrics = make_train_step(cfg)(state, batch_to_device(host, d),
                                              0)
        require(all(t.dtype == torch.float32 for t in
                    state.parameters() + state.opt.m + state.opt.v),
                f"(c) {name}: parameters or moments left float32")
        got[name] = {k: float(v) for k, v in metrics.items()}
    rel = {k: abs(got["cuda"][k] - got["cpu"][k]) / abs(got["cpu"][k])
           for k in ("loss", "grad_norm")}
    require(rel["loss"] <= BF16_LOSS_REL
            and rel["grad_norm"] <= BF16_GRAD_NORM_REL,
            f"(c) bf16 step card vs CPU: {got}")
    log(f"[bf16] (c) one bf16 step at batch 4 card vs CPU: loss "
        f"{got['cuda']['loss']:.6f} vs {got['cpu']['loss']:.6f} (rel "
        f"{rel['loss']:.3e}), gradient norm {got['cuda']['grad_norm']:.5f} "
        f"vs {got['cpu']['grad_norm']:.5f} (rel {rel['grad_norm']:.3e})")
    return dict(rel, cuda=got["cuda"], cpu=got["cpu"])


def bf16_training(dev, trained: dict, graphs: dict, tmp: str) -> dict:
    """(c) ``BF16_STEPS`` bf16 steps at batch 16 on phase 6's corpus, config
    and seed (the loss falls), then eager and replayed steps on the same 4 batches
    beside phase 6's and 8's float32 figures, and at NCCL world size 1 the
    data-parallel bf16 step equal to the plain bf16 step over 2 steps."""
    import os

    from tacotron_tpu_torch.data import DataFeeder
    from tacotron_tpu_torch.parallel import distributed_initialize, make_mesh
    from tacotron_tpu_torch.parallel.distributed import shutdown
    from tacotron_tpu_torch.train.driver import train
    from tacotron_tpu_torch.train.profile import time_train_steps
    from tacotron_tpu_torch.train.step import batch_to_device, make_train_step
    from tacotron_tpu_torch.utils import read_metrics

    dirs = trained["corpus"]
    out = {"card_vs_cpu": bf16_step_card_vs_cpu(dev, dirs)}
    cfg = bf16_config(trained["config"])
    run = os.path.join(tmp, "run_bf16")
    t0 = time.perf_counter()
    state = train(run, dirs, cfg, num_steps=BF16_STEPS, device=dev)
    out["run_s"] = time.perf_counter() - t0
    losses = [r["loss"] for r in read_metrics(
        os.path.join(run, "metrics.jsonl"), "train")]
    require(len(losses) == BF16_STEPS and np.isfinite(losses).all(),
            f"(c) bf16 run losses {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    require(last < first, f"(c) bf16 loss did not fall: {first} -> {last}")
    f32_losses = [r["loss"] for r in read_metrics(
        os.path.join(trained["run_dir"], "metrics.jsonl"), "train")]
    out.update(loss_first5=first, loss_last5=last,
               f32_first5=float(np.mean(f32_losses[:5])),
               f32_last5=float(np.mean(
                   f32_losses[BF16_STEPS - 5:BF16_STEPS])))

    batches = DataFeeder(dirs, cfg, seed=5).batches()
    host = [next(batches) for _ in range(5)]
    eager = time_train_steps(state, make_train_step(cfg), iter(host), 1, 4)
    step_fn = make_train_step(cfg)
    t0 = time.perf_counter()
    n = step_fn.prewarm(state, [batch_to_device(h, dev) for h in host])
    capture_s = time.perf_counter() - t0
    replay = time_train_steps(state, step_fn, iter(host), 1, 4)
    out.update(eager=eager, replay=replay, graphs=n, capture_s=capture_s)
    f6, f8 = trained["timing"], graphs["train"]
    log(f"[bf16] (c) {BF16_STEPS} bf16 steps at batch 16 in "
        f"{out['run_s']:.1f} s: loss {first:.4f} (steps 1-5) -> {last:.4f} "
        f"(the last 5) (f32 phase 6, the same steps "
        f"{out['f32_first5']:.4f} -> {out['f32_last5']:.4f}); the same 4 "
        f"batches: eager {eager['sec_per_step']:.4f} s a step, "
        f"{eager['target_frames_per_s']:.1f} frames/s, peak "
        f"{eager['peak_memory_gib']:.2f} GiB allocated "
        f"({eager['peak_reserved_gib']:.2f} reserved); replayed "
        f"{replay['sec_per_step']:.4f} s, "
        f"{replay['target_frames_per_s']:.1f} frames/s, peak "
        f"{replay['peak_memory_gib']:.2f} GiB allocated "
        f"({replay['peak_reserved_gib']:.2f} reserved), {n} graphs in "
        f"{capture_s:.1f} s; f32: phase 6 {f6['sec_per_step']:.4f} s, "
        f"phase 8 eager {f8['eager']['sec_per_step']:.4f} s "
        f"({f8['eager']['target_frames_per_s']:.1f} frames/s, "
        f"{f8['eager']['peak_memory_gib']:.2f} / "
        f"{f8['eager']['peak_reserved_gib']:.2f} GiB), replayed "
        f"{f8['replay']['sec_per_step']:.4f} s "
        f"({f8['replay']['target_frames_per_s']:.1f} frames/s, "
        f"{f8['replay']['peak_memory_gib']:.2f} / "
        f"{f8['replay']['peak_reserved_gib']:.2f} GiB)")

    # the data-parallel bf16 step at NCCL world size 1 against the plain one
    cfg_p = bf16_config(parallel_config())
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      MASTER_ADDR="localhost", MASTER_PORT=str(free_port()))
    distributed_initialize(device=dev)
    try:
        plan = make_mesh(cfg_p.mesh)
        require(plan.shard is not None and plan.backend == "nccl",
                f"(c) plan {plan}")
        plain = rows_steps(cfg_p, dirs, dev, None, slice(0, 16), n=2)
        dp = rows_steps(cfg_p, dirs, dev, plan, slice(0, 16), n=2)
    finally:
        shutdown()
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(dp["losses"], plain["losses"]))
    peak = max(float(np.abs(v).max()) for v in plain["params"].values())
    param_err = max(float(np.abs(dp["params"][k] - v).max())
                    for k, v in plain["params"].items()) / peak
    require(loss_err <= 1e-6 and param_err <= 1e-6,
            f"(c) data-parallel bf16 vs plain: loss {loss_err}, parameters "
            f"{param_err} (limit 1e-6)")
    out.update(dp_loss_err=loss_err, dp_param_err=param_err)
    log(f"[bf16] (c) NCCL world size 1, 2 bf16 steps at batch 16: "
        f"data-parallel against plain: loss {loss_err:.3e}, parameters "
        f"{param_err:.3e} (relative; limit 1e-6)")
    return out


def bf16_preset_cli(config, tmp: str) -> dict:
    """(d) ``python -m tacotron_tpu_torch.train --preset tpu --num_steps 3``
    as a user runs it, on a corpus written here by phase 6's writer (it
    stores the waveforms) with 64 utterances a speaker: the feeder holds
    out a batch a speaker for its test set, 32 at the preset's batch, which
    would leave phase 6's 32 none to train on.  Returns its ``python -m``
    arguments (``args``; it runs beside phase 14) and ``log_dir``."""
    import os

    from tacotron_tpu_torch.data import synthetic

    per_speaker = synthetic.PER_SPEAKER
    synthetic.PER_SPEAKER = 64
    try:
        dirs = synthetic.write_synthetic_corpus(
            os.path.join(tmp, "corpus_preset"), config, seed=1)
    finally:
        synthetic.PER_SPEAKER = per_speaker
    log_dir = os.path.join(tmp, "preset_logs")
    return {"args": ["tacotron_tpu_torch.train", "--preset", "tpu",
                     "--num_steps", "3", "--data_paths", ",".join(dirs),
                     "--log_dir", log_dir], "log_dir": log_dir}


def check_preset_cli(cli: dict, done: tuple) -> None:
    """Phase 11 (d), run beside phase 14: the run's ``config.json`` reads
    bf16 and batch 32, and its three losses are finite."""
    import os

    from tacotron_tpu_torch.utils import read_metrics

    wall, log_dir = done[0], cli["log_dir"]
    [run] = os.listdir(log_dir)
    with open(os.path.join(log_dir, run, "config.json")) as fh:
        saved = json.load(fh)
    require(saved["model"]["compute_dtype"] == "bfloat16"
            and saved["train"]["batch_size"] == 32
            and saved["train"]["on_device_features"] is True,
            f"(d) the run's config: model {saved['model']}, train "
            f"{saved['train']}")
    losses = [r["loss"] for r in read_metrics(
        os.path.join(log_dir, run, "metrics.jsonl"), "train")]
    require(len(losses) == 3 and np.isfinite(losses).all(),
            f"(d) losses {losses}")
    log(f"[bf16] (d) python -m tacotron_tpu_torch.train --preset tpu "
        f"--num_steps 3, beside phase 14: exit 0 within {wall:.1f} s, "
        f"config.json bf16 at batch 32 with on-device features, losses "
        f"{[round(x, 4) for x in losses]}")
    cli.update(wall_s=wall, losses=losses)


def bf16_phase(dev, main: dict, trained: dict, graphs: dict,
               tmp: str) -> dict:
    """Phase 11 (a)-(c) of the module docstring, and (d)'s corpus."""
    t_phase = time.perf_counter()
    out = {"forward": bf16_forward(dev, main, trained["corpus"]),
           "serving": bf16_serving(dev, main, graphs)}
    out["training"] = bf16_training(dev, trained, graphs, tmp)
    out["cli"] = bf16_preset_cli(trained["config"], tmp)
    out["wall_s"] = time.perf_counter() - t_phase
    return out


# ----------------------------------------------------------- convergence

#: the keys of the convergence report (scripts/convergence_study.py)
STUDY_REPORT_KEYS = {"steps", "train_seconds", "attention_type",
                     "corpus_style", "config", "heldout_texts",
                     "speaker_eval", "dominant_f0", "token_tone_accuracy",
                     "device"}


def checkpoint_saves(dev, trained: dict, tmp: str) -> dict:
    """(a) Checkpoint saves at full width (phase 6's float32 config, batch
    16, Adam moments beside the parameters): how long ``save`` blocks,
    asynchronous against ``async_save=False`` (median of 3); how long an
    asynchronous write takes to become durable; the replayed train step
    alone and with an asynchronous write in flight; and a checkpoint saved
    while replayed steps go on updating the state in place, read back
    bit-equal to the state at its step."""
    import os

    from tacotron_tpu_torch.data import DataFeeder
    from tacotron_tpu_torch.train.checkpoint import CheckpointManager
    from tacotron_tpu_torch.train.state import create_train_state
    from tacotron_tpu_torch.train.step import batch_to_device, make_train_step

    cfg = trained["config"]
    state = create_train_state(cfg, seed=0, device=dev)
    batches = DataFeeder(trained["corpus"], cfg, seed=5).batches()
    host = [next(batches) for _ in range(4)]
    step_fn = make_train_step(cfg)
    step_fn.prewarm(state, [batch_to_device(h, dev) for h in host])
    on_card = [batch_to_device(h, dev) for h in host]

    def step(i: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn(state, on_card[i % len(on_card)], 0)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for i in range(3):
        step(i)
    nbytes = sum(t.numel() * t.element_size() for t in
                 state.parameters() + state.opt.m + state.opt.v)
    out = {"state_mb": nbytes / 1e6}
    blocks = {}
    for name, async_save in (("async", True), ("sync", False)):
        mgr = CheckpointManager(os.path.join(tmp, f"ckpt_{name}"), cfg,
                                max_to_keep=2, async_save=async_save)
        walls, durable = [], []
        for _ in range(3):
            step(0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr.save(state)
            walls.append(time.perf_counter() - t0)
            mgr.wait()
            durable.append(time.perf_counter() - t0)
        mgr.close()
        blocks[name] = walls
        out[f"{name}_block_s"] = statistics.median(walls)
        out[f"{name}_durable_s"] = statistics.median(durable)

    # the replayed step alone, then with a write in flight
    alone = [step(i) for i in range(6)]
    mgr = CheckpointManager(os.path.join(tmp, "ckpt_overlap"), cfg,
                            max_to_keep=2)
    snap_step = state.step
    want = {k: v.detach().cpu().clone()
            for k, v in state.model.state_dict().items()}
    want_m = [t.detach().cpu().clone() for t in state.opt.m + state.opt.v]
    mgr.save(state)
    overlapped = []
    while any(not f.done() for f in mgr._pending) or not overlapped:
        overlapped.append(step(len(overlapped)))
    mgr.wait()
    require(state.step > snap_step, "(a) no step ran during the write")
    fresh = create_train_state(cfg, seed=1, device=dev)
    fresh = mgr.restore(fresh, step=snap_step)
    mgr.close()
    require(fresh.step == snap_step, f"(a) restored step {fresh.step}")
    for k, v in fresh.model.state_dict().items():
        require(torch.equal(v.cpu(), want[k]),
                f"(a) {k} differs from the state at step {snap_step}")
    for a, b in zip(fresh.opt.m + fresh.opt.v, want_m):
        require(torch.equal(a.cpu(), b),
                f"(a) an Adam moment differs from step {snap_step}")
    out.update(step_alone_s=statistics.median(alone),
               step_overlapped_s=statistics.median(overlapped),
               overlapped_steps=len(overlapped),
               steps_after_save=state.step - snap_step)
    log(f"[convergence] (a) checkpoint of {out['state_mb']:.1f} MB "
        f"(parameters and Adam moments, float32): save blocks "
        f"{out['async_block_s']:.4f} s async (median of 3; "
        f"{[round(w, 4) for w in blocks['async']]}) against "
        f"{out['sync_block_s']:.4f} s with async_save=False "
        f"({[round(w, 4) for w in blocks['sync']]}); durable after "
        f"{out['async_durable_s']:.4f} s async; the replayed step "
        f"{out['step_alone_s']:.4f} s alone, {out['step_overlapped_s']:.4f} "
        f"s with the write in flight ({len(overlapped)} steps); the "
        f"checkpoint of step {snap_step}, saved while {out['steps_after_save']}"
        f" replayed steps updated the state in place, reads back bit-equal")
    return out


def study_args(work: str, art: str, *args) -> list:
    """``python -m`` arguments of the convergence study on ``work``, its
    report into ``art``."""
    return ["tacotron_tpu_torch.studies.convergence_study", "--work", work,
            "--artifacts", art, "--utterances", "48", *args]


def study_report(art: str) -> dict:
    """The convergence study's report in ``art``, with the keys, device
    and bf16 preset config it must carry, and its speaker eval's keys."""
    import os

    from tacotron_tpu_torch.utils import card_line

    with open(os.path.join(art, "convergence_report.json"),
              encoding="utf-8") as fh:
        report = json.load(fh)
    require(set(report) == STUDY_REPORT_KEYS,
            f"(b) report keys {sorted(report)}")
    require(report["device"] == card_line(),
            f"(b) report device {report['device']!r}")
    require(report["config"]["compute_dtype"] == "bfloat16"
            and report["config"]["batch_size"] == 32,
            f"(b) report config {report['config']}")
    check_report(report["speaker_eval"], [0, 1], 8, "(b)")
    return report


def study_launches(dev, run: str, heldout, rng) -> dict:
    """(b) The study's held-out evaluation in this process on the run the
    CLI trained, each ``synthesize`` call's K1/K2 launches held to the
    counts its iterations, ``_budget`` and ``fused_supported`` give, and
    the kernel that ran against its plain version at each chunk's
    shape."""
    from tacotron_tpu_torch.ops.kernels.gl_fused import fused_supported
    from tacotron_tpu_torch.studies.convergence_study import evaluate
    from tacotron_tpu_torch.synth import Synthesizer
    from tacotron_tpu_torch.synth.synthesizer import trim_silence_db
    from tacotron_tpu_torch.text import text_to_sequence

    synth = Synthesizer(device=dev).load(run)
    audio, r = synth.config.audio, synth.config.model.reduction_factor
    calls = []
    inner = synth.synthesize

    def counted(**kw):
        # the waveforms are held at the exact lengths of their frame ends,
        # then given the dB trim that synthesize applies by default
        trim = kw.pop("librosa_trim", True)
        zero_counts()
        res = inner(**kw, librosa_trim=False)
        torch.cuda.synchronize()
        calls.append((kw, read_counts(), res))
        return dict(res, wavs=[trim_silence_db(w) if trim else w
                               for w in res["wavs"]])

    synth.synthesize = counted
    t0 = time.perf_counter()
    report, f0, tones = evaluate(synth, heldout, 2, False)
    wall = time.perf_counter() - t0
    del synth.synthesize
    out = {"wall_s": wall, "calls": []}
    for kw, counts, res in calls:
        seqs = [text_to_sequence(t, synth.cleaner_names(),
                                 symbol_set=synth.config.data.symbol_set)
                for t in kw["texts"]]
        steps = synth._budget([len(q) for q in seqs], kw.get("max_steps"),
                              32)[1]
        fast = kw.get("fast_vocoder", False)
        iters = synth.FAST_GRIFFIN_LIM_ITERS if fast else \
            audio.griffin_lim_iters
        fused = fused_supported(audio, steps * r)
        chunks = synth._chunks(len(kw["texts"]))
        want = {"K1": K1_PER_ITERATION * iters * len(chunks) if fused else 0,
                "K2": 0 if fused else (iters + 1) * len(chunks), "K3": 0}
        require(counts == want, f"(b) evaluation call ({len(seqs)} texts, "
                f"fast {fast}): launches {counts}, derived {want} ({steps} "
                f"steps, fused {fused})")
        if kw.get("attention_trim", True):
            check_waveforms(res, audio.hop_length, "(b) evaluation")
        else:   # untrimmed: every frame's samples, (frames - 1) * hop
            check_waveforms(dict(res, ends=[steps * r - 1] * len(seqs)),
                            audio.hop_length, "(b) evaluation, untrimmed")
        errs = {nb: (check_k1_at if fused else check_k2_at)(
                    dev, rng, audio, nb, steps * r)
                for nb in sorted({nb for _, _, nb in chunks})}
        out["calls"].append(dict(n=len(seqs), fast=fast, steps=steps,
                                 fused=fused, launches=counts,
                                 kernel_err=errs))
    out["launches"] = {k: sum(c["launches"][k] for c in out["calls"])
                       for k in ("K1", "K2")}
    out["tone_accuracy"] = {s: v["mean_accuracy"] for s, v in tones.items()}
    return out


def convergence_phase(dev, trained: dict, tmp: str) -> dict:
    """Phase 12 (a), (b)'s first study call and ``mulaw_quality``, and (c);
    ``out["resume_args"]`` is (b)'s second call, which runs beside phase
    14 (:func:`check_study_resume` checks it)."""
    import os

    from tacotron_tpu_torch.studies import make_synthetic_corpus as corpus
    from tacotron_tpu_torch.studies.convergence_study import \
        token_tone_accuracy
    from tacotron_tpu_torch.text import text_to_sequence

    t_phase = time.perf_counter()
    out = {"saves": checkpoint_saves(dev, trained, tmp)}

    # (b) the study CLI on one --work, alone on the card: its wall budget
    # and steps/s are read
    work = os.path.join(tmp, "study")
    art1, art2 = (os.path.join(tmp, f"study_art{i}") for i in (1, 2))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", *study_args(work, art1, "--steps", "100000",
                                            "--wall_budget_s", "5")],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=400)
    wall1 = time.perf_counter() - t0
    require(proc.returncode == 0, f"(b) the study's first call exited "
                                  f"{proc.returncode}: {proc.stderr[-3000:]}")
    first = study_report(art1)
    n1 = first["steps"]
    require(n1 > 0, f"(b) the first call trained {n1} steps")
    run = os.path.join(work, "run")
    heldout_json = os.path.join(work, "corpus", "heldout.json")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tacotron_tpu_torch.studies.mulaw_quality",
         "--load_path", run, "--texts_json", heldout_json],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=300)
    require(proc.returncode == 0, f"(b) mulaw_quality exited "
                                  f"{proc.returncode}: {proc.stderr[-2000:]}")
    mulaw = json.loads(proc.stdout)
    require(np.isfinite([mulaw["lsd_db_mean"], mulaw["snr_db_mean"]]).all(),
            f"(b) mulaw report {mulaw}")
    out["mulaw"] = dict(mulaw, wall_s=time.perf_counter() - t0)
    with open(heldout_json, encoding="utf-8") as fh:
        heldout = json.load(fh)
    out["study"] = dict(work=work, art2=art2, heldout=heldout,
                        first_steps=n1, first_s=wall1,
                        train_s=first["train_seconds"],
                        steps_per_s=n1 / max(first["train_seconds"], 1e-9))
    out["resume_args"] = study_args(work, art2, "--steps", str(n1 + 10))

    # (c) the instrument reads the ground truth as exactly right
    sr = trained["config"].audio.sample_rate
    for style in ("melody", "melody_var"):
        var = style == "melody_var"
        for text in heldout:
            tokens = text_to_sequence(text, ["korean_cleaners"])
            for spk in (0, 1):
                acc = token_tone_accuracy(
                    corpus.melody_wav(tokens, spk, sr, variable_rate=var),
                    text, spk, sr, variable_rate=var)
                require(acc["accuracy"] == 1.0
                        and acc["wrong_token_rate"] == 0.0,
                        f"(c) {style} speaker {spk} {text!r}: {acc}")
    log(f"[convergence] (c) token_tone_accuracy of melody_wav itself: 1.0, "
        f"wrong-token rate 0, for {len(heldout)} held-out sentences x 2 "
        f"speakers, melody and melody_var")
    out["wall_s"] = time.perf_counter() - t_phase
    return out


def check_study_resume(dev, out: dict, done: tuple) -> None:
    """Phase 12 (b)'s second study call, which ran beside phase 14: it
    resumed from the first call's checkpoint; then the study's held-out
    evaluation in this process on its run."""
    import os

    from tacotron_tpu_torch.train.checkpoint import checkpoint_steps
    from tacotron_tpu_torch.utils import read_metrics

    t0 = time.perf_counter()
    st = out["study"]
    n1, run = st["first_steps"], os.path.join(st["work"], "run")
    second = study_report(st["art2"])
    with open(os.path.join(run, "train.log"), encoding="utf-8") as fh:
        text = fh.read()
    logged = [r["step"] for r in read_metrics(
        os.path.join(run, "metrics.jsonl"), "train")]
    require(second["steps"] == n1 + 10
            and f"resumed from {run} at step {n1}" in text
            and checkpoint_steps(run)[-2:] == [n1, n1 + 10]
            and logged == sorted(set(logged)) and logged[-1] <= n1 + 10,
            f"(b) the second call did not resume from step {n1}: report "
            f"steps {second['steps']}, checkpoints {checkpoint_steps(run)}, "
            f"logged steps {logged[-5:]}")
    require(os.path.exists(os.path.join(st["art2"], "loss_curve.json")),
            "(b) no loss_curve.json")
    st["second_s"] = done[0]
    st["eval"] = ev = study_launches(dev, run, st["heldout"],
                                     np.random.default_rng(12))
    mulaw = out["mulaw"]
    log(f"[convergence] (b) the study CLI on a 48-a-speaker melody corpus, "
        f"batch 32, bf16: call 1 (--wall_budget_s 5) {n1} steps in "
        f"{st['train_s']:.1f} s of training ({st['steps_per_s']:.2f} "
        f"steps/s), exit 0 in {st['first_s']:.1f} s; mulaw_quality on its "
        f"run: LSD {mulaw['lsd_db_mean']} dB, SNR {mulaw['snr_db_mean']} "
        f"dB; call 2, beside phase 14, resumed at step {n1} to {n1 + 10}, "
        f"exit 0 within {done[0]:.1f} s; held-out evaluation in process "
        f"{ev['wall_s']:.2f} s: "
        + "; ".join(f"{c['n']} texts, {c['steps']} steps, fast "
                    f"{c['fast']}, fused {c['fused']}: launches "
                    f"{c['launches']}, {'K1 rel' if c['fused'] else 'K2 abs'}"
                    f" error {', '.join(f'B={b} {e:.3e}' for b, e in c['kernel_err'].items())}"
                    for c in ev["calls"])
        + f"; tone accuracy at step {n1 + 10} {ev['tone_accuracy']}")
    out["wall_s"] += time.perf_counter() - t0


# ----------------------------------------------------------------- studies

def check_k3_at(dev, rng, n_fft: int, rows: int) -> float:
    """K3 against its plain version on random frames and magnitudes of
    ``rows`` rows; the max error over the output's peak, at most 2e-3 (as
    in :func:`check_k3`)."""
    from tacotron_tpu_torch.ops.kernels import griffin_lim

    frames = torch.from_numpy(
        rng.standard_normal((rows, n_fft)).astype(np.float32)).to(dev)
    mag = torch.from_numpy(rng.random(
        (rows, n_fft // 2 + 1)).astype(np.float32) ** 1.5).to(dev)
    rel = rel_err(griffin_lim.spectral_step(frames, mag, n_fft),
                  griffin_lim.spectral_step_reference(frames, mag,
                                                      n_fft))[1]
    require(rel <= 2e-3, f"K3 at {rows} rows x n_fft {n_fft}: rel {rel}")
    return rel


def k4_bf16(dev, synth, rng) -> dict:
    """(a) K4 with bf16 weights, biases and mask, as JAX's kernel takes
    them, at the forward direction of the encoder's BiGRU (H=128) and the
    post-net's (H=256) of a full-width decode: counted launches, no copy
    in the wrapper, the output and the weight gradients against the plain
    version on the same bf16 tensors, the cluster route, and the time
    beside float32 K4 on the same inputs."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from tacotron_tpu_torch.ops.kernels import gru

    class Ops(TorchDispatchMode):
        """The aten operations run under it."""

        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func))
            return func(*args, **(kwargs or {}))

    captured = capture_bigru_inputs(dev, synth)
    sites = {}
    for name in ("encoder", "post-net"):
        x, h0, wg, bg, wc, bc, mask = direction_args(dev, captured, name)
        low = [t.to(torch.bfloat16) for t in (wg, bg, wc, bc, mask)]
        sites[name] = dict(f32=[x, h0, wg, bg, wc, bc, mask],
                           bf16=[x, h0, *low])
    # the counted run: each site once through the kernel
    gru.gru_sequence.launches = 0
    ops = Ops()
    with torch.no_grad(), ops:
        outs = {name: gru.gru_sequence(*site["bf16"])
                for name, site in sites.items()}
    torch.cuda.synchronize()
    launches = gru.gru_sequence.launches
    require(launches == 2, f"(a) bf16 K4 launched {launches} times, not 2")
    copies = [n for n in ops.names if "copy" in n]
    require(not copies, f"(a) the bf16 K4 wrapper copied a tensor: {copies}")
    out = {"launches": launches, "sites": {}}
    for name, site in sites.items():
        args = site["bf16"]
        x, h0 = args[:2]
        T, N, D = x.shape
        H = h0.shape[1]
        plan = gru.cluster_plan(N, H)
        require(plan.route == "cluster",
                f"(a) the {name} direction is not on the cluster route: "
                f"{plan}")
        with torch.no_grad():
            want = gru.gru_reference_scan(*args)
        require(outs[name].dtype == torch.float32,
                f"(a) bf16 K4 output {outs[name].dtype}")
        max_abs, rel = rel_err(outs[name], want)
        # the same f32 arithmetic on exactly converted operands, summed in
        # another order: the float32 kernel's bound against the module
        require(max_abs <= 1e-4, f"(a) bf16 K4 at the {name} direction: "
                                 f"{max_abs}")
        # weight gradients of a sum of squares: through the kernel's
        # Function (its backward the plain scan) against autograd through
        # the plain scan; bf16 gradients, so one bf16 ulp of the largest
        leaves = [t.detach().requires_grad_() for t in args[2:6]]
        with torch.enable_grad():
            g_k = torch.autograd.grad((gru.gru_sequence(
                x, h0, *leaves, args[6]) ** 2).sum(), leaves)
            g_p = torch.autograd.grad((gru.gru_reference_scan(
                x, h0, *leaves, args[6]) ** 2).sum(), leaves)
        require(all(g.dtype == torch.bfloat16 for g in g_k),
                f"(a) gradient dtypes {[g.dtype for g in g_k]}")
        grad_rel = max(rel_err(a.float(), b.float())[1]
                       for a, b in zip(g_k, g_p))
        require(grad_rel <= 2.0 ** -7, f"(a) bf16 K4 gradients at the "
                                       f"{name} direction: rel {grad_rel}")
        with torch.no_grad():
            ms = time_ms(lambda: gru.gru_sequence(*args))
            f32_ms = time_ms(lambda: gru.gru_sequence(*site["f32"]))
        flops = 2 * T * N * (D + H) * 3 * H
        nbytes = ((D + H) * 3 * H * 2 + 3 * H * 2    # bf16 weights, biases
                  + T * N * D * 4 + N * H * 4       # x, h0
                  + T * N * 2 + T * N * H * 4)      # bf16 mask, outputs
        t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
        out["sites"][name] = dict(
            shape="T={} N={} D={} H={}".format(T, N, D, H),
            max_abs_err=max_abs, rel_err=rel, grad_rel_err=grad_rel,
            ms=ms, f32_ms=f32_ms, plan=plan._asdict(), flops=flops,
            bytes=nbytes, bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes")
        log(f"[studies] (a) bf16-weight K4, {name} direction "
            f"{out['sites'][name]['shape']}: plan {plan.route} "
            f"{plan.cluster} blocks; max abs err {max_abs:.3e} (rel "
            f"{rel:.3e}), weight gradients (bf16) rel {grad_rel:.3e}; "
            f"{ms:.4f} ms against {f32_ms:.4f} ms float32; no copy in the "
            f"wrapper")
    with torch.no_grad():
        post = sites["post-net"]["bf16"]
        out["plain_ms"] = time_ms(graphed(
            lambda: gru.gru_reference_scan(*post)))
    return out


def load_launches(synth, calls: list, max_steps=None,
                  fast: bool = True) -> tuple:
    """(K1/K2/K3 launches, {(kernel, padded batch, frames)}) that the
    recorded ``synthesize`` calls (their texts) must make at ``max_steps``
    (None: the adaptive budget): each chunk runs the vocoder's iterations
    (the fast vocoder's, or the config's) through K1 where
    ``fused_supported`` takes its frames, else through matmul_half and K2
    (one more for the start)."""
    from tacotron_tpu_torch.ops.kernels.gl_fused import fused_supported
    from tacotron_tpu_torch.text import text_to_sequence

    audio, r = synth.config.audio, synth.config.model.reduction_factor
    want, shapes = {"K1": 0, "K2": 0, "K3": 0}, set()
    iters = (synth.FAST_GRIFFIN_LIM_ITERS if fast
             else audio.griffin_lim_iters)
    for texts in calls:
        seqs = [text_to_sequence(t, synth.cleaner_names(),
                                 symbol_set=synth.config.data.symbol_set)
                for t in texts]
        steps = synth._budget([len(q) for q in seqs], max_steps, 32)[1]
        chunks = synth._chunks(len(texts))
        fused = fused_supported(audio, steps * r)
        if fused:
            want["K1"] += K1_PER_ITERATION * iters * len(chunks)
        else:
            want["K2"] += (iters + 1) * len(chunks)
        shapes |= {("K1" if fused else "K2", nb, steps * r)
                   for _, _, nb in chunks}
    return want, shapes


#: the keys of a serving_load row: the script's, and the port's launch
#: and replay counts
LOAD_ROW_KEYS = {"concurrency", "requests", "p50_ms", "p95_ms", "mean_ms",
                 "throughput_rps", "batched_calls", "max_batch",
                 "k1_launches", "k2_launches", "replays"}


def sweep_study(dev, rng) -> dict:
    """(c) One ``pallas`` point of ``studies/synth_sweep.py`` at batch 16
    (``Config()``, random weights from seed 0, 50 steps, 30 momentum
    iterations): its eager call's K3 and K2 launches held to the engine's
    (one K3 an iteration, one K2 more than the iterations), the kernels
    against their plain versions at the point's shapes, a finite
    convergence and both times."""
    from tacotron_tpu_torch.config import Config
    from tacotron_tpu_torch.studies import synth_sweep
    from tacotron_tpu_torch.synth import Synthesizer

    synth = Synthesizer(device=dev).init_random(Config())
    B, iters = 16, 30
    inp, lens = synth_sweep.make_inputs(synth, B)
    with torch.no_grad():
        spec0 = synth.model(inp, lens, max_steps=synth_sweep.MAX_STEPS)[
            "linear_outputs"][0].float().cpu().numpy()
    point = synth_sweep.sweep_point(synth, inp, lens, spec0, "pallas", iters,
                                    0.99, reps=3, warmup=1)
    want = {"k3_launches": iters, "k2_launches": iters + 1}
    got = {k: point[k] for k in want}
    require(got == want, f"(c) sweep point launches {got}, derived {want}")
    require(np.isfinite(point["spectral_convergence"])
            and point["batch_seconds"] > 0, f"(c) point {point}")
    audio = synth.config.audio
    frames = synth_sweep.MAX_STEPS * synth.config.model.reduction_factor
    point["kernel_err"] = {
        "K3": check_k3_at(dev, rng, audio.n_fft, B * frames),
        "K2": check_k2_at(dev, rng, audio, B, frames)}
    return point


@contextlib.contextmanager
def beside(runs: dict):
    """``python -m <args>`` for each ``name: args`` of ``runs``, as a user
    runs it, on the card, all started on entry and run beside the body
    (they share the card as several users' jobs would); on exit each is
    waited for and must exit 0.  Yields the dict it then fills with
    {name: (seconds from the start until it was seen to have exited,
    stdout)}: a command that ended during the body is seen at its end, so
    its seconds bound its run time from above."""
    import os

    t0 = time.perf_counter()
    procs, out = {}, {}
    # each writes to files, so that none stalls on a full pipe while
    # another is waited for
    with tempfile.TemporaryDirectory() as logs:
        try:
            for name, args in runs.items():
                files = [open(os.path.join(logs, f"{name}.{k}"), "w+")
                         for k in ("out", "err")]
                procs[name] = (subprocess.Popen(
                    [sys.executable, "-m", *args],
                    cwd=os.path.dirname(os.path.abspath(__file__)),
                    stdout=files[0], stderr=files[1], text=True), files)
            yield out
            for name, (proc, files) in procs.items():
                proc.wait(timeout=400)
                wall = time.perf_counter() - t0
                for f in files:
                    f.seek(0)
                stdout, stderr = (f.read() for f in files)
                require(proc.returncode == 0, f"{name} exited "
                        f"{proc.returncode}: {stderr[-3000:]}")
                out[name] = (wall, stdout)
        finally:
            for proc, files in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                for f in files:
                    f.close()


def studies_phase(dev, main: dict, tmp: str) -> dict:
    """Phase 13 (a) and (c) of the module docstring ((b) is phase 14's
    load section; (d) runs beside phase 14)."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(13)
    out = {"k4": k4_bf16(dev, main["synth"], rng)}
    out["sweep"] = sweep_study(dev, rng)
    p = out["sweep"]
    log(f"[studies] (c) synth_sweep pallas point at batch 16: replay "
        f"{p['batch_seconds']} s ({p['audio_s_per_s']} audio s/s), eager "
        f"{p['eager_seconds']} s ({p['eager_audio_s_per_s']} audio s/s), "
        f"capture {p['capture_s']} s, spectral convergence "
        f"{p['spectral_convergence']}, launches K3 {p['k3_launches']} K2 "
        f"{p['k2_launches']} (as derived)")
    out["wall_s"] = time.perf_counter() - t_phase
    return out


def study_runs(tmp: str) -> dict:
    """Phase 13 (d)'s two training studies, a few steps each (10 a
    bf16_study arm; 640 samples give batch_study's batch-64 arms the 10
    steps of one logged record): {name: ``python -m`` arguments}."""
    import os

    return {"bf16_study": ["tacotron_tpu_torch.studies.bf16_study",
                           "--steps", "10", "--work_dir",
                           os.path.join(tmp, "bf16_study")],
            "batch_study": ["tacotron_tpu_torch.studies.batch_study",
                            "--samples", "640", "--work",
                            os.path.join(tmp, "batch_study")]}


def check_studies(done: dict, tmp: str) -> dict:
    """Phase 13 (d): the reports' device line and keys."""
    import os

    from tacotron_tpu_torch.utils import card_line

    with open(os.path.join(tmp, "bf16_study", "BF16_STUDY.md"),
              encoding="utf-8") as fh:
        text = fh.read()
    require(f"device: {card_line()}." in text and "**Recommendation**"
            in text, f"(d) bf16_study report: {text[:400]!r}")
    summary = json.loads(done["batch_study"][1].strip().splitlines()[-1])
    require(set(summary) == {"b16", "b64", "b64_rescaled", "winner",
                             "rel_diff"}
            and np.isfinite([summary["b16"], summary["b64"]]).all(),
            f"(d) batch_study summary {summary}")
    cli = dict(bf16_s=done["bf16_study"][0], batch_s=done["batch_study"][0],
               batch_summary=summary)
    log(f"[studies] (d) bf16_study --steps 10 and batch_study --samples "
        f"640 at once, beside phase 14: exit 0 within {cli['bf16_s']:.1f} "
        f"s and {cli['batch_s']:.1f} s, {summary}")
    return cli


# ------------------------------------------------------------------ bench

def bench_missing_keys(record: dict) -> list:
    """The keys of the committed root record (``BENCH_DETAIL.json``),
    through the port's ``RENAMED``, that ``record`` lacks."""
    import os

    from tacotron_tpu_torch.bench import RENAMED

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "BENCH_DETAIL.json"), encoding="utf-8") as fh:
        root = json.load(fh)
    missing = [k for k in root if k not in record]
    detail = record["detail"]
    for key, value in root["detail"].items():
        names = ([f"roofline.{k}" for k in value] if key == "roofline"
                 else [key])
        for name in names:
            name = RENAMED.get(name, name)
            head, _, sub = name.partition(".")
            if head not in detail or (sub and sub not in detail[head]):
                missing.append(name)
    return missing


#: phase 14's counts: the timed calls of each eager row (the first call,
#: one warm-up, two repetitions)
BENCH_COUNTS = dict(warmup=1, reps=2, chain=3, fresh=2, load_levels=(1, 4),
                    load_requests=4)
BENCH_EAGER_CALLS = 1 + 1 + 2
BENCH_EAGER_ROWS = ("raw", "fast_gla", "serving", "serving_latency_1utt")


def bench_phase(dev) -> dict:
    """Phase 14 of the module docstring."""
    import math

    from tacotron_tpu_torch import bench
    from tacotron_tpu_torch.config import Config
    from tacotron_tpu_torch.ops.kernels.gl_fused import fused_supported
    from tacotron_tpu_torch.studies import serving_load, synth_sweep
    from tacotron_tpu_torch.synth import Synthesizer
    from tacotron_tpu_torch.synth.synthesizer import split_text

    t_phase = time.perf_counter()
    rng = np.random.default_rng(14)
    cfg = Config()
    synth = Synthesizer(device=dev).init_random(cfg)
    run_load_test, calls, load = serving_load.run_load_test, [], {}

    def traced_load(s, **kw):
        """The load section with its calls' texts recorded and the run
        traced: the replays' launches, which the counters do not see."""
        inner = s.synthesize

        def recorded(**k):
            calls.append(list(k["texts"]))
            return inner(**k)

        s.synthesize = recorded
        before = read_counts()
        try:
            report, summary = traced(lambda: run_load_test(s, **kw))
        finally:
            del s.synthesize
        load["counted"] = {k: v - before[k] for k, v in read_counts().items()}
        load["trace"] = trace_counts(summary)
        return report

    # a capture's warm-up and capture run through the wrappers: their
    # launches are counted apart
    harness_capture, in_captures = bench._Harness.capture, dict.fromkeys(
        ("K1", "K2", "K3"), 0)

    def capture(self, fn):
        before = read_counts()
        out = harness_capture(self, fn)
        for k, v in read_counts().items():
            in_captures[k] += v - before[k]
        return out

    serving_load.run_load_test = traced_load
    bench._Harness.capture = capture
    zero_counts()
    try:
        record = bench.run(synth, cfg, batch=32, max_steps=50,
                           **BENCH_COUNTS)
    finally:
        serving_load.run_load_test = run_load_test
        bench._Harness.capture = harness_capture
    counted = {k: v - in_captures[k] for k, v in read_counts().items()}
    wall = time.perf_counter() - t_phase
    detail = record["detail"]

    missing = bench_missing_keys(record)
    require(not missing, f"the record lacks {missing}")
    bad = [p for p, v in bench.numbers(record) if not math.isfinite(v)]
    require(not bad, f"numbers not finite: {bad}")
    require(detail["training_scan_unroll"] is None
            and detail["device"] == card_line(),
            f"scan unroll {detail['training_scan_unroll']}, device "
            f"{detail['device']}")
    headline = bench.headline_line(record, bench.DEFAULT_OUT)
    require(len(headline.encode()) <= 200, f"headline {headline}")

    # each section's first call, as its texts, steps and vocoder give
    audio, r = cfg.audio, cfg.model.reduction_factor
    require(fused_supported(audio, 50 * r), "50 steps off the fused engine")
    texts = [synth_sweep.TEXTS[i % len(synth_sweep.TEXTS)]
             for i in range(32)]
    chunks = split_text(bench.LONG_TEXT, 120, synth.cleaner_names())

    # the (kernel, padded batch, frames) of every call: the raw and fast
    # programs vocode the whole batch at once
    shapes = {("K1", 32, 50 * r)}

    def kernels(calls_, max_steps, fast):
        want, at = load_launches(synth, calls_, max_steps, fast)
        shapes.update(at)
        return {"K1": want["K1"], "K2": want["K2"]}

    derived = {
        "raw": {"K1": K1_PER_ITERATION * audio.griffin_lim_iters, "K2": 0},
        "fast_gla": {"K1": K1_PER_ITERATION * synth.FAST_GRIFFIN_LIM_ITERS,
                     "K2": 0},
        "serving": kernels([texts], 50, False),
        "serving_fast": kernels([texts], 50, True),
        "serving_mulaw8": kernels([texts], 50, True),
        "serving_latency_1utt": kernels([texts[:1]], 50, True),
        "serving_default_1utt": kernels([texts[:1]], None, True),
        "serving_default_batch": kernels([texts], None, True),
        "long_text": kernels([chunks], None, True)}
    require(derived["raw"]["K1"] == 240 and derived["fast_gla"]["K1"] == 120,
            f"derived {derived}")
    require(detail["launches"] == derived,
            f"first calls' launches {detail['launches']}, derived {derived}")
    # the replays the headline times: the same waveforms as the eager
    # first call on the same inputs (bench.run raises past the limit too)
    replay = detail["replay_vs_eager"]
    require(set(replay) == {"raw", "fast_gla"} and max(replay.values())
            <= bench.REPLAY_TOLERANCE,
            f"replayed programs against their eager calls {replay} (limit "
            f"{bench.REPLAY_TOLERANCE} of the peak)")
    # every other call replayed: the counters saw the eager rows' timed
    # calls and the first calls only
    want_total = {k: sum(v[k] * (BENCH_EAGER_CALLS if sec in
                                 BENCH_EAGER_ROWS else 1)
                         for sec, v in derived.items()) for k in ("K1", "K2")}
    require({k: counted[k] for k in want_total} == want_total
            and counted["K3"] == 0,
            f"launches over the run {counted} (and {in_captures} in the "
            f"captures), derived {want_total}")

    # the load rows (phase 13 (b) until this phase came): every call
    # replayed, K2 31 times a call in the trace
    want, at = load_launches(synth, calls)
    shapes |= at
    got = {k: load["counted"][k] + load["trace"][k] for k in want}
    require(got == want and want["K2"] == 31 * len(calls),
            f"serving_load launches {got} (counters {load['counted']}, "
            f"trace {load['trace']}), derived {want} from {len(calls)} calls")
    require(not any(load["counted"].values()),
            f"a prewarmed load call ran eagerly: counters {load['counted']}")
    rows = detail["serving_concurrent_levels"]
    require([(x["max_batch"], x["concurrency"]) for x in rows]
            == [(4, 1), (4, 4), (1, 1), (1, 4)], f"load rows {rows}")
    for row in rows:
        require(set(row) == LOAD_ROW_KEYS, f"load row keys {sorted(row)}")
        require(row["k1_launches"] == row["k2_launches"] == 0
                and 1 <= row["replays"] <= row["requests"],
                f"load row {row}: every call replays")
        if row["concurrency"] == 1 or row["max_batch"] == 1:
            require(row["batched_calls"] == 0
                    and row["replays"] == row["requests"],
                    f"coalesced without concurrency: {row}")
    require(sum(x["replays"] for x in rows) == len(calls),
            f"{sum(x['replays'] for x in rows)} replays for {len(calls)} "
            f"calls")
    # each kernel against its plain version at every shape of the run
    errs = {f"{k} B={nb} T={frames}":
            (check_k1_at if k == "K1" else check_k2_at)(
                dev, rng, audio, nb, frames)
            for k, nb, frames in sorted(shapes)}
    return dict(record=record, headline=headline, counted=counted,
                in_captures=in_captures, load_trace=load["trace"],
                load_calls=len(calls),
                kernel_err=errs, wall_s=wall,
                check_s=time.perf_counter() - t_phase - wall)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from tacotron_tpu_torch.ops.kernels import _build

    dev = torch.device("cuda")
    card = card_line()
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    # K4's library takes ~8x the others' compile time and nothing before
    # its checks runs it: its nvcc runs beside K1-K3's checks and phase 4
    pool = concurrent.futures.ThreadPoolExecutor(1)
    gru_build = pool.submit(_build.build, ["gru"])
    built = _build.build([n for n in _build.SOURCES if n != "gru"])
    rng = np.random.default_rng(0)
    kernels = [check_k1(dev, rng), check_k2(dev, rng), check_k3(dev, rng)]
    main = main_path(dev)
    for k, name in zip(kernels, ("K1", "K2", "K3")):
        k["launches"] = sum(c[name] for c in main["launches"].values())
        k["launches_by_call"] = {c: v[name]
                                 for c, v in main["launches"].items()}
    built.update(gru_build.result())
    pool.shutdown()
    log(f"[build] {time.perf_counter() - t0:.1f} s to K4's library, phase "
        f"4 beside it "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in built.items())})")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[ptxas {name}] {line.strip()}")

    sass = sass_counts(_build.SOURCES)
    log(f"[sass] {json.dumps(sass)}")
    for name in ("gl_fused", "griffin_lim"):
        require(sass[name]["HGMMA"] > 0 and sass[name]["UTMALDG"] > 0,
                f"lib{name}.so issues no wgmma or no TMA load: {sass[name]}")
    require(all(sass["gru"][op] > 0 for op in ("UCGABAR", "STAS", "SYNCS")),
            f"libgru.so has no cluster barrier, distributed shared-memory "
            f"store or mbarrier operation: {sass['gru']}")
    log(f"[kernel] {check_edge_shapes(dev, rng)} ragged shapes agree with "
        f"the plain versions")
    kernels.append(check_k4(dev, main["synth"], rng))
    stamp("phases 1-5")
    with tempfile.TemporaryDirectory() as tmp:
        trained = train_phase(dev, tmp)
        stamp("phase 6")
        timing = trained["timing"]
        log(f"[train] batch 16, full width: median "
            f"{timing['sec_per_step']:.4f} sec/step, "
            f"{timing['target_frames_per_s']:.1f} target frames/s, peak "
            f"memory {timing['peak_memory_gib']:.2f} GiB, device idle share "
            f"of steps 11-15 {trained['profile']['device_idle_share']:.4f} "
            f"on {card}")
        serve = serve_phase(dev, main["synth"], trained, tmp)
        stamp("phase 7")
        t8 = time.perf_counter()
        graphs = serving_graphs(main, tmp)
        stamp("phase 8 (a)-(c)")
        graphs["train"] = train_graphs(dev, trained, tmp)
        graphs["wall_s"] = time.perf_counter() - t8
        stamp("phase 8 (d)")
        par = parallel_phase(dev, main, trained, tmp)
        stamp("phase 9")
        corpus = corpus_phase(dev, tmp)
        stamp("phase 10")
        bf16 = bf16_phase(dev, main, trained, graphs, tmp)
        stamp("phase 11")
        conv = convergence_phase(dev, trained, tmp)
        stamp("phase 12")
        studies = studies_phase(dev, main, tmp)
        stamp("phase 13 (a) and (c)")
        # user commands whose times no metric reads run beside phase 14,
        # whose timings nothing reads either (the bench's own run is alone
        # on the card): phase 11 (d), 12 (b)'s second call, 13 (d)
        runs = dict(preset_cli=bf16["cli"]["args"],
                    convergence_study=conv["resume_args"], **study_runs(tmp))
        with beside(runs) as done:
            bench = bench_phase(dev)
            stamp("phase 14")
        check_preset_cli(bf16["cli"], done["preset_cli"])
        check_study_resume(dev, conv, done["convergence_study"])
        studies["cli"] = check_studies(done, tmp)
        stamp("phases 11 (d), 12 (b) and 13 (d) beside phase 14")
    stamp("the temporary files removed")
    for k, name in zip(kernels, ("K1", "K2", "K3")):
        k["launches_serving"] = {step: v[name]
                                 for step, v in serve["launches"].items()}
    burst = serve["burst_request_s"]
    log(f"[serve] one request {serve['single_s']:.4f} s; burst of 4: "
        f"{statistics.mean(burst):.4f} s per request (max {max(burst):.4f}); "
        f"synthesize_long {serve['long_s']:.4f} s "
        f"({serve['long_audio_s']:.2f} s audio); robust {serve['robust_s']:.4f}"
        f" s (manual mode {serve['manual_s']:.4f} s); vocode host "
        f"{serve['host_s']:.4f} s vs chip {serve['chip_s']:.4f} s on the same "
        f"2 texts; phase 7 wall time {serve['wall_s']:.1f} s on {card}")
    g, gt = graphs, graphs["train"]
    log("[graphs] eager -> replay: " + "; ".join(
        f"call ({c}) {g[c]['eager_s']:.4f} -> {g[c]['replay_s']:.4f} s, idle "
        f"{g[c]['eager_idle']:.4f} -> {g[c]['replay_idle']:.4f}"
        for c in ("a", "b", "c"))
        + f"; server one GET {serve['single_s']:.4f} -> "
        f"{g['server']['single_s']:.4f} s, burst of 4 {serve['burst_s']:.4f}"
        f" -> {g['server']['burst_s']:.4f} s ({g['server_replays']} replays,"
        f" 21 programs prewarmed in {g['server_prewarm_s']:.1f} s); train "
        f"step {gt['eager']['sec_per_step']:.4f} -> "
        f"{gt['replay']['sec_per_step']:.4f} s, "
        f"{gt['eager']['target_frames_per_s']:.1f} -> "
        f"{gt['replay']['target_frames_per_s']:.1f} target frames/s, peak "
        f"{gt['eager']['peak_memory_gib']:.2f} -> "
        f"{gt['replay']['peak_memory_gib']:.2f} GiB allocated, "
        f"{gt['eager']['peak_reserved_gib']:.2f} -> "
        f"{gt['replay']['peak_reserved_gib']:.2f} GiB reserved, idle "
        f"{gt['eager_idle']:.4f} -> {gt['replay_idle']:.4f}; phase 8 wall "
        f"time {g['wall_s']:.1f} s on {card}")
    for k, name in zip(kernels, ("K1", "K2", "K3")):
        # counted in a trace of each call's replay
        k["launches_graphs"] = {c: g[c]["launches"][name]
                                for c in ("a", "b", "c")}
        # make_sharded_synthesis, phase 9 (c)
        k["launches_parallel"] = {
            c: par["synthesis"][c]["counts"][name]
            for c in ("default", "pallas")}
    t = par["timing"]
    log(f"[parallel] data-parallel step (NCCL, world size 1) "
        f"{t['dp_eager']:.4f} s eager, {t['dp_replay']:.4f} s replayed; "
        f"plain step {t['plain_eager']:.4f} s, {t['plain_replay']:.4f} s; "
        f"all-reduce in one traced replay {par['nccl_kernels']} kernels, "
        f"{par['nccl_ms']:.4f} ms; MFU replayed "
        f"{par['roofline']['mfu_pct'][1]:.3f} % of "
        f"{par['roofline']['peak_tflops']:.0f} TFLOP/s fp32; phase 9 wall "
        f"time {par['wall_s']:.1f} s on {card}")
    ev = corpus["eval"]
    log(f"[corpus] clips split {corpus['clips']}; utterances built "
        f"{corpus['built']}, skipped {corpus['skipped']}; build wall 1 "
        f"worker {corpus['build_s'][1]:.2f} s, 2 workers "
        f"{corpus['build_s'][2]:.2f} s; built corpus "
        f"{corpus['corpus_s']:.2f} s of audio; train median of 4 timed "
        f"steps {corpus['step_s']:.4f} s/step; speaker eval 50 steps "
        f"{ev['steps50']['wall_s']:.3f} s (K1 {ev['steps50']['launches']['K1']}"
        f", K2 {ev['steps50']['launches']['K2']}), default budget "
        f"({ev['default']['steps']} steps) {ev['default']['wall_s']:.3f} s "
        f"(K1 {ev['default']['launches']['K1']}, K2 "
        f"{ev['default']['launches']['K2']}); CLI {corpus['cli_s']:.1f} s; "
        f"phase 10 wall time {corpus['wall_s']:.1f} s on {card}")
    for k, name in zip(kernels, ("K1", "K2")):
        # phase 10 (e): evaluate_speakers on the trained corpus voice
        k["launches_corpus"] = {c: v["launches"][name]
                                for c, v in ev.items()}
    for k, name in zip(kernels, ("K1", "K2", "K3")):
        # phase 11 (b): the bf16 rungs, eagerly (their replays' traces
        # count the same)
        k["launches_bf16"] = {c: v["launches"][name]
                              for c, v in bf16["serving"].items()}
    fw, sv, tr = bf16["forward"], bf16["serving"], bf16["training"]
    log(f"[bf16] forward card vs CPU: mel "
        f"{fw['bf16_vs_cpu/mel_outputs']:.3e}, linear "
        f"{fw['bf16_vs_cpu/linear_outputs']:.3e} of the peak; bf16 vs f32: "
        f"mel {fw['bf16_vs_f32/mel_outputs']:.3e}, linear "
        f"{fw['bf16_vs_f32/linear_outputs']:.3e}, alignments "
        f"{fw['bf16_vs_f32/alignments']:.3e}; serving (a) "
        f"{sv['a']['eager_s']:.4f} -> {sv['a']['replay_s']:.4f} s (f32 "
        f"{g['a']['eager_s']:.4f} -> {g['a']['replay_s']:.4f}), (b) "
        f"{sv['b']['eager_s']:.4f} -> {sv['b']['replay_s']:.4f} s (f32 "
        f"{g['b']['eager_s']:.4f} -> {g['b']['replay_s']:.4f}); train step "
        f"{tr['eager']['sec_per_step']:.4f} -> "
        f"{tr['replay']['sec_per_step']:.4f} s (f32 "
        f"{gt['eager']['sec_per_step']:.4f} -> "
        f"{gt['replay']['sec_per_step']:.4f}), "
        f"{tr['replay']['target_frames_per_s']:.1f} target frames/s "
        f"replayed (f32 {gt['replay']['target_frames_per_s']:.1f}), peak "
        f"{tr['eager']['peak_memory_gib']:.2f} / "
        f"{tr['replay']['peak_reserved_gib']:.2f} GiB (f32 "
        f"{gt['eager']['peak_memory_gib']:.2f} / "
        f"{gt['replay']['peak_reserved_gib']:.2f}); loss "
        f"{tr['loss_first5']:.4f} -> {tr['loss_last5']:.4f}; --preset tpu "
        f"within {bf16['cli']['wall_s']:.1f} s (beside phase 14); phase 11 "
        f"wall time {bf16['wall_s']:.1f} s on {card}")
    for k, name in zip(kernels, ("K1", "K2")):
        # phase 12 (b): the study's held-out evaluation
        k["launches_convergence"] = conv["study"]["eval"]["launches"][name]
    sv, st = conv["saves"], conv["study"]
    log(f"[convergence] save blocks {sv['async_block_s']:.4f} s async, "
        f"{sv['sync_block_s']:.4f} s sync, durable {sv['async_durable_s']:.4f}"
        f" s ({sv['state_mb']:.1f} MB); replayed step "
        f"{sv['step_alone_s']:.4f} s alone, {sv['step_overlapped_s']:.4f} s "
        f"beside a write; study {st['first_steps']} steps in "
        f"{st['train_s']:.1f} s ({st['steps_per_s']:.2f} steps/s), resumed; "
        f"evaluation launches {st['eval']['launches']}; mulaw LSD "
        f"{conv['mulaw']['lsd_db_mean']} dB, SNR "
        f"{conv['mulaw']['snr_db_mean']} dB; phase 12 wall time "
        f"{conv['wall_s']:.1f} s on {card}")
    for k, name in zip(kernels, ("K1", "K2", "K3")):
        # phase 13 (c) (the eager call)
        k["launches_studies"] = {
            "synth_sweep": {"K2": studies["sweep"]["k2_launches"],
                            "K3": studies["sweep"]["k3_launches"]}.get(
                                name, 0)}
    k4, k4b = kernels[3], studies["k4"]
    post, enc = k4b["sites"]["post-net"], k4b["sites"]["encoder"]
    kernels.append({
        "name": "gru_sequence (bf16 weights, biases and mask)",
        "route": "cuda", "source": "tacotron_tpu_torch/csrc/gru.cu",
        "replaces": "tacotron_tpu/ops/pallas/gru.py:47",
        "tpu_kernel": "gru.py::_gru_kernel via _gru_pallas_raw / "
                      "gru_sequence, with bf16 wg, bg, wc, bc and mask",
        "shape": f"one direction of the post-net BiGRU: {post['shape']}",
        "launches": k4b["launches"],
        "max_abs_err": max(post["max_abs_err"], enc["max_abs_err"]),
        "grad_max_rel_err": {"post-net": post["grad_rel_err"],
                             "encoder": enc["grad_rel_err"]},
        "ms": post["ms"], "f32_ms": post["f32_ms"],
        "ms_encoder_direction": enc["ms"],
        "f32_ms_encoder_direction": enc["f32_ms"],
        "plain_ms": k4b["plain_ms"], "library_ms": None,
        "library_note": k4["library_note"],
        "bound_ms": post["bound_ms"], "bound_by": post["bound_by"],
        "floor_ms": k4["floor_ms"], "plan": post["plan"],
        "flops": post["flops"], "bytes": post["bytes"]})
    sw, cli = studies["sweep"], studies["cli"]
    log(f"[studies] bf16-weight K4 {post['ms']:.4f} ms (float32 "
        f"{post['f32_ms']:.4f}) post-net, {enc['ms']:.4f} ms (float32 "
        f"{enc['f32_ms']:.4f}) encoder; synth_sweep "
        f"pallas at batch 16 {sw['batch_seconds']} s replayed, "
        f"{sw['eager_seconds']} s eager; bf16_study within "
        f"{cli['bf16_s']:.1f} s, batch_study within {cli['batch_s']:.1f} s "
        f"(beside phase 14); phase 13 "
        f"wall time {studies['wall_s']:.1f} s ((a) and (c)) on {card}")
    d = bench["record"]["detail"]
    log(f"[bench] python -m tacotron_tpu_torch.bench's run() in process at "
        f"full width, batch 32 x 50 steps, {BENCH_COUNTS}: headline "
        f"{bench['headline']}; raw program {d['device_batch_seconds']:.4f} "
        f"s replayed, {d['eager_device_batch_seconds']:.4f} s eager; "
        f"serving {d['serving_batch_seconds']:.4f} s replayed, "
        f"{d['eager_serving_batch_seconds']:.4f} s eager; train step "
        f"{d['training_step_seconds']:.4f} s replayed, "
        f"{d['eager_training_step_seconds']:.4f} s eager; prewarm "
        f"{d['prewarm_s']:.1f} s; first calls' launches {d['launches']} "
        f"(as derived); launches over the run {bench['counted']} (the eager "
        f"rows' timed calls and the first calls), in the captures "
        f"{bench['in_captures']}; serving_load {bench['load_calls']} calls, "
        f"{bench['load_trace']} in the trace (31 K2 a call); replays "
        f"against eager {d['replay_vs_eager']}; kernels against their "
        f"plain versions at the run's shapes "
        f"{ {k: float(f'{v:.3e}') for k, v in bench['kernel_err'].items()} }"
        f"; run {bench['wall_s']:.1f} s, checks {bench['check_s']:.1f} s, "
        f"beside phase 11 (d)'s CLI, 12 (b)'s second call and 13 (d)'s "
        f"studies, on {card}")
    for k, name in zip(kernels, ("K1", "K2", "K3")):
        # phase 14: each section's first call, every eager call of the
        # run, and the load's replays counted in a trace
        k["launches_bench"] = {
            "first_calls": {sec: v.get(name, 0)
                            for sec, v in d["launches"].items()},
            "eager_calls": bench["counted"][name],
            "serving_load_trace": bench["load_trace"][name]}
    for k in kernels:
        gemm = (f", cuBLAS products {k['gemm_library_ms']:.4f} ms, "
                f"{k['tflops']:.1f} TFLOP/s" if "tflops" in k else "")
        floor = (f", latency floor {k['floor_ms']:.4f} ms"
                 if "floor_ms" in k else "")
        log(f"[kernel] {k['name']} {k['shape']}: {k['ms']:.4f} ms, plain "
            f"{k['plain_ms']:.4f} ms, library {k['library_ms']}, bound "
            f"{k['bound_ms']:.4f} ms ({k['bound_by']}){floor}, max abs err "
            f"{k['max_abs_err']:.3e}, launches {k['launches']}{gemm}")
    st = graphs["stamps"]
    log(f"[kernel] stamp (csrc/stamp.cu, %globaltimer, no TPU counterpart):"
        f" 3 a chunk, captured; phase 8 (b)'s replayed call of "
        f"{st['chunks']} chunks: the last chunk's stamps in order, decode "
        f"{st['last_chunk_ms'][0]:.3f} ms and vocoder "
        f"{st['last_chunk_ms'][1]:.3f} ms; the call's decode "
        f"{st['decode_ms']:.3f} ms and vocoder {st['vocoder_ms']:.3f} ms "
        f"within its {st['wall_ms']:.3f} ms")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if "--parallel-rank" in sys.argv:
        sys.exit(parallel_worker(sys.argv[1:]))
    sys.exit(main())
