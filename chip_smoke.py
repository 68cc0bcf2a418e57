#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

1. Device: requires CUDA, prints the card's name and power limit, turns TF32
   off for matmuls and cuDNN convolutions.
2. Build: compiles every kernel of ``tacotron_tpu_torch/csrc`` with nvcc for
   sm_90a, one process per source, all at once (four libraries), and
   prints a ``[sass]`` line counting each library's wgmma (``HGMMA``),
   TMA-load (``UTMALDG``), cluster-barrier (``UCGABAR``), distributed
   shared-memory store (``STAS``) and mbarrier (``SYNCS``) instructions;
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
   on the card and on the CPU agree; (c) ``train()`` for 20 steps at batch
   16 with evals, sample dumps, checkpoints and a ``torch.profiler`` trace
   of steps 10-15, then a resume to step 30: the loss falls, and
   ``metrics.jsonl`` carries the JAX driver's keys; (d) 5 steps from a
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
   replays out of capture order, equal to eager; (c) the app's 21
   programs, then phase 7 (e)'s requests under a trace (K1 on the short
   ones, K2 on the long POST), replayed; (d) ``train(..., prewarm=True)``
   for 20 steps and a resume to 30 on phase 6's corpus and seed: every
   step of a bucket shape replays its graph once, per-step losses and
   final parameters of the nearer eager run (phase 6's or one more)
   within twice the spread of the two or 1e-5, a falling loss, and eager
   against replayed steps on the same 4 batches (step time, target
   frames/s, peak memory) with the idle share of steps 11-15.  A
   ``[graphs]`` line sums it up.
9. Several processes (``parallel/``), on phase 6's corpus with every batch
   padded to the corpus maxima (one shape).  (a) ``train()`` for 10 steps
   at batch 16 under an NCCL group of world size 1 (the torchrun
   environment on a free port) against the same 10 steps without a plan:
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
10. Prints the kernels line, the card line, and last the result line
   ``{"ok": true, "device": {...}}``.

Any failure raises, exits nonzero and prints no result line.
"""

from __future__ import annotations

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
    flops = 8 * B * T * M * (ne + no)
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


def check_edge_shapes(dev, rng) -> int:
    """Every kernel against its plain version at ragged shapes: frame
    counts and rows that leave partial tiles, stacks shorter than a frame's
    hop chunks, one item, a small geometry (n_fft 256, hop 128) and an n_fft
    that is not a multiple of the tile (254); for the overlap-add also one
    frame, an output length that is not a multiple of 4 and a hop of 125
    (the 2- and 1-sample paths of ``ola_plan``); GRUs with T = 1, N = 1,
    lengths of 0 and T, H not a multiple of 32, N = 17 (five clusters), and
    H = 512 and 513 on the two sides of ``cluster_plan``'s boundary between
    the cluster and the streaming route."""
    from tacotron_tpu_torch.config import AudioConfig
    from tacotron_tpu_torch.ops.kernels import gl_fused, griffin_lim, gru, ola

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
        frames = torch.from_numpy(rng.standard_normal(
            (B, T, cfg.n_fft)).astype(np.float32)).to(dev)
        ns = (T - 1) * cfg.hop_length if ns is None else ns
        got = ola.overlap_add_batched(frames, ns, cfg)
        want = ola.overlap_add_reference(frames, ns, cfg)
        err = float((got - want).abs().max())
        vec = ola.ola_plan(cfg.n_fft, cfg.hop_length, ns).vec
        require(err <= 1e-5, f"K2 at B={B} T={T} n_fft={cfg.n_fft} hop="
                f"{cfg.hop_length} samples={ns} (vec {vec}): {err}")
        n += 1
    for cfg, B, T in ((ref, 1, 7), (ref, 3, 130), (small, 2, 21)):
        Ta = gl_fused.frame_rows(T)
        mag = torch.from_numpy(rng.random(
            (B, Ta, cfg.num_freq)).astype(np.float32)).to(dev)
        mag[:, T:] = 0.0
        mag_e_s, mag_o_s = gl_fused.prepare_magnitudes(mag, cfg.n_fft)
        sig = gl_fused.initial_signal_blocks(mag_e_s, mag_o_s, T, cfg)
        got = gl_fused.gl_iteration(sig, mag_e_s, mag_o_s, T, cfg)
        want = gl_fused.gl_iteration_reference(sig, mag_e_s, mag_o_s, T, cfg)
        rel = float((got - want).abs().max() / want.abs().max())
        require(rel <= 2e-3, f"K1 at B={B} T={T} n_fft={cfg.n_fft}: {rel}")
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
        args = gru_inputs(dev, rng, T, N, D, H, lengths)
        got = gru.gru_sequence(*args)
        want = gru.gru_reference_scan(*args)
        err = float((got - want).abs().max())
        plan = gru.cluster_plan(N, H)
        require(err <= 1e-5, f"K4 at T={T} N={N} D={D} H={H} ({plan}): {err}")
        if lengths is not None:
            for i, length in enumerate(lengths):
                require(bool((got[length:, i] == 0).all()),
                        f"K4 emits past length {length}")
        n += 1
    torch.cuda.synchronize()
    return n


def check_waveforms(res, hop: int, what: str) -> float:
    """Finite, non-silent, of the length the trimmed frame ends give.
    Returns the seconds of audio."""
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


def check_k4(dev, synth, rng):
    """The fused GRU's path: capture the inputs of the encoder CBHG's BiGRU
    (4 sentences, with the speaker's ``encoder_rnn_init``) and of the
    post-net's BiGRU (200 frames) in a full-width decode, run both through
    ``bigru_from_params`` with the launch counter zeroed before and read
    after, and hold them and the weight gradients against the ``BiGRU``
    module.  Then time one direction at the post-net and at the encoder
    shape: whole, its input projection alone, and its latency floor."""
    from tacotron_tpu_torch.ops.kernels import gru
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

    def one_direction(name):
        mod, (xs, lengths, init), _ = captured[name]
        N, T, D = xs.shape
        cell = mod.fw
        mask = (torch.ones((T, N), device=dev) if lengths is None else
                (torch.arange(T, device=dev)[:, None]
                 < lengths[None]).float())
        h0 = (torch.zeros((N, cell.features), device=dev) if init is None
              else init[:, :cell.features].contiguous())
        return (xs.transpose(0, 1).contiguous(), h0,
                cell.gates.weight.t().contiguous(), cell.gates.bias.detach(),
                cell.candidate.weight.t().contiguous(),
                cell.candidate.bias.detach(), mask)

    def timings(name):
        """The direction's device times: the kernel (``ms``), the input
        projection alone, the recurrence's schedule with its products
        compiled out (the latency floor), and its plan."""
        args = [a.detach() for a in one_direction(name)]
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
    from tacotron_tpu_torch.train.driver import train
    from tacotron_tpu_torch.utils import read_metrics

    t_phase = time.perf_counter()
    cfg = train_config(decay_learning_rate_mode=1, test_interval=10,
                       checkpoint_interval=10)
    dirs = write_synthetic_corpus(os.path.join(tmp, "corpus"), cfg)
    a = check_train_step_card_vs_cpu(dev, dirs)
    b = check_features_card_vs_cpu(dev, dirs)

    # (c) the driver: 20 steps, then a resume to 30
    run = os.path.join(tmp, "run")
    samples = os.path.join(run, "samples")
    profile = os.path.join(tmp, "profile")
    t0 = time.perf_counter()
    state = train(run, dirs, cfg, num_steps=20, device=dev,
                  test_dump_dir=samples, profile_dir=profile)
    require(state.step == 20, f"(c) first run ended at {state.step}")
    state = train(run, dirs, cfg, num_steps=30, device=dev,
                  test_dump_dir=samples)
    wall_c = time.perf_counter() - t0
    require(state.step == 30, f"(c) resumed run ended at {state.step}")
    records = read_metrics(os.path.join(run, "metrics.jsonl"))
    trains = [r for r in records if r["kind"] == "train"]
    evals = [r for r in records if r["kind"] == "eval"]
    require([r["step"] for r in trains] == list(range(1, 31)),
            f"(c) train steps {[r['step'] for r in trains]}")
    require(all(set(r) == TRAIN_KEYS for r in trains),
            f"(c) metric keys {sorted(trains[0])}")
    require(all(np.isfinite(r["loss"]) for r in trains),
            "(c) a loss is not finite")
    require([r["step"] for r in evals] == [10, 20, 30],
            f"(c) eval steps {[r['step'] for r in evals]}")
    first = float(np.mean([r["loss"] for r in trains[:5]]))
    last = float(np.mean([r["loss"] for r in trains[25:]]))
    require(last < first, f"(c) loss did not fall: steps 1-5 {first}, "
                          f"26-30 {last}")
    require(checkpoint_steps(run) == [10, 20, 30],
            f"(c) checkpoints {checkpoint_steps(run)}")
    wavs = sorted(n for n in os.listdir(samples) if n.endswith(".wav"))
    require(wavs == [f"step{s:09d}.wav" for s in (10, 20, 30)],
            f"(c) sample dumps {wavs}")
    with open(os.path.join(profile, "summary.json")) as fh:
        prof = json.load(fh)
    require(prof["device_kernels"] > 0,
            "(c) the profiler saw no device kernel in steps 11-15")
    log(f"[train] (c) driver: 30 steps (20, then resumed to 30) in "
        f"{wall_c:.1f} s, loss {first:.4f} (steps 1-5) -> {last:.4f} "
        f"(26-30), evals at 10/20/30, checkpoints "
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
    log(f"[train] (e) Synthesizer.load(run dir) at step 30: one "
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
    log(f"[graphs] (b) 32 sentences in two chunks of one program: equal to "
        f"eager (launches {counts_e}, the same in the replays' trace); "
        f"replays out of capture order equal to eager")

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


def run_losses_and_params(run: str):
    """Per-step train losses and the last checkpoint's parameters."""
    import os

    from tacotron_tpu_torch.train.checkpoint import checkpoint_path
    from tacotron_tpu_torch.utils import read_metrics

    losses = [r["loss"] for r in read_metrics(
        os.path.join(run, "metrics.jsonl"), "train")]
    return losses, dict(np.load(checkpoint_path(run)))


def run_spread(a, b, steps: int = 30) -> tuple:
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
    """Phase 8 (d): ``train(..., prewarm=True)`` for 20 steps and a resume
    to 30 on phase 6's corpus, config and seed, against phase 6's eager run
    and one more eager run; then eager and replayed steps timed on the same
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
    eager_run = os.path.join(tmp, "run_eager2")
    graph_run = os.path.join(tmp, "run_graphs")
    profile = os.path.join(tmp, "profile_graphs")
    t0 = time.perf_counter()
    train(eager_run, dirs, cfg, num_steps=20, device=dev)
    train(eager_run, dirs, cfg, num_steps=30, device=dev)
    eager_s = time.perf_counter() - t0
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
        train(graph_run, dirs, cfg, num_steps=20, device=dev,
              profile_dir=profile, prewarm=True)
        state = train(graph_run, dirs, cfg, num_steps=30, device=dev,
                      prewarm=True)
    finally:
        TrainStep.__call__ = step_call
    graph_s = time.perf_counter() - t0
    require(state.step == 30, f"(d) graph run ended at {state.step}")
    ladder = {tuple(map(int, sh)) for sh in shapes}
    replayed = sum(n for _, n in steps_seen)
    require(len(steps_seen) == 30 and all(
        n == (sh in ladder) for sh, n in steps_seen) and replayed > 0,
        f"(d) steps (shape, replays) {steps_seen}: a step of a bucket shape "
        f"{sorted(ladder)} must replay once, any other none")
    with open(os.path.join(graph_run, "train.log")) as fh:
        text = fh.read()
    require(text.count(f"prewarming {len(shapes)} bucket program(s)") == 2
            and text.count("prewarm done") == 2,
            f"(d) the graph run's log lacks the prewarm lines for "
            f"{len(shapes)} shapes")
    first_run = run_losses_and_params(trained["run_dir"])
    eager2 = run_losses_and_params(eager_run)
    graphs = run_losses_and_params(graph_run)
    spread = run_spread(first_run, eager2)
    # against the nearer eager run: the eager runs themselves may differ
    # (atomics in the backward), and each step amplifies a difference
    to_eager = [run_spread(e, graphs) for e in (first_run, eager2)]
    err = tuple(min(d[i] for d in to_eager) for i in range(2))
    limits = [max(2 * x, 1e-5) for x in spread]
    require(err[0] <= limits[0] and err[1] <= limits[1],
            f"(d) graph run against eager: loss {to_eager[0][0]} / "
            f"{to_eager[1][0]}, parameters {to_eager[0][1]} / "
            f"{to_eager[1][1]}; eager against eager {spread}")
    losses = graphs[0]
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[25:]))
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
    out = dict(eager_runs_s=eager_s, graph_runs_s=graph_s,
               replayed_steps=replayed,
               eager_spread=spread, graph_err=err, loss_first5=first,
               loss_last5=last, bucket_shapes=len(shapes),
               replay_idle=prof["device_idle_share"],
               eager_idle=trained["profile"]["device_idle_share"],
               eager=eager_t, replay=replay_t, timing_graphs=n,
               timing_capture_s=capture_s)
    log(f"[graphs] (d) train(prewarm=True) 20 + resume to 30 on "
        f"{len(shapes)} bucket shapes ({replayed} of 30 steps replayed, "
        f"each step of a bucket shape): {graph_s:.1f} s against "
        f"{eager_s:.1f} s eager; loss {first:.4f} -> {last:.4f}; against "
        f"eager: loss {err[0]:.3e}, parameters {err[1]:.3e} (eager against "
        f"eager {spread[0]:.3e}, {spread[1]:.3e}); steps 11-15 idle "
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

        # (a) 10 steps plain, data-parallel, data-parallel replayed
        runs = {k: os.path.join(tmp, f"run_{k}")
                for k in ("plain", "dp", "dp_graphs")}
        steps_made = []
        prewarm = TrainStep.prewarm

        def keep(self, state, batches):
            steps_made.append(self)
            return prewarm(self, state, batches)

        t0 = time.perf_counter()
        train(runs["plain"], dirs, cfg, num_steps=10, device=dev)
        train(runs["dp"], dirs, cfg, num_steps=10, device=dev, plan=plan)
        TrainStep.prewarm = keep
        try:
            train(runs["dp_graphs"], dirs, cfg, num_steps=10, device=dev,
                  plan=plan, prewarm=True)
        finally:
            TrainStep.prewarm = prewarm
        wall_a = time.perf_counter() - t0
        replayed = sum(g.replays for s in steps_made
                       for g in s._graphs.values())
        require(len(steps_made) == 1 and replayed == 10,
                f"(a) {replayed} of 10 steps replayed a graph")
        got = {k: run_losses_and_params(v) for k, v in runs.items()}
        dp_err = run_spread(got["plain"], got["dp"], 10)
        graph_err = run_spread(got["dp"], got["dp_graphs"], 10)
        require(max(dp_err + graph_err) <= 1e-6,
                f"(a) data-parallel vs plain {dp_err}, replayed vs eager "
                f"{graph_err} (loss, parameters; limit 1e-6)")
        out.update(dp_vs_plain=dp_err, replay_vs_eager=graph_err,
                   wall_a_s=wall_a, runtime_info=info)
        log(f"[parallel] (a) NCCL world size 1, 10 steps at batch 16 "
            f"(corpus-max shape): data-parallel against plain: loss "
            f"{dp_err[0]:.3e}, parameters {dp_err[1]:.3e} (relative); "
            f"prewarmed (10 of 10 steps replayed) against eager: loss "
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
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    built = _build.build()
    log(f"[build] {time.perf_counter() - t0:.1f} s "
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

    rng = np.random.default_rng(0)
    kernels = [check_k1(dev, rng), check_k2(dev, rng), check_k3(dev, rng)]
    log(f"[kernel] {check_edge_shapes(dev, rng)} ragged shapes agree with "
        f"the plain versions")

    main = main_path(dev)
    for k, name in zip(kernels, ("K1", "K2", "K3")):
        k["launches"] = sum(c[name] for c in main["launches"].values())
        k["launches_by_call"] = {c: v[name]
                                 for c, v in main["launches"].items()}
    kernels.append(check_k4(dev, main["synth"], rng))
    with tempfile.TemporaryDirectory() as tmp:
        trained = train_phase(dev, tmp)
        timing = trained["timing"]
        log(f"[train] batch 16, full width: median "
            f"{timing['sec_per_step']:.4f} sec/step, "
            f"{timing['target_frames_per_s']:.1f} target frames/s, peak "
            f"memory {timing['peak_memory_gib']:.2f} GiB, device idle share "
            f"of steps 11-15 {trained['profile']['device_idle_share']:.4f} "
            f"on {card}")
        serve = serve_phase(dev, main["synth"], trained, tmp)
        t8 = time.perf_counter()
        graphs = serving_graphs(main, tmp)
        graphs["train"] = train_graphs(dev, trained, tmp)
        graphs["wall_s"] = time.perf_counter() - t8
        par = parallel_phase(dev, main, trained, tmp)
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
    for k in kernels:
        gemm = (f", cuBLAS products {k['gemm_library_ms']:.4f} ms, "
                f"{k['tflops']:.1f} TFLOP/s" if "tflops" in k else "")
        floor = (f", latency floor {k['floor_ms']:.4f} ms"
                 if "floor_ms" in k else "")
        log(f"[kernel] {k['name']} {k['shape']}: {k['ms']:.4f} ms, plain "
            f"{k['plain_ms']:.4f} ms, library {k['library_ms']}, bound "
            f"{k['bound_ms']:.4f} ms ({k['bound_by']}){floor}, max abs err "
            f"{k['max_abs_err']:.3e}, launches {k['launches']}{gemm}")
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
