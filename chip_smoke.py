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
7. Prints the kernels line, the card line, and last the result line
   ``{"ok": true, "device": {...}}``.

Any failure raises, exits nonzero and prints no result line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
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


def time_ms(fn, runs: int = 25, warmup: int = 3) -> float:
    """Median device time of ``fn()`` over ``runs`` CUDA-event timings,
    after warm-up.  A device-side spin is queued ahead of each timed run, so
    the host has enqueued all of ``fn``'s launches before the start event
    fires and the time excludes the host's launch cost; a run whose enqueue
    outlasts the spin raises instead of reporting a host-bound time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = _events()
    start.record()
    torch.cuda._sleep(SPIN_CYCLES)
    end.record()
    end.synchronize()
    spin_ms = start.elapsed_time(end)
    times = []
    for _ in range(runs):
        start, end = _events()
        t0 = time.perf_counter()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        if host_ms >= spin_ms:
            raise RuntimeError(f"enqueue took {host_ms:.3f} ms, longer than "
                               f"the {spin_ms:.3f} ms spin ahead of it")
        times.append(start.elapsed_time(end))
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
    results.update(launches=launches, synth=synth)

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


def train_phase(dev) -> dict:
    """Phase 6: training, (a)-(e) of the module docstring.  Every check
    raises; nothing here falls back to the CPU but (a)'s and (b)'s
    reference runs."""
    import os
    import tempfile

    from tacotron_tpu_torch.data.synthetic import write_synthetic_corpus
    from tacotron_tpu_torch.ops.kernels.gl_fused import gl_iteration
    from tacotron_tpu_torch.synth import Synthesizer
    from tacotron_tpu_torch.train.checkpoint import checkpoint_steps
    from tacotron_tpu_torch.train.driver import train
    from tacotron_tpu_torch.utils import read_metrics

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
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
            "wall_s": wall}


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
    trained = train_phase(dev)
    timing = trained["timing"]
    log(f"[train] batch 16, full width: median {timing['sec_per_step']:.4f} "
        f"sec/step, {timing['target_frames_per_s']:.1f} target frames/s, "
        f"peak memory {timing['peak_memory_gib']:.2f} GiB, device idle "
        f"share of steps 11-15 {trained['profile']['device_idle_share']:.4f}"
        f" on {card}")
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
    sys.exit(main())
