#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

1. Device: requires CUDA, prints the card's name and power limit, turns TF32
   off for matmuls and cuDNN convolutions.
2. Build: compiles every kernel of ``tacotron_tpu_torch/csrc`` with nvcc for
   sm_90a, one process per source, all at once.
3. Kernels: each kernel against its plain PyTorch version on the card, at
   the serving path's shapes, with CUDA-event device times (the host's
   launch cost excluded) of the kernel, the plain version and (where one
   exists) a single PyTorch library call; and again at ragged shapes
   (partial tiles, short stacks, a small geometry).
4. Main path at full width (``Config()``, Deep Voice 2 with two speakers,
   random weights from a seed): ``Synthesizer.synthesize`` on four sentences
   at 50 decode steps with the fast vocoder (200 frames: the fused
   Griffin-Lim kernel chain) and on two sentences at 200 steps with the
   classic vocoder (800 frames: matmul_half with the overlap-add kernel).
   The kernels' launch counters are zeroed before and read after, and the
   waveforms are checked.  The same weights on the CPU give the same 10-step
   greedy decode as on the card.
5. Prints the kernels line, the card line, and last the result line
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


def check_edge_shapes(dev, rng) -> int:
    """Both kernels against their plain versions at ragged shapes: frame
    counts that leave partial row tiles, stacks shorter than a frame's hop
    chunks, one item, and a small geometry (n_fft 256, hop 128)."""
    from tacotron_tpu_torch.config import AudioConfig
    from tacotron_tpu_torch.ops.kernels import gl_fused, ola

    small = AudioConfig(num_freq=129, sample_rate=16000, frame_shift_ms=8,
                        frame_length_ms=16)
    ref = AudioConfig()
    n = 0
    for cfg, B, T in ((ref, 1, 2), (ref, 3, 5), (ref, 2, 37), (small, 2, 21)):
        frames = torch.from_numpy(rng.standard_normal(
            (B, T, cfg.n_fft)).astype(np.float32)).to(dev)
        ns = (T - 1) * cfg.hop_length
        got = ola.overlap_add_batched(frames, ns, cfg)
        want = ola.overlap_add_reference(frames, ns, cfg)
        err = float((got - want).abs().max())
        require(err <= 1e-5, f"K2 at B={B} T={T} n_fft={cfg.n_fft}: {err}")
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
    from tacotron_tpu_torch.ops.kernels.ola import overlap_add_batched
    from tacotron_tpu_torch.synth import Synthesizer

    base = Config()
    cfg = base.replace(model=dataclasses.replace(
        base.model, model_type="deepvoice", num_speakers=2))
    synth = Synthesizer(device="cuda").init_random(cfg, seed=0)
    sr, hop = cfg.audio.sample_rate, cfg.audio.hop_length
    results = {}

    gl_iteration.launches = 0
    overlap_add_batched.launches = 0
    # (a) the serving setting: 4 sentences, 50 steps (200 frames -> fused
    # engine), momentum vocoder
    t0 = time.perf_counter()
    res_a = synth.synthesize(texts=KOREAN, speaker_ids=[0, 1, 0, 1],
                             max_steps=50, fast_vocoder=True,
                             librosa_trim=False)
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    k1_a, k2_a = gl_iteration.launches, overlap_add_batched.launches
    # (b) the 200-step rung: 800 frames -> matmul_half + overlap-add kernel
    t0 = time.perf_counter()
    res_b = synth.synthesize(texts=KOREAN[:2], speaker_ids=[1, 0],
                             max_steps=200, librosa_trim=False)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    k1, k2 = gl_iteration.launches, overlap_add_batched.launches
    require(k1_a > 0, "call (a) launched no fused Griffin-Lim kernel")
    require(k2 - k2_a > 0, "call (b) launched no overlap-add kernel")
    require(k1 == k1_a, "call (b) should not reach the fused engine")

    audio_a = check_waveforms(res_a, hop, "call (a)") / sr
    audio_b = check_waveforms(res_b, hop, "call (b)") / sr
    log(f"[main] call (a): 4 utterances x 50 steps, fast vocoder: "
        f"{wall_a:.3f} s wall, {audio_a:.3f} s audio, ends {res_a['ends']}, "
        f"K1 launches {k1_a}, K2 launches {k2_a}")
    log(f"[main] call (b): 2 utterances x 200 steps, classic vocoder: "
        f"{wall_b:.3f} s wall, {audio_b:.3f} s audio, ends {res_b['ends']}, "
        f"K2 launches {k2 - k2_a}")
    results.update(k1_launches=k1, k2_launches=k2, wall_a=wall_a,
                   wall_b=wall_b, audio_a=audio_a, audio_b=audio_b)

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

    rng = np.random.default_rng(0)
    kernels = [check_k1(dev, rng), check_k2(dev, rng)]
    log(f"[kernel] {check_edge_shapes(dev, rng)} ragged shapes agree with "
        f"the plain versions")
    for k in kernels:
        log(f"[kernel] {k['name']} {k['shape']}: {k['ms']:.4f} ms, plain "
            f"{k['plain_ms']:.4f} ms, library {k['library_ms']}, bound "
            f"{k['bound_ms']:.4f} ms ({k['bound_by']}), max abs err "
            f"{k['max_abs_err']:.3e}, max rel err {k['max_rel_err']:.3e}")

    main = main_path(dev)
    kernels[0]["launches"] = main["k1_launches"]
    kernels[1]["launches"] = main["k2_launches"]
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
