"""The traced window of a ``--trace 1`` run: a ``torch.profiler`` trace of
the device between two synchronizations, reduced to what the metric
readers and the result's ``breakdown`` read.

The arithmetic is frozen here (the port's ``synth/profile.py`` has the
same, which a later change to the program may alter): every device
activity of the trace is an interval; ``busy`` is their union, overlaps
counted once; the idle gaps between busy intervals are charged to the
host span of the benchmark (``record_function`` names starting with
``bench.``) that was open at the gap's midpoint.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

#: the port's hand-written kernels, by a part of their names
OWN_KERNELS = ("gl_frame_uv", "gl_dft_project", "gl_idft_window",
               "gl_ola_norm", "ola_centered", "gl_spectral_cast",
               "gl_spectral_dft", "gl_spectral_idft", "gru_input_proj",
               "gru_cluster", "gru_recurrent")

#: the kernel groups of K1 (the fused Griffin-Lim iteration), K2 (the
#: overlap-add) and K3 (the spectral step)
K1_GROUPS = ("gl_frame_uv", "gl_dft_project", "gl_idft_window",
             "gl_ola_norm")
K2_GROUPS = ("ola_centered",)
K3_GROUPS = ("gl_spectral_dft", "gl_spectral_idft", "gl_spectral_cast")


def kernel_group(name: str) -> str:
    for own in OWN_KERNELS:
        if own in name:
            return own
    low = name.lower()
    if "memcpy" in low or "memset" in low:
        return "copies and fills"
    if "nccl" in low:
        return "collectives (NCCL)"
    if any(k in low for k in ("gemm", "gemv", "xmma", "cutlass", "matmul",
                              "nvjet")):
        return "matrix products (cuBLAS)"
    if "fft" in low:
        return "FFT (cuFFT)"
    if "conv" in low or "cudnn" in low:
        return "convolutions (cuDNN)"
    if "elementwise" in low or "vectorized" in low or "reduce" in low:
        return "elementwise and reductions"
    return "other"


def union_us(intervals: List[Tuple[float, float]]) -> List[Tuple[float,
                                                                 float]]:
    """The union of [start, end) intervals, as disjoint sorted ones."""
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def summarize(device_events: List[Tuple[str, float, float]],
              host_spans: List[Tuple[str, float, float]],
              window: Tuple[float, float]) -> dict:
    """``device_events`` (name, start_us, end_us) and the benchmark's host
    spans inside ``window`` (start_us, end_us) -> busy and window seconds,
    device seconds and launches by group, and idle seconds by host span."""
    w0, w1 = window
    by_group: Dict[str, float] = {}
    launches: Dict[str, int] = {}
    spans = []
    for name, s, e in device_events:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        g = kernel_group(name)
        by_group[g] = by_group.get(g, 0.0) + (e - s) / 1e6
        launches[g] = launches.get(g, 0) + 1
        spans.append((s, e))
    merged = union_us(spans)
    idle: Dict[str, float] = {}
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    host = sorted(host_spans, key=lambda h: h[1])
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        # the innermost (latest-starting) benchmark span open at mid
        name = "outside the benchmark's spans"
        for hname, hs, he in host:
            if hs > mid:
                break
            if he >= mid:
                name = hname
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    return {"busy_s": sum(e - s for s, e in merged) / 1e6,
            "window_s": (w1 - w0) / 1e6,
            "device_s_by_group": by_group,
            "launches_by_group": launches,
            "idle_s_by_span": idle}


class TraceWindow:
    """``start()`` and ``stop()`` a profiler trace with the device
    synchronized at both ends; ``summary`` then holds :func:`summarize`'s
    dict, or None if nothing was traced.  The profiler's raw events are
    read as they are: ``torch.profiler.profile`` would first build an
    event object for each, which takes seconds a call of ~20k kernels."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.summary: Optional[dict] = None

    def start(self) -> None:
        from torch._C._profiler import _ExperimentalConfig
        from torch.autograd import (ProfilerActivity, ProfilerConfig,
                                    ProfilerState, _enable_profiler,
                                    _prepare_profiler)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        activities = {ProfilerActivity.CPU}
        if self.device.type == "cuda":
            activities.add(ProfilerActivity.CUDA)
        config = ProfilerConfig(ProfilerState.KINETO, False, False, False,
                                False, False, _ExperimentalConfig())
        _prepare_profiler(config, activities)
        _enable_profiler(config, activities)
        self._window = torch.profiler.record_function("bench.window")
        self._window.__enter__()

    def stop(self) -> None:
        from torch.autograd import _disable_profiler
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._window.__exit__(None, None, None)
        results = _disable_profiler()
        device, host = [], []
        for evt in results.events():
            start = evt.start_ns() / 1e3
            end = start + evt.duration_ns() / 1e3
            if evt.name().startswith("bench."):
                # a benchmark span, which the profiler also draws as a
                # range on the device: host only
                if evt.device_type() == torch.autograd.DeviceType.CPU:
                    host.append((evt.name(), start, end))
            elif evt.device_type() == torch.autograd.DeviceType.CUDA:
                device.append((evt.name(), start, end))
        window = [h for h in host if h[0] == "bench.window"]
        if not window:
            self.summary = None
            return
        self.summary = summarize(device, host, window[0][1:])


def breakdown(summary: dict) -> dict:
    """The result line's ``breakdown``: the ten device groups and the ten
    host spans with the most seconds."""
    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:10]
    return {"device_ops": top(summary["device_s_by_group"]),
            "idle_gaps": top(summary["idle_s_by_span"])}
