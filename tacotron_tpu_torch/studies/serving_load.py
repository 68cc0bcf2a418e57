"""Measure the HTTP server under concurrent load: a port of the repo's
``scripts/serving_load.py``.

Drives the real ``app.SynthWorker`` and ``app.make_handler`` on a
``ThreadingHTTPServer`` bound to 127.0.0.1 with N closed-loop clients and
records per-request p50/p95/mean latency, throughput and the worker's
``batched_calls`` at each concurrency level, then repeats with
``max_batch=1`` (coalescing off) for the A/B.  Texts are unique per
request, so the wav cache never hits, and all share one token bucket, so
the comparison isolates scheduling from shape churn.

Besides the script's keys, each row holds the launches of the vocoder
kernels that its level's eager calls made (``k1_launches``, the fused
Griffin-Lim chain; ``k2_launches``, the overlap-add; ``k3_launches``, the
spectral step) and the graph replays
of its level (``replays``: a replay launches its kernels without the
wrappers, so their counts do not see it).  The load texts run 40-49 tokens,
whose 200-step budget (800 frames) is past the fused engine's 383 frames:
they vocode through the spectral-step kernel and the overlap-add kernel.

With ``--no_prewarm`` the calls run eagerly; by default the serving
programs are captured first (``Synthesizer.prewarm`` on the 32- and
64-token buckets at chunk sizes 1, 2 and 4), so every call replays::

    python -m tacotron_tpu_torch.studies.serving_load --out load.json
    python -m tacotron_tpu_torch.studies.serving_load --no_prewarm

``--device cpu`` runs it on the CPU (the default is the card).  The report
(``levels``, ``device``, ``model``, ``prewarm``) is printed as the last
line and written to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import itertools
import json
import tempfile
import threading
import time
import urllib.parse
import urllib.request
from http.server import ThreadingHTTPServer
from typing import Optional, Sequence

import numpy as np

from ..config import Config
from ..ops.kernels.gl_fused import gl_iteration
from ..ops.kernels.griffin_lim import spectral_step
from ..ops.kernels.ola import overlap_add_batched


def replay_count(synth) -> int:
    """Graph replays of ``synth`` so far."""
    return sum(g.replays for g in synth._graphs.values())


def _drive_level(worker, port: int, level: int, total: int,
                 counter) -> dict:
    """One closed-loop load level: ``level`` client threads issue
    ``total`` requests between them (each sends its next request as soon
    as the previous response lands), while this thread pumps the worker,
    as the app's main thread does."""
    per_client = total // level
    total = per_client * level
    latencies: list = []
    end_times: list = []
    lock = threading.Lock()
    barrier = threading.Barrier(level + 1)
    errors: list = []

    def client():
        try:
            barrier.wait()
            for _ in range(per_client):
                i = next(counter)
                text = urllib.parse.quote(
                    f"안녕하세요 순번 {i}번 문장입니다")
                t0 = time.perf_counter()
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/generate?text={text}"
                        f"&speaker_id=0", timeout=600) as resp:
                    body = resp.read()
                    assert resp.status == 200 and body, resp.status
                t1 = time.perf_counter()
                with lock:
                    latencies.append(t1 - t0)
                    end_times.append(t1)
        except Exception as e:  # noqa: BLE001 — recorded, fails the level
            with lock:
                errors.append(repr(e))

    threads = [threading.Thread(target=client) for _ in range(level)]
    for t in threads:
        t.start()
    bc0 = worker.batched_calls
    k1, k2 = gl_iteration.launches, overlap_add_batched.launches
    k3 = spectral_step.launches
    replays0 = replay_count(worker.synth)

    def waker():
        for t in threads:
            t.join()
        worker.jobs.put(("job", lambda: None))  # unblock the pump

    threading.Thread(target=waker, daemon=True).start()
    barrier.wait()
    t_start = time.perf_counter()
    while any(t.is_alive() for t in threads) or not worker.jobs.empty():
        worker.run_once()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(f"load level {level}: {errors[:3]}")
    wall = max(end_times) - t_start
    lat_ms = np.asarray(sorted(latencies)) * 1e3
    return {
        "concurrency": level,
        "requests": total,
        "p50_ms": round(float(np.percentile(lat_ms, 50)), 1),
        "p95_ms": round(float(np.percentile(lat_ms, 95)), 1),
        "mean_ms": round(float(lat_ms.mean()), 1),
        "throughput_rps": round(total / wall, 2),
        "batched_calls": worker.batched_calls - bc0,
        "max_batch": worker.max_batch,
        "k1_launches": gl_iteration.launches - k1,
        "k2_launches": overlap_add_batched.launches - k2,
        "k3_launches": spectral_step.launches - k3,
        "replays": replay_count(worker.synth) - replays0,
    }


def run_load_test(synth, levels=(1, 2, 4, 8), requests_per_level: int = 16,
                  max_batches=(4, 1), prewarm: bool = True) -> dict:
    """Drive the real app plumbing at each (max_batch, concurrency) point,
    pumping the worker on this thread.  Returns ``{"levels": [row, ...]}``
    with one row per point; rows with ``max_batch=1`` are the
    coalescing-off arm.  ``prewarm`` captures the serving programs first
    (before the server's threads exist: a capture refuses other threads'
    work)."""
    from .. import app as app_module

    if prewarm:
        # the load texts run 40-50 tokens -> the 64-token bucket; prewarm
        # 32 too so the warm set matches the app's own short-text rungs
        synth.prewarm(token_buckets=(32, 64), batch_sizes=(1, 2, 4),
                      fast_vocoder=True)
    worker = app_module.SynthWorker(synth, max_batch=max(max_batches))
    rows = []
    with tempfile.TemporaryDirectory(prefix="serving_load_") as cache_dir:
        handler_cls = app_module.make_handler(worker, cache_dir, "load")
        handler_cls.log_message = lambda *a, **k: None  # many requests
        server = ThreadingHTTPServer(("127.0.0.1", 0), handler_cls)
        port = server.server_address[1]
        threading.Thread(target=server.serve_forever, daemon=True).start()
        counter = itertools.count()
        try:
            for mb in max_batches:
                worker.max_batch = mb
                for level in levels:
                    row = _drive_level(worker, port, level,
                                       requests_per_level, counter)
                    rows.append(row)
                    print(f"[*] max_batch={mb} N={level}: "
                          f"p50 {row['p50_ms']:.0f} ms, "
                          f"p95 {row['p95_ms']:.0f} ms, "
                          f"{row['throughput_rps']:.2f} req/s, "
                          f"batched_calls {row['batched_calls']}, "
                          f"replays {row['replays']}", flush=True)
        finally:
            server.shutdown()
            server.server_close()
    return {"levels": rows}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from ..synth import Synthesizer
    from ..utils.misc import device_line

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--load_path", default=None,
                        help="run directory (default: random weights "
                             "from seed 0)")
    parser.add_argument("--levels", default="1,2,4,8")
    parser.add_argument("--requests_per_level", type=int, default=16)
    parser.add_argument("--out", default=None,
                        help="also write the report (JSON) here")
    parser.add_argument("--no_prewarm", action="store_true",
                        help="run every call eagerly (no CUDA graphs)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; raises "
                             "without one; cpu for the CPU)")
    args = parser.parse_args(argv)

    synth = Synthesizer(device=args.device)
    if args.load_path:
        synth.load(args.load_path)
    else:
        synth.init_random(Config())
    levels = tuple(int(x) for x in args.levels.split(","))
    t0 = time.perf_counter()
    report = run_load_test(synth, levels=levels,
                           requests_per_level=args.requests_per_level,
                           prewarm=not args.no_prewarm)
    report["device"] = device_line(synth.device)
    report["model"] = args.load_path or "random_init"
    report["prewarm"] = not args.no_prewarm
    report["wall_s"] = time.perf_counter() - t0
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2)
        print(f"[*] wrote {args.out}")
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
