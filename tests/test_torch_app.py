"""HTTP-level tests of the port's synthesis server
(``tacotron_tpu_torch.app``): the cases of ``tests/test_app.py``.

The server is exercised end to end over a real socket with a fake
synthesizer on the port's ``Config`` (no device work): routing, CORS, input
validation, the md5(text) wav cache, static asset serving with
path-traversal protection, error surfacing, the long-text route, and the
worker's coalescing and error fan-out.  Two more cases: a real
``Synthesizer(device="cpu")`` at small widths serves a WAV, and the CLI's
``--prewarm`` calls ``Synthesizer.prewarm`` with the root app's arguments
before the worker starts.
"""

import http.client
import json
import os
import threading
import urllib.parse

from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from tacotron_tpu_torch import app as app_module
from tacotron_tpu_torch.config import Config


class FakeSynth:
    """Stands in for the port's Synthesizer: returns a short constant
    wav."""

    def __init__(self, num_speakers=4, fail=False):
        import dataclasses
        cfg = Config()
        self.config = cfg.replace(
            model=dataclasses.replace(cfg.model, num_speakers=num_speakers))
        self.fail = fail
        self.calls = 0

    def synthesize(self, texts, speaker_ids, **kwargs):
        self.calls += 1
        if self.fail:
            raise RuntimeError("synthetic failure")
        wav = 0.1 * np.sin(np.linspace(0, 40 * np.pi, 2400)).astype(
            np.float32)
        return {"wavs": [wav for _ in texts]}

    synthesize_robust = synthesize

    def cleaner_names(self):
        return [c.strip() for c in self.config.data.cleaners.split(",")]

    def synthesize_long(self, text, speaker_id=0, **kwargs):
        self.long_calls = getattr(self, "long_calls", 0) + 1
        wav = 0.1 * np.sin(np.linspace(0, 80 * np.pi, 4800)).astype(
            np.float32)
        return {"wav": wav, "chunks": [text], "parts": {"wavs": [wav]}}


@pytest.fixture()
def server(tmp_path):
    """A live server on an ephemeral port with a worker thread; yields
    (host, port, fake_synth)."""
    fake = FakeSynth()
    worker = app_module.SynthWorker(fake, fast_vocoder=True)
    httpd = ThreadingHTTPServer(
        ("127.0.0.1", 0),
        app_module.make_handler(worker, str(tmp_path / "cache"), "testmodel"))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    threading.Thread(target=worker.run_forever, daemon=True).start()
    try:
        yield ("127.0.0.1", httpd.server_address[1], fake,
               str(tmp_path / "cache"))
    finally:
        httpd.shutdown()


def _get(host, port, path):
    conn = http.client.HTTPConnection(host, port, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read()
    headers = dict(resp.getheaders())
    conn.close()
    return resp.status, headers, body


def test_index_and_info_and_health(server):
    host, port, fake, _ = server
    status, headers, body = _get(host, port, "/")
    assert status == 200
    assert headers["Content-Type"].startswith("text/html")
    assert b"<html" in body.lower() or b"<!doctype" in body.lower()
    # CORS on every response (the reference uses flask-cors)
    assert headers["Access-Control-Allow-Origin"] == "*"

    status, _, body = _get(host, port, "/api/info")
    info = json.loads(body)
    assert status == 200
    assert info["model"] == "testmodel"
    assert info["num_speakers"] == 4
    assert info["sample_rate"] == fake.config.audio.sample_rate

    status, _, body = _get(host, port, "/healthz")
    assert status == 200 and json.loads(body)["ok"] is True

    status, _, _ = _get(host, port, "/nope")
    assert status == 404


def test_generate_validation(server):
    host, port, _, _ = server
    status, _, body = _get(host, port, "/generate")
    assert status == 400 and "text" in json.loads(body)["error"]

    status, _, body = _get(host, port, "/generate?text=hi&speaker_id=abc")
    assert status == 400 and "integer" in json.loads(body)["error"]

    status, _, body = _get(host, port, "/generate?text=hi&speaker_id=99")
    assert status == 400 and "out of range" in json.loads(body)["error"]


def test_generate_synthesizes_and_caches(server):
    host, port, fake, cache_dir = server
    text = "안녕하세요"
    path = "/generate?" + urllib.parse.urlencode(
        {"text": text, "speaker_id": 1})
    status, headers, body = _get(host, port, path)
    assert status == 200
    assert headers["Content-Type"] == "audio/wav"
    assert body[:4] == b"RIFF"
    assert fake.calls == 1

    # cached by md5(text) per speaker: second request does not synthesize
    status2, _, body2 = _get(host, port, path)
    assert status2 == 200 and body2 == body
    assert fake.calls == 1

    import hashlib
    digest = hashlib.md5(text.encode("utf-8")).hexdigest()
    assert os.path.isfile(
        os.path.join(cache_dir, "testmodel", f"{digest}.1.wav"))

    # a different speaker is a different cache entry
    status3, _, _ = _get(host, port, "/generate?" + urllib.parse.urlencode(
        {"text": text, "speaker_id": 0}))
    assert status3 == 200 and fake.calls == 2


def test_generate_error_is_json_500(tmp_path):
    fake = FakeSynth(fail=True)
    worker = app_module.SynthWorker(fake)
    httpd = ThreadingHTTPServer(
        ("127.0.0.1", 0),
        app_module.make_handler(worker, str(tmp_path / "c"), "m"))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    threading.Thread(target=worker.run_forever, daemon=True).start()
    try:
        status, _, body = _get("127.0.0.1", httpd.server_address[1],
                               "/generate?text=hi")
        assert status == 500
        assert "synthetic failure" in json.loads(body)["error"]
    finally:
        httpd.shutdown()


def test_static_serving_and_traversal_guard(server):
    host, port, _, _ = server
    # the repo ships web/static assets; any one of them must be served
    status, headers, _ = _get(host, port, "/static/main.js")
    assert status == 200
    assert headers["Content-Type"] == "application/javascript"

    # path traversal out of web/ is refused (403 realpath guard or 404
    # after normalization — never file contents)
    status, _, body = _get(host, port, "/static/../../etc/passwd")
    assert status in (403, 404)
    assert b"root:" not in body


def test_generate_long_text_routes_through_chunking(server):
    """Texts longer than one decode window fits are served via
    synthesize_long (sentence-split + batched decode + stitch)."""
    host, port, fake, _ = server
    long_text = "안녕하세요 여러분 반갑습니다. " * 12  # >> 120 jamo tokens
    status, headers, body = _get(host, port, "/generate?" +
                                 urllib.parse.urlencode(
                                     {"text": long_text, "speaker_id": 0}))
    assert status == 200
    assert headers["Content-Type"] == "audio/wav"
    assert body[:4] == b"RIFF"
    assert getattr(fake, "long_calls", 0) == 1
    assert fake.calls == 0  # did not go through the plain path


def _post(host, port, path, body, ctype):
    conn = http.client.HTTPConnection(host, port, timeout=30)
    conn.request("POST", path, body=body, headers={"Content-Type": ctype})
    resp = conn.getresponse()
    out = (resp.status, resp.read())
    conn.close()
    return out


def test_generate_post_json_and_form(server):
    """POST /generate accepts JSON and form bodies — the route for texts
    too long for a GET URL; caching matches the GET path."""
    host, port, fake, _ = server
    long_text = "아주 긴 문서입니다. " * 200  # ~4 KB, beyond GET comfort
    status, body = _post(host, port, "/generate",
                         json.dumps({"text": long_text, "speaker_id": 1}),
                         "application/json")
    assert status == 200 and body[:4] == b"RIFF"
    assert getattr(fake, "long_calls", 0) == 1

    # same text via GET now hits the cache (no new synthesis)
    status2, _, body2 = _get(host, port, "/generate?" +
                             urllib.parse.urlencode(
                                 {"text": long_text, "speaker_id": 1}))
    assert status2 == 200 and body2 == body
    assert fake.long_calls == 1

    # form-encoded body works too
    status3, body3 = _post(host, port, "/generate",
                           urllib.parse.urlencode(
                               {"text": "안녕하세요", "speaker_id": 0}),
                           "application/x-www-form-urlencoded")
    assert status3 == 200 and body3[:4] == b"RIFF"

    # bad bodies are clean 400s
    status4, body4 = _post(host, port, "/generate", b"\xff\xfe not json",
                           "application/json")
    assert status4 == 400 and "unparseable" in json.loads(body4)["error"]
    status5, _ = _post(host, port, "/generate", b"", "application/json")
    assert status5 == 400


def test_post_header_and_body_limits(server):
    """POST /generate refuses malformed Content-Length with a clean 400
    (not a dropped connection) and oversized bodies with 413 before
    reading them — a multi-MB body must not monopolize the synthesis
    worker."""
    import socket

    host, port, _, _ = server

    def raw(request: bytes) -> bytes:
        with socket.create_connection((host, port), timeout=30) as s:
            s.sendall(request)
            out = b""
            while True:
                chunk = s.recv(4096)
                if not chunk:
                    break
                out += chunk
            return out

    resp = raw(b"POST /generate HTTP/1.1\r\nHost: t\r\n"
               b"Content-Type: application/json\r\n"
               b"Content-Length: banana\r\n\r\n")
    assert resp.split(b"\r\n", 1)[0].split()[1] == b"400"

    resp = raw(b"POST /generate HTTP/1.1\r\nHost: t\r\n"
               b"Content-Type: application/json\r\n"
               b"Content-Length: 10000000\r\n\r\n")
    assert resp.split(b"\r\n", 1)[0].split()[1] == b"413"


def test_worker_dynamic_batching_coalesces_concurrent_requests():
    """Concurrent simple requests run as ONE batched synthesize call (one
    fused-program dispatch) and each requester gets its own wav; long-text
    requests drained alongside still execute after the batch."""
    import time

    fake = FakeSynth()
    worker = app_module.SynthWorker(fake, max_batch=4)
    results = {}

    def client(i, text):
        results[i] = worker.submit(text, i % 2, timeout=30.0)

    long_text = "가나다라 마바사아 " * 40  # routes through synthesize_long
    threads = [threading.Thread(target=client, args=(i, f"짧은 문장 {i}"))
               for i in range(3)]
    # enqueue deterministically: the three simple requests must be queued
    # BEFORE the long-text job, otherwise the ('job', ...) tuple can land
    # at the queue head and run_once would execute only it (the simples
    # would still be blocked, fake.calls == 0 — a race, not a batch)
    for t in threads:
        t.start()
    deadline = 5.0
    while worker.jobs.qsize() < 3 and deadline > 0:
        time.sleep(0.01)
        deadline -= 0.01
    assert worker.jobs.qsize() == 3
    threads.append(threading.Thread(target=client, args=(3, long_text)))
    threads[-1].start()
    deadline = 5.0
    while worker.jobs.qsize() < 4 and deadline > 0:
        time.sleep(0.01)
        deadline -= 0.01
    assert worker.jobs.qsize() == 4
    worker.run_once()
    for t in threads:
        t.join(10)
    assert fake.calls == 1                    # 3 simples -> one call
    assert worker.batched_calls == 1
    assert getattr(fake, "long_calls", 0) == 1  # drained job still ran
    for i in range(3):
        assert len(results[i]["wavs"]) == 1
    assert len(results[3]["wavs"]) == 1


def test_worker_max_batch_1_preserves_per_request_calls():
    """max_batch=1 (coalescing off) keeps the original one-call-per-request
    behavior."""
    import time

    fake = FakeSynth()
    worker = app_module.SynthWorker(fake, max_batch=1)
    results = {}

    def client(i):
        results[i] = worker.submit(f"문장 {i}", 0, timeout=30.0)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    deadline = 5.0
    while worker.jobs.qsize() < 2 and deadline > 0:
        time.sleep(0.01)
        deadline -= 0.01
    worker.run_once()
    worker.run_once()
    for t in threads:
        t.join(10)
    assert fake.calls == 2
    assert worker.batched_calls == 0
    assert all(len(results[i]["wavs"]) == 1 for i in range(2))


def test_worker_batch_error_reaches_every_requester():
    """A failing batched decode surfaces the SAME error to every coalesced
    requester instead of hanging any of them."""
    import time

    fake = FakeSynth(fail=True)
    worker = app_module.SynthWorker(fake, max_batch=4)
    errors = {}

    def client(i):
        try:
            worker.submit(f"문장 {i}", 0, timeout=30.0)
        except Exception as e:
            errors[i] = e

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    deadline = 5.0
    while worker.jobs.qsize() < 3 and deadline > 0:
        time.sleep(0.01)
        deadline -= 0.01
    worker.run_once()
    for t in threads:
        t.join(10)
    assert len(errors) == 3
    assert all("synthetic failure" in str(e) for e in errors.values())


def test_real_synthesizer_serves_wav(tmp_path):
    """The server on a real ``Synthesizer(device="cpu")`` at small widths:
    GET /generate returns a 16 kHz WAV, and /api/info describes the
    model."""
    import dataclasses
    import wave

    from tacotron_tpu_torch.config import AudioConfig, ModelConfig
    from tacotron_tpu_torch.synth import Synthesizer
    from test_torch_params import SMALL

    cfg = Config(
        audio=AudioConfig(num_freq=129, sample_rate=16000, frame_shift_ms=8,
                          frame_length_ms=16, griffin_lim_iters=3),
        model=ModelConfig(**dict(SMALL, num_mels=10, num_freq=129,
                                 reduction_factor=4, model_type="deepvoice",
                                 num_speakers=2, max_iters=30)))
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, min_iters=1))
    synth = Synthesizer(device="cpu").init_random(cfg, seed=1)
    worker = app_module.SynthWorker(synth)
    httpd = ThreadingHTTPServer(
        ("127.0.0.1", 0),
        app_module.make_handler(worker, str(tmp_path / "c"), "small"))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    threading.Thread(target=worker.run_forever, daemon=True).start()
    try:
        port = httpd.server_address[1]
        status, headers, body = _get("127.0.0.1", port, "/generate?" +
                                     urllib.parse.urlencode(
                                         {"text": "안녕", "speaker_id": 1}))
        assert status == 200 and headers["Content-Type"] == "audio/wav"
        path = tmp_path / "out.wav"
        path.write_bytes(body)
        with wave.open(str(path)) as fh:
            assert fh.getframerate() == 16000
            assert fh.getnchannels() == 1 and fh.getsampwidth() == 2
            assert fh.getnframes() > 0
        info = json.loads(_get("127.0.0.1", port, "/api/info")[2])
        assert info == {"model": "small", "num_speakers": 2,
                        "sample_rate": 16000}
    finally:
        httpd.shutdown()


@pytest.mark.parametrize("flags,fast,wire", [
    ([], True, "int16"),
    (["--classic_vocoder", "--wire_format", "mulaw8"], False, "mulaw8")],
    ids=["default", "classic-mulaw8"])
def test_cli_prewarm_runs_before_the_worker(monkeypatch, capsys, flags,
                                            fast, wire):
    """``--prewarm`` calls ``Synthesizer.prewarm`` with the root app's token
    buckets, chunk sizes, vocoder and wire format, before the worker (and
    the HTTP thread) start."""
    events = []

    class Recorder(FakeSynth):
        def __init__(self, device=None):
            super().__init__(num_speakers=1)
            self.device = device

        def init_random(self, config):
            return self

        def prewarm(self, **kwargs):
            events.append(("prewarm", kwargs))
            return 21

    class StopWorker(app_module.SynthWorker):
        def run_forever(self):
            events.append(("worker", None))

    class NoServer:
        def __init__(self, *args):
            events.append(("server", None))

        def serve_forever(self):
            pass

    monkeypatch.setattr(app_module, "Synthesizer", Recorder)
    monkeypatch.setattr(app_module, "SynthWorker", StopWorker)
    monkeypatch.setattr(app_module, "ThreadingHTTPServer", NoServer)
    app_module.main(["--random_init", "--device", "cpu", "--prewarm",
                     *flags])
    assert [e[0] for e in events] == ["prewarm", "server", "worker"]
    assert events[0][1] == dict(token_buckets=(32, 64, 96, 128),
                                batch_sizes=(1, 2, 4), fast_vocoder=fast,
                                wire_format=wire)
    assert "prewarmed 21 serving programs" in capsys.readouterr().out
