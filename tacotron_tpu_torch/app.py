"""HTTP synthesis server, the port's counterpart of the root ``app.py``:

    python -m tacotron_tpu_torch.app --load_path logs/run_x --port 5100
    python -m tacotron_tpu_torch.app --random_init --device cpu

    GET  /generate?text=...&speaker_id=0  -> audio/wav
    POST /generate  (JSON or form body)   -> audio/wav (long documents
                                             beyond GET URL limits)
    GET  /, /static/...                    -> the repo's web/ player
    GET  /api/info, /healthz               -> JSON

Responses are cached by md5(text) per model and speaker; CORS headers are
always sent.  Runs on the card; ``--device cpu`` runs on the CPU instead.
``--prewarm`` captures the serving programs as CUDA graphs
(``Synthesizer.prewarm``, the root app's buckets and chunk sizes) before
the server takes requests.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import queue
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .config import Config
from .synth import Synthesizer
from .synth.synthesizer import save_wav
from .text import text_to_sequence

# POST /generate body cap: large enough for any real document (the long-text
# path handles multi-KB texts) while keeping a hostile multi-MB body from
# monopolizing the single synthesis worker.
MAX_BODY_BYTES = 1 << 20


class SynthWorker:
    """One worker that runs every synthesis, coalescing concurrent simple
    requests into one batched decode.

    CUDA accepts work from any thread, so the worker loop may run on any one
    thread (the CLI runs it on the main thread, beside the HTTP server's
    daemon thread); there is one worker so that requests meet in its queue.

    Dynamic batching: a 4-row ``synthesize`` costs far less than four 1-row
    calls (the decode and Griffin-Lim work is batched on the card while the
    launch overheads are paid once).  When several simple requests are
    queued at once, up to ``max_batch`` of them run as one ``synthesize``
    call, so under concurrent load each requester sees close to batch-1
    latency instead of its position in the queue times batch-1.  Long-text
    and attention-retry requests run alone (they batch their own chunks).
    ``max_batch=1`` disables coalescing.

    No batching window is added: a lone request runs at once, and
    coalescing emerges under load because requests that arrive while the
    worker is busy accumulate in the queue and are drained together on the
    next round.  Coalesced texts share one (token-bucket, steps) shape, so
    a short text grouped with a long one pays the longer decode.
    """

    def __init__(self, synth: Synthesizer, fast_vocoder: bool = True,
                 attention_retry: int = 0, wire_format: str = "int16",
                 max_batch: int = 4):
        self.synth = synth
        self.fast_vocoder = fast_vocoder
        self.attention_retry = attention_retry
        self.wire_format = wire_format
        self.long_threshold_tokens = 120
        self.max_batch = max(1, int(max_batch))
        self.batched_calls = 0  # observability: coalesced group count
        self.jobs: "queue.Queue" = queue.Queue()

    def _needs_chunking(self, text: str) -> bool:
        cfg = self.synth.config
        n = len(text_to_sequence(text, self.synth.cleaner_names(),
                                 symbol_set=cfg.data.symbol_set))
        return n > self.long_threshold_tokens

    def submit(self, text: str, speaker: int, timeout: float = 900.0):
        done = threading.Event()
        box = {}

        if self.attention_retry or self._needs_chunking(text):
            def job():
                try:
                    if self._needs_chunking(text):
                        # longer than one decode window fits: sentence-split,
                        # decode the chunks in one call, stitch with silence
                        long_kw = ({"retry_mode": self.attention_retry}
                                   if self.attention_retry else {})
                        out = self.synth.synthesize_long(
                            text, speaker_id=speaker,
                            robust=bool(self.attention_retry),
                            attention_trim=True, librosa_trim=True,
                            fast_vocoder=self.fast_vocoder,
                            wire_format=self.wire_format, **long_kw)
                        box["result"] = {"wavs": [out["wav"]],
                                         "chunks": out["chunks"]}
                    else:
                        box["result"] = self.synth.synthesize_robust(
                            texts=[text], speaker_ids=[speaker],
                            attention_trim=True, librosa_trim=True,
                            fast_vocoder=self.fast_vocoder,
                            wire_format=self.wire_format,
                            retry_mode=self.attention_retry)
                except Exception as e:
                    box["error"] = e
                finally:
                    done.set()

            self.jobs.put(("job", job))
        else:
            self.jobs.put(("simple", text, speaker, box, done))

        if not done.wait(timeout):
            raise TimeoutError("synthesis timed out")
        if "error" in box:
            raise box["error"]
        return box["result"]

    def _run_simple_batch(self, simples) -> None:
        """One batched synthesize over coalesced simple requests; each
        requester's box gets its own wav."""
        if len(simples) > 1:
            self.batched_calls += 1
        try:
            res = self.synth.synthesize(
                texts=[t for _, t, _, _, _ in simples],
                speaker_ids=[s for _, _, s, _, _ in simples],
                attention_trim=True, librosa_trim=True,
                fast_vocoder=self.fast_vocoder,
                wire_format=self.wire_format)
            for i, (_, _, _, box, _) in enumerate(simples):
                box["result"] = {"wavs": [res["wavs"][i]]}
        except Exception as e:
            # one exception per requester: several handler threads re-raise
            # at once, and raising one instance from several threads mutates
            # its shared __traceback__
            for _, _, _, box, _ in simples:
                err = RuntimeError(f"batched synthesis failed: {e}")
                err.__cause__ = e
                box["error"] = err
        finally:
            for _, _, _, _, done in simples:
                done.set()

    def run_once(self) -> None:
        """One scheduling round: pop the head job; if it is a simple
        request and coalescing is on, drain up to ``max_batch - 1`` more
        queued simple requests into the same batched decode.  Other jobs
        drained on the way run right after (they arrived later)."""
        item = self.jobs.get()
        if item[0] != "simple" or self.max_batch == 1:
            if item[0] == "simple":
                self._run_simple_batch([item])
            else:
                item[1]()
            return
        simples, others = [item], []
        while len(simples) < self.max_batch:
            try:
                nxt = self.jobs.get_nowait()
            except queue.Empty:
                break
            (simples if nxt[0] == "simple" else others).append(nxt)
        self._run_simple_batch(simples)
        for other in others:
            other[1]()

    def run_forever(self):
        while True:
            self.run_once()


# Fallback page when the web/ assets are absent; the full frontend lives in
# web/index.html and web/static/.
INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>tacotron_tpu_torch demo</title></head>
<body style="font-family:sans-serif;max-width:40em;margin:2em auto">
<h2>tacotron_tpu_torch synthesis demo</h2>
<input id="text" size="50" value="안녕하세요"/>
<input id="spk" type="number" value="0" min="0" style="width:4em"/>
<button onclick="go()">Synthesize</button>
<p id="status"></p><audio id="player" controls></audio>
<script>
function go() {
  const t = document.getElementById('text').value;
  const s = document.getElementById('spk').value;
  document.getElementById('status').textContent = 'generating...';
  const url = '/generate?text=' + encodeURIComponent(t) + '&speaker_id=' + s;
  const p = document.getElementById('player');
  p.src = url; p.onloadeddata = () => {
    document.getElementById('status').textContent = 'done'; p.play(); };
}
</script></body></html>
"""

WEB_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "web")

_STATIC_TYPES = {".html": "text/html", ".css": "text/css",
                 ".js": "application/javascript", ".svg": "image/svg+xml",
                 ".png": "image/png", ".ico": "image/x-icon"}


def make_handler(worker: SynthWorker, cache_dir: str, model_name: str):
    synth = worker.synth

    class Handler(BaseHTTPRequestHandler):
        def _cors(self):
            self.send_header("Access-Control-Allow-Origin", "*")

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self._cors()
            self.end_headers()
            self.wfile.write(body)

        def _send_error_json(self, code: int, message: str) -> None:
            self._send(code, json.dumps({"error": message}).encode(),
                       "application/json")

        def _send_static(self, rel_path: str) -> None:
            """Serve a file under web/ (path-traversal safe)."""
            root = os.path.realpath(WEB_ROOT)
            full = os.path.realpath(os.path.join(WEB_ROOT, rel_path))
            if not full.startswith(root + os.sep) and full != root:
                self._send(403, b"forbidden", "text/plain")
                return
            if not os.path.isfile(full):
                self._send(404, b"not found", "text/plain")
                return
            ctype = _STATIC_TYPES.get(os.path.splitext(full)[1],
                                      "application/octet-stream")
            with open(full, "rb") as fh:
                self._send(200, fh.read(), ctype)

        def do_GET(self):
            parsed = urllib.parse.urlparse(self.path)
            if parsed.path == "/":
                if os.path.isfile(os.path.join(WEB_ROOT, "index.html")):
                    self._send_static("index.html")
                else:
                    self._send(200, INDEX_HTML.encode(), "text/html")
                return
            if parsed.path.startswith("/static/"):
                self._send_static(parsed.path.lstrip("/"))
                return
            if parsed.path == "/api/info":
                self._send(200, json.dumps({
                    "model": model_name,
                    "num_speakers": synth.config.model.num_speakers,
                    "sample_rate": synth.config.audio.sample_rate,
                }).encode(), "application/json")
                return
            if parsed.path == "/healthz":
                self._send(200, b'{"ok": true}', "application/json")
                return
            if parsed.path != "/generate":
                self._send(404, b"not found", "text/plain")
                return
            q = urllib.parse.parse_qs(parsed.query)
            self._generate((q.get("text", [""])[0] or ""),
                           q.get("speaker_id", ["0"])[0])

        def do_POST(self):
            """POST /generate with a JSON or form body: the route for long
            documents beyond practical GET URL limits."""
            parsed = urllib.parse.urlparse(self.path)
            if parsed.path != "/generate":
                self._send(404, b"not found", "text/plain")
                return
            try:
                length = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                self._send_error_json(400, "bad Content-Length header")
                return
            if length > MAX_BODY_BYTES:
                # refuse before reading: a multi-MB body would tie up the
                # single synthesis worker for the whole request timeout
                self._send_error_json(
                    413, f"body too large (cap {MAX_BODY_BYTES} bytes)")
                return
            body = self.rfile.read(length) if length > 0 else b""
            ctype = (self.headers.get("Content-Type") or "").split(";")[0]
            try:
                if ctype == "application/json":
                    payload = json.loads(body.decode("utf-8"))
                    text = str(payload.get("text", ""))
                    speaker_raw = str(payload.get("speaker_id", 0))
                else:  # form-encoded (curl -d 'text=...')
                    q = urllib.parse.parse_qs(body.decode("utf-8"))
                    text = (q.get("text", [""])[0] or "")
                    speaker_raw = q.get("speaker_id", ["0"])[0]
            except (ValueError, UnicodeDecodeError):
                self._send_error_json(400, "unparseable request body")
                return
            self._generate(text, speaker_raw)

        def _generate(self, text: str, speaker_raw: str) -> None:
            text = text.strip()
            if not text:
                self._send_error_json(400, "missing text parameter")
                return
            try:
                speaker = int(speaker_raw)
            except ValueError:
                self._send_error_json(400, "speaker_id must be an integer")
                return
            num_speakers = synth.config.model.num_speakers
            if not 0 <= speaker < max(1, num_speakers):
                self._send_error_json(
                    400, f"speaker_id out of range [0, {num_speakers})")
                return

            digest = hashlib.md5(text.encode("utf-8")).hexdigest()
            wav_dir = os.path.join(cache_dir, model_name)
            os.makedirs(wav_dir, exist_ok=True)
            wav_path = os.path.join(wav_dir, f"{digest}.{speaker}.wav")
            if not os.path.exists(wav_path):
                try:
                    results = worker.submit(text, speaker)
                    save_wav(results["wavs"][0], wav_path,
                             synth.config.audio.sample_rate)
                except Exception as e:  # surface synthesis errors as JSON
                    self._send_error_json(500, str(e))
                    return
            with open(wav_path, "rb") as fh:
                self._send(200, fh.read(), "audio/wav")

        def log_message(self, fmt, *args):
            print(f"[http] {self.address_string()} {fmt % args}")

    return Handler


def prewarm_server(synth: Synthesizer, fast_vocoder: bool = True,
                   wire_format: str = "int16") -> int:
    """The server's ``--prewarm``: token buckets 32-128 and chunk sizes 1,
    2 and 4, which cover the coalesced short requests and the long-text
    route's chunks (larger fan-outs run eagerly).  Returns the number of
    programs."""
    return synth.prewarm(token_buckets=(32, 64, 96, 128),
                         batch_sizes=(1, 2, 4), fast_vocoder=fast_vocoder,
                         wire_format=wire_format)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="HTTP synthesis server")
    parser.add_argument("--load_path", default=None,
                        help="run dir of the port's trainer")
    parser.add_argument("--random_init", action="store_true")
    parser.add_argument("--port", type=int, default=5100)
    parser.add_argument("--cache_dir", default="web_cache")
    parser.add_argument("--classic_vocoder", action="store_true",
                        help="reference-parity 60-iteration Griffin-Lim "
                             "instead of the fast momentum preset")
    parser.add_argument("--attention_retry", type=int, default=0,
                        choices=[0, 1, 2],
                        help="re-decode utterances that fail the attention "
                             "health check with post-hoc manual attention "
                             "of this mode (0=off)")
    parser.add_argument("--prewarm", action="store_true",
                        help="capture the serving programs (token buckets "
                             "32-128 x chunk sizes 1/2/4, covering the "
                             "long-text route) as CUDA graphs before "
                             "accepting requests; other shapes run eagerly")
    parser.add_argument("--max_batch", type=int, default=4,
                        help="coalesce up to this many concurrent simple "
                             "requests into one batched decode (1 = off)")
    parser.add_argument("--wire_format", default="int16",
                        choices=["int16", "mulaw8"],
                        help="device->host audio encoding; mulaw8 halves "
                             "the bulk-fetch bytes (~38 dB quantization "
                             "SNR)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; raises without "
                             "a card)")
    args = parser.parse_args(argv)
    if not args.random_init and args.load_path is None:
        parser.error("--load_path required (or pass --random_init)")

    synth = Synthesizer(device=args.device)
    if args.random_init:
        synth.init_random(Config())
        model_name = "random"
    else:
        synth.load(args.load_path)
        model_name = os.path.basename(os.path.normpath(args.load_path))

    if args.prewarm:
        # before the worker and the HTTP thread exist: a capture refuses the
        # work of other threads in PyTorch's default capture mode
        t0 = time.perf_counter()
        n = prewarm_server(synth, fast_vocoder=not args.classic_vocoder,
                           wire_format=args.wire_format)
        print(f"[*] prewarmed {n} serving programs in "
              f"{time.perf_counter() - t0:.1f} s")

    worker = SynthWorker(synth, fast_vocoder=not args.classic_vocoder,
                         attention_retry=args.attention_retry,
                         wire_format=args.wire_format,
                         max_batch=args.max_batch)
    server = ThreadingHTTPServer(
        ("0.0.0.0", args.port),
        make_handler(worker, args.cache_dir, model_name))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    print(f"[*] serving on http://0.0.0.0:{args.port} (model {model_name}, "
          f"device {synth.device})")
    worker.run_forever()


if __name__ == "__main__":
    main()
