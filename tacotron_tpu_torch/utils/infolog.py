"""Run logging: stdout + append-only logfile + optional webhook.

A copy of the JAX package's ``utils/infolog.py``: ``init``/``log``, with the
webhook posted from a daemon thread through stdlib urllib, off by default.
"""

from __future__ import annotations

import atexit
import json
import threading
import urllib.request
from datetime import datetime
from typing import Optional

_format = "%Y-%m-%d %H:%M:%S.%f"
_file = None
_run_name = None
_webhook_url = None
_lock = threading.Lock()


def init(filename: str, run_name: str,
         webhook_url: Optional[str] = None) -> None:
    global _file, _run_name, _webhook_url
    _close_logfile()
    _file = open(filename, "a", encoding="utf-8")
    _file.write("\n-----------------------------------------------------\n")
    _file.write(f"Starting new training run: {run_name}\n")
    _file.write("-----------------------------------------------------\n")
    _run_name = run_name
    _webhook_url = webhook_url


def log(msg: str, notify: bool = False) -> None:
    print(msg, flush=True)
    with _lock:
        if _file is not None:
            _file.write(f"[{datetime.now().strftime(_format)[:-3]}]  {msg}\n")
            _file.flush()
    if notify and _webhook_url:
        threading.Thread(target=_send_webhook, args=(msg,),
                         daemon=True).start()


def _send_webhook(msg: str) -> None:
    try:
        payload = json.dumps(
            {"text": f"*{_run_name}*: {msg}"}).encode("utf-8")
        req = urllib.request.Request(
            _webhook_url, data=payload,
            headers={"Content-Type": "application/json"})
        urllib.request.urlopen(req, timeout=10)
    except Exception:
        pass  # a notification failure must never kill training


def _close_logfile() -> None:
    global _file
    if _file is not None:
        _file.close()
        _file = None


atexit.register(_close_logfile)
