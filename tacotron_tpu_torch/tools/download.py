"""Dataset / pretrained-model acquisition (network-gated): a copy of the
JAX package's ``tools/download.py``.

Successors to the reference's download tooling:

- :func:`download_checkpoint` — fetch the published ``son``/``park``
  pretrained tarballs from Google Drive (the reference's ``download.py:82-123``)
  and unpack them for :mod:`tacotron_tpu_torch.compat` import.
- :func:`download_clips` — cut per-utterance clips out of remote media per
  a ``metadata.csv`` of ``path|url|title|start|end`` rows (the park/moon
  dataset recipe, the reference's ``datasets/park/download.py:26-53``),
  delegating media fetch to ``yt-dlp``/``youtube-dl`` and trimming with
  ``ffmpeg``.

Everything here needs network/binaries that air-gapped environments lack;
each entry point checks its prerequisites and fails with an actionable
message instead of an ImportError.
"""

from __future__ import annotations

import argparse
import csv
import os
import shutil
import subprocess
import tarfile
import urllib.parse
import urllib.request
from typing import Dict, Optional, Sequence

PRETRAINED = {
    # file ids from the reference's download.py:82-88
    "son": "0B_7wC0GyeTUHRlZzLXdxLXlPVUU",
    "park": "0B_7wC0GyeTUHcmJMRlZzLS1HbU0",
}


def _gdrive_url(file_id: str) -> str:
    return ("https://docs.google.com/uc?export=download&id="
            + urllib.parse.quote(file_id))


def download_checkpoint(name: str, out_dir: str = "checkpoints") -> str:
    """Fetch + unpack a published pretrained model; returns its directory."""
    if name not in PRETRAINED:
        raise ValueError(f"unknown pretrained model {name!r}; "
                         f"choose from {sorted(PRETRAINED)}")
    os.makedirs(out_dir, exist_ok=True)
    tar_path = os.path.join(out_dir, f"{name}.tar.gz")
    if not os.path.exists(tar_path):
        url = _gdrive_url(PRETRAINED[name])
        try:
            with urllib.request.urlopen(url, timeout=60) as resp, \
                    open(tar_path, "wb") as out:
                shutil.copyfileobj(resp, out)
        except OSError as e:
            raise RuntimeError(
                f"cannot download {name} checkpoint (network unavailable?): "
                f"{e}. Fetch {url} manually and place the tarball at "
                f"{tar_path}.") from e
    with tarfile.open(tar_path) as tar:
        tar.extractall(out_dir, filter="data")
    return os.path.join(out_dir, name)


def _find_binary(*names: str) -> Optional[str]:
    for name in names:
        path = shutil.which(name)
        if path:
            return path
    return None


def download_clips(metadata_path: str, out_dir: Optional[str] = None) -> int:
    """``path|url|title|start|end`` rows -> trimmed wav clips."""
    fetcher = _find_binary("yt-dlp", "youtube-dl")
    ffmpeg = _find_binary("ffmpeg", "avconv")
    if fetcher is None or ffmpeg is None:
        raise RuntimeError(
            "download_clips needs yt-dlp/youtube-dl and ffmpeg on PATH")
    base = out_dir or os.path.dirname(os.path.abspath(metadata_path))
    os.makedirs(base, exist_ok=True)
    fetched: Dict[str, str] = {}
    count = 0
    with open(metadata_path) as fh:
        for row in csv.reader(fh, delimiter="|"):
            if len(row) < 5:
                continue
            rel_path, url, _title, start, end = row[:5]
            clip_path = os.path.join(base, rel_path)
            if os.path.exists(clip_path):
                count += 1
                continue
            if url not in fetched:
                media = os.path.join(base, f"_media_{len(fetched)}.m4a")
                subprocess.run([fetcher, "-x", "-o", media, url], check=True)
                fetched[url] = media
            os.makedirs(os.path.dirname(clip_path) or ".", exist_ok=True)
            subprocess.run(
                [ffmpeg, "-y", "-i", fetched[url], "-ss", start, "-to", end,
                 "-ar", "24000", "-ac", "1", clip_path],
                check=True, capture_output=True)
            count += 1
    return count


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="fetch datasets / models")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p1 = sub.add_parser("checkpoint")
    p1.add_argument("name", choices=sorted(PRETRAINED))
    p1.add_argument("--out_dir", default="checkpoints")
    p2 = sub.add_parser("clips")
    p2.add_argument("metadata_path")
    p2.add_argument("--out_dir", default=None)
    args = parser.parse_args(argv)
    if args.cmd == "checkpoint":
        print(download_checkpoint(args.name, args.out_dir))
    else:
        print(f"[*] {download_clips(args.metadata_path, args.out_dir)} clips")


if __name__ == "__main__":
    main()
