"""Per-file / per-dataset audio duration accounting: a copy of the JAX
package's ``tools/duration.py`` (the reference's ``audio/get_duration.py``).

Reads container headers directly (stdlib ``wave`` for wav, minimal
frame/box parsers for mp3 and m4a/mp4 — the formats the reference's
TinyTag handled, ``get_duration.py:14-56``) instead of pulling a tag
library; prints per-dataset totals.
"""

from __future__ import annotations

import argparse
import os
import struct
import wave
from collections import defaultdict
from glob import glob
from typing import Dict, Iterable, Optional, Sequence, Tuple


def wav_duration(path: str) -> float:
    try:
        with wave.open(path, "rb") as w:
            return w.getnframes() / w.getframerate()
    except Exception:
        from scipy.io import wavfile
        rate, data = wavfile.read(path)
        return len(data) / rate


# MPEG audio frame-header tables (MPEG-1/2, Layer III)
_MP3_BITRATES_V1 = (0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192,
                    224, 256, 320, 0)
_MP3_BITRATES_V2 = (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128,
                    144, 160, 0)
_MP3_RATES = {3: (44100, 48000, 32000),   # MPEG-1
              2: (22050, 24000, 16000),   # MPEG-2
              0: (11025, 12000, 8000)}    # MPEG-2.5


def mp3_duration(path: str) -> float:
    """mp3 duration from the first frame header: Xing/Info frame count
    when present (VBR-exact), else a CBR estimate from the bitrate."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(10)
        start = 0
        if head[:3] == b"ID3":  # skip ID3v2 tag (syncsafe 28-bit size) —
            # seek past it however large (cover art can run to megabytes)
            tag = ((head[6] & 0x7F) << 21 | (head[7] & 0x7F) << 14
                   | (head[8] & 0x7F) << 7 | (head[9] & 0x7F))
            start = 10 + tag
        f.seek(start)
        data = f.read(256 * 1024)
    pos = 0
    start_offset = start
    while pos + 4 <= len(data):
        b0, b1, b2, _ = data[pos:pos + 4]
        if b0 == 0xFF and (b1 & 0xE0) == 0xE0:
            version = (b1 >> 3) & 0x3      # 3=MPEG1, 2=MPEG2, 0=MPEG2.5
            layer = (b1 >> 1) & 0x3        # 1 = Layer III
            br_idx = (b2 >> 4) & 0xF
            sr_idx = (b2 >> 2) & 0x3
            if (version != 1 and layer == 1 and 0 < br_idx < 15
                    and sr_idx < 3):
                rates = _MP3_RATES[version]
                sample_rate = rates[sr_idx]
                bitrates = (_MP3_BITRATES_V1 if version == 3
                            else _MP3_BITRATES_V2)
                bitrate = bitrates[br_idx] * 1000
                samples_per_frame = 1152 if version == 3 else 576
                # Reject false syncs (0xFF Ex bytes inside tag padding or
                # album art would otherwise yield a wrong bitrate): the
                # candidate must be followed by another frame header at
                # pos + frame length.  Accept when the next frame lies
                # beyond the read buffer (single-frame / tiny files).
                padding = (b2 >> 1) & 0x1
                frame_len = (samples_per_frame // 8 * bitrate
                             // sample_rate + padding)
                nxt = pos + frame_len
                if nxt + 2 <= len(data) and not (
                        data[nxt] == 0xFF
                        and (data[nxt + 1] & 0xE0) == 0xE0):
                    pos += 1
                    continue
                # Xing/Info header (VBR): exact frame count
                window = data[pos:pos + 200]
                for magic in (b"Xing", b"Info"):
                    i = window.find(magic)
                    if i >= 0 and len(window) >= i + 12:
                        flags = struct.unpack(">I", window[i + 4:i + 8])[0]
                        if flags & 1:
                            frames = struct.unpack(
                                ">I", window[i + 8:i + 12])[0]
                            return frames * samples_per_frame / sample_rate
                return (size - start_offset - pos) * 8.0 / bitrate
        pos += 1
    raise ValueError(f"{path}: no MPEG audio frame found")


def m4a_duration(path: str) -> float:
    """m4a/mp4 duration from the ``moov/mvhd`` box (version 0 or 1)."""
    with open(path, "rb") as f:
        def walk(end: int) -> Optional[float]:
            while f.tell() + 8 <= end:
                header = f.read(8)
                if len(header) < 8:
                    return None
                box_size, box_type = struct.unpack(">I4s", header)
                box_start = f.tell() - 8
                if box_size == 1:  # 64-bit size
                    box_size = struct.unpack(">Q", f.read(8))[0]
                elif box_size == 0:
                    box_size = end - box_start
                if box_type == b"moov":
                    got = walk(box_start + box_size)
                    if got is not None:
                        return got
                elif box_type == b"mvhd":
                    version = f.read(1)[0]
                    f.read(3)  # flags
                    if version == 1:
                        f.read(16)  # 64-bit created/modified
                        timescale = struct.unpack(">I", f.read(4))[0]
                        duration = struct.unpack(">Q", f.read(8))[0]
                    else:
                        f.read(8)
                        timescale = struct.unpack(">I", f.read(4))[0]
                        duration = struct.unpack(">I", f.read(4))[0]
                    return duration / timescale
                f.seek(box_start + box_size)
            return None

        got = walk(os.path.getsize(path))
    if got is None:
        raise ValueError(f"{path}: no mvhd box found")
    return got


def audio_duration(path: str) -> float:
    """Duration of a wav/mp3/m4a/mp4 file by extension (wav fallback).

    Raw ADTS ``.aac`` streams are deliberately NOT claimed: they carry no
    container duration and would need per-frame scanning."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".mp3":
        return mp3_duration(path)
    if ext in (".m4a", ".mp4", ".mov"):
        return m4a_duration(path)
    return wav_duration(path)


def get_durations(paths: Iterable[str],
                  print_detail: bool = False) -> Dict[str, float]:
    """{path: seconds}; skips unreadable files."""
    out = {}
    for path in paths:
        try:
            out[path] = audio_duration(path)
            if print_detail:
                print(f"  {path}: {out[path]:.2f}s")
        except Exception:
            continue
    return out


def dataset_totals(patterns: Sequence[str]) -> Dict[str, Tuple[int, float]]:
    """{pattern: (num_files, total_seconds)}."""
    totals = defaultdict(lambda: (0, 0.0))
    for pattern in patterns:
        durations = get_durations(sorted(glob(pattern)))
        totals[pattern] = (len(durations), sum(durations.values()))
    return dict(totals)


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="audio duration accounting")
    parser.add_argument("patterns", nargs="+",
                        help="glob(s) of wav files, one per dataset")
    parser.add_argument("--detail", action="store_true")
    args = parser.parse_args(argv)
    grand_n, grand_s = 0, 0.0
    for pattern, (n, seconds) in dataset_totals(args.patterns).items():
        print(f"[*] {pattern}: {n} files, {seconds / 3600:.2f} hours")
        grand_n += n
        grand_s += seconds
    print(f"[*] total: {grand_n} files, {grand_s / 3600:.2f} hours")


if __name__ == "__main__":
    main()
