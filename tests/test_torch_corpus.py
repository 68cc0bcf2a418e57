"""The port's corpus-construction chain against the JAX package's, on the
CPU, on inputs made from a seed with numpy: ``tools/silence``, ``asr``,
``alignment``, ``book_align``, ``duration``, ``download``, ``scrape`` and
``data/builder.py``.

Tolerances: these are host-side copies on the same numpy/scipy code, so
every result is held equal (intervals, strings, JSON, recorded calls, file
bytes, ``BuildStats``, tokens), except the builder's ``linear`` and ``mel``
arrays, held within 1e-6 absolute (bit-equal is expected).  The JAX
builder runs in-process (``num_workers=1``) throughout: its pool forks,
and forking this test process, which runs JAX's threads, can deadlock; its
output does not depend on the worker count.
"""

import dataclasses
import io
import json
import os
import tarfile

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tacotron_tpu import tools as jtools
from tacotron_tpu.data import DataFeeder as JaxFeeder
from tacotron_tpu.data import builder as jbuilder
from tacotron_tpu.dsp import host as jdsp
from tacotron_tpu.tools import alignment as jalign
from tacotron_tpu.tools import asr as jasr
from tacotron_tpu.tools import book_align as jbook
from tacotron_tpu.tools import download as jdownload
from tacotron_tpu.tools import duration as jduration
from tacotron_tpu.tools import scrape as jscrape
from tacotron_tpu.tools import silence as jsilence
from tacotron_tpu_torch import tools as ttools
from tacotron_tpu_torch.config import Config as TorchConfig
from tacotron_tpu_torch.data import DataFeeder as PortFeeder
from tacotron_tpu_torch.data import builder as tbuilder
from tacotron_tpu_torch.tools import alignment as talign
from tacotron_tpu_torch.tools import asr as tasr
from tacotron_tpu_torch.tools import book_align as tbook
from tacotron_tpu_torch.tools import download as tdownload
from tacotron_tpu_torch.tools import duration as tduration
from tacotron_tpu_torch.tools import scrape as tscrape
from tacotron_tpu_torch.tools import silence as tsilence
from test_data import _tiny_config
from test_tools import (ARTICLE_XML, LISTING_XML, MASTER_M3U8, MEDIA_M3U8,
                        RSS_XML)

SR = 24000


def _port(cfg):
    return TorchConfig.from_json(cfg.to_json())


def test_tools_export_the_jax_names():
    assert ttools.__all__ == jtools.__all__


# ------------------------------------------------------------------ silence

def _long_recording(seed: int, n_utts: int = 3) -> np.ndarray:
    """Tone-band utterances of 3.5-5 s between silences of 0.5-1 s, with a
    quiet breath inside the second utterance."""
    rng = np.random.default_rng(seed)
    parts = [np.zeros(int(SR * rng.uniform(0.5, 1.0)), np.float32)]
    for k in range(n_utts):
        t = np.arange(int(SR * rng.uniform(3.5, 5.0))) / SR
        env = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(1, 3) * t)
        utt = env * sum(rng.uniform(0.1, 0.25)
                        * np.sin(2 * np.pi * rng.uniform(150, 900) * t)
                        for _ in range(3))
        if k == 1:
            mid = len(utt) // 2
            utt[mid:mid + SR // 5] *= 0.02
        parts += [utt.astype(np.float32),
                  np.zeros(int(SR * rng.uniform(0.5, 1.0)), np.float32)]
    return np.concatenate(parts)


@pytest.mark.parametrize("top_db,frame,hop", [(40.0, 1024, 256),
                                              (30.0, 2048, 512),
                                              (40.0, 128, 32)])
def test_detect_nonsilent_matches_jax(top_db, frame, hop):
    for seed in range(3):
        y = _long_recording(seed)
        want = jsilence.detect_nonsilent(y, top_db, frame, hop)
        got = tsilence.detect_nonsilent(y, top_db, frame, hop)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tsilence.remove_breath(y),
                                  jsilence.remove_breath(y))
    silent = np.zeros(SR, np.float32)
    assert tsilence.detect_nonsilent(silent).shape == \
        jsilence.detect_nonsilent(silent).shape == (0, 2)


@pytest.mark.parametrize("breath_removal", [True, False])
def test_split_on_silence_matches_jax(tmp_path, breath_removal):
    cfg = _tiny_config().audio
    outs = {}
    for name, mod in (("jax", jsilence), ("port", tsilence)):
        d = tmp_path / name
        d.mkdir()
        jdsp.save_audio(_long_recording(7, 4), str(d / "long.wav"), cfg)
        paths = mod.split_on_silence(str(d / "long.wav"),
                                     breath_removal=breath_removal,
                                     pre_silence_length=0.1,
                                     post_silence_length=0.2)
        outs[name] = {os.path.basename(p): open(p, "rb").read()
                      for p in paths}
    assert len(outs["port"]) == 4
    assert outs["port"] == outs["jax"]


# ---------------------------------------------------------------- alignment

ALIGN_CASES = {
    "ko-confident": ("오늘은 날씨가 정말 좋습니다",
                     ["오늘은 날씨가 정말 좋습니다", "내일은 비가 온다고 합니다"]),
    "ko-trimmed": ("오늘은 날씨가 정말",
                   ["그리고 오늘은 날씨가 정말 좋았습니다", "내일은 비가 옵니다"]),
    "ko-merged-first-word": ("그리고오늘은 날씨가 좋았습니다",
                             ["그리고 오늘은 날씨가 좋았습니다",
                              "어제는 눈이 왔습니다"]),
    "ko-unrelated": ("전혀 관계 없는 문장입니다",
                     ["오늘은 날씨가 정말 좋습니다", "내일은 비가 온다고 합니다"]),
    "ko-tie": ("서울역에서 부산역까지 걸립니다",
               ["서울역에서 부산역까지 갑니다", "서울역에서 부산역까지 옵니다"]),
    "ko-book": ("어느 날 커다란 호랑이가 나타나 소년에게 말을 걸었습니다",
                ["옛날 옛적에 한 소년이 살았습니다", "어느 날 커다란 곰이 나타나",
                 "소년에게 말을 걸었습니다", "둘은 곧 친구가 되었습니다"]),
    "en-confident": ("the quick brown fox jumps over the lazy dog",
                     ["The quick brown fox jumps over the lazy dog.",
                      "A stitch in time saves nine."]),
    "en-asr-error": ("the quick brown box jumps over the lazy",
                     ["The quick brown fox jumps over the lazy dog!",
                      "The lazy dog sleeps all day."]),
    "en-no-overlap": ("completely different words here",
                      ["The quick brown fox jumps over the lazy dog.",
                       "A stitch in time saves nine."]),
    "en-single-word": ("hello", ["Hello?", "Goodbye."]),
    "empty": ("", ["오늘은 날씨가 정말 좋습니다"]),
}


@pytest.mark.parametrize("case", sorted(ALIGN_CASES))
def test_text_alignment_matches_jax(tmp_path, case):
    recognition, candidates = ALIGN_CASES[case]
    for c in candidates:
        assert talign.similarity(c, recognition) == \
            jalign.similarity(c, recognition)
        assert talign.search_optimal(c, recognition) == \
            jalign.search_optimal(c, recognition)
    for threshold in (0.5, 0.8):
        assert talign.align_text(recognition, candidates, threshold) == \
            jalign.align_text(recognition, candidates, threshold)
    assert talign.align_text(recognition, []) == \
        jalign.align_text(recognition, [])

    # align_batch: a plain and a list-valued hypothesis, written files
    rec = {"a.wav": recognition, "b.wav": [recognition], "c.wav": []}
    (tmp_path / "recognition.json").write_text(
        json.dumps(rec, ensure_ascii=False), encoding="utf-8")
    (tmp_path / "script.txt").write_text(
        "\n".join(['"' + candidates[0] + '"'] + candidates[1:] + [""]),
        encoding="utf-8")
    outs = {}
    for name, mod in (("jax", jalign), ("port", talign)):
        out_path = str(tmp_path / f"{name}.json")
        got = mod.align_batch(str(tmp_path / "recognition.json"),
                              str(tmp_path / "script.txt"), out_path, 0.5)
        outs[name] = (got, open(out_path, "rb").read())
    assert outs["port"] == outs["jax"]

    book = " ".join(candidates)
    for ngram, threshold in ((2, 0.3), (1, 0.6)):
        assert tbook.align_book(rec, book, ngram, threshold) == \
            jbook.align_book(rec, book, ngram, threshold)
    tidx, jidx = tbook.BookIndex(book, 2), jbook.BookIndex(book, 2)
    assert tidx.locate(recognition) == jidx.locate(recognition)
    assert dict(tidx.index) == dict(jidx.index)


@settings(max_examples=200, deadline=None, database=None)
@given(st.text(max_size=40), st.text(max_size=40))
def test_similarity_and_plain_text_match_jax(a, b):
    assert talign.plain_text(a) == jalign.plain_text(a)
    assert talign.similarity(a, b) == jalign.similarity(a, b)
    assert talign.add_punctuation(a) == jalign.add_punctuation(a)


def test_alignment_and_book_clis_match_jax(tmp_path, capsys):
    recognition, candidates = ALIGN_CASES["ko-book"]
    rec_path = tmp_path / "recognition.json"
    rec_path.write_text(json.dumps({"x.wav": recognition},
                                   ensure_ascii=False), encoding="utf-8")
    (tmp_path / "script.txt").write_text("\n".join(candidates),
                                         encoding="utf-8")
    (tmp_path / "book.txt").write_text(" ".join(candidates),
                                       encoding="utf-8")
    outs = {}
    for name, a, b in (("jax", jalign, jbook), ("port", talign, tbook)):
        a.main(["--recognition_path", str(rec_path), "--script_path",
                str(tmp_path / "script.txt"), "--out_path",
                str(tmp_path / f"{name}_a.json")])
        b.main(["--recognition_path", str(rec_path), "--book_path",
                str(tmp_path / "book.txt"), "--out_path",
                str(tmp_path / f"{name}_b.json")])
        outs[name] = (capsys.readouterr().out,
                      (tmp_path / f"{name}_a.json").read_bytes(),
                      (tmp_path / f"{name}_b.json").read_bytes())
    assert outs["port"] == outs["jax"]


# ---------------------------------------------------------------------- asr

def test_transcribe_batch_matches_jax(tmp_path, capsys, monkeypatch):
    """The same fake recognizer (a digest of the 16 kHz samples it is
    given) over the same clips: equal JSON, equal sidecars, the same
    skipped clip (over ``MAX_CLIP_SECONDS``), the cache honoured."""
    cfg = _tiny_config().audio
    rng = np.random.default_rng(3)
    clips = [(0.3 * rng.standard_normal(int(SR * s))).astype(np.float32)
             for s in (0.5, 1.25, 1.5)]
    outs = {}
    for name, mod in (("jax", jasr), ("port", tasr)):
        d = tmp_path / name
        d.mkdir()
        for i, clip in enumerate(clips):
            jdsp.save_audio(clip, str(d / f"c{i}.wav"), cfg)
        (d / "c1.txt").write_text("캐시된 전사", encoding="utf-8")
        calls = []

        def fake(audio_16k, language, calls=calls):
            calls.append((len(audio_16k), language))
            return f"{language} {len(audio_16k)} {float(audio_16k.sum()):.6f}"

        monkeypatch.setattr(mod, "MAX_CLIP_SECONDS", 1.0)
        got = mod.transcribe_batch(str(d / "*.wav"), language="ko-KR",
                                   recognize_fn=fake)
        again = mod.transcribe_batch(str(d / "*.wav"), str(d / "again.json"),
                                     recognize_fn=fake)
        assert again == got
        outs[name] = dict(
            results={os.path.basename(k): v for k, v in got.items()},
            calls=calls,
            sidecars={p: (d / p).read_text(encoding="utf-8")
                      for p in sorted(os.listdir(d)) if p.endswith(".txt")},
            json=(d / "recognition.json").read_text(encoding="utf-8")
            .replace(str(d), "<dir>"),
            printed=capsys.readouterr().out.replace(str(d), "<dir>"))
    assert outs["port"]["results"] == {"c0.wav": outs["port"]["results"]
                                       ["c0.wav"], "c1.wav": "캐시된 전사"}
    assert "skip" in outs["port"]["printed"]
    assert outs["port"] == outs["jax"]


def test_default_recognizer_needs_the_cloud_client():
    with pytest.raises(RuntimeError) as want:
        jasr._default_recognize(np.zeros(16), "ko-KR")
    with pytest.raises(RuntimeError) as got:
        tasr._default_recognize(np.zeros(16), "ko-KR")
    assert str(got.value) == str(want.value)


# ----------------------------------------------------------------- duration

def _mp3_frame(b2=0x90):
    return bytes([0xFF, 0xFB, b2, 0x00]) + bytes(413)


def _id3(n):
    return b"ID3" + bytes([3, 0, 0]) + bytes(
        [(n >> 21) & 0x7F, (n >> 14) & 0x7F, (n >> 7) & 0x7F, n & 0x7F])


def _mvhd_file(version, timescale, duration):
    import struct
    if version == 1:
        body = (bytes([1]) + bytes(3) + bytes(16) + struct.pack(">I",
                timescale) + struct.pack(">Q", duration) + bytes(80))
    else:
        body = (bytes([0]) + bytes(3) + bytes(8) + struct.pack(">I",
                timescale) + struct.pack(">I", duration) + bytes(80))
    mvhd = struct.pack(">I4s", 8 + len(body), b"mvhd") + body
    free = struct.pack(">I4s", 16, b"free") + bytes(8)
    moov = struct.pack(">I4s", 8 + len(free) + len(mvhd), b"moov") + \
        free + mvhd
    return struct.pack(">I4s", 16, b"ftyp") + b"M4A " + bytes(4) + moov


def _xing_file():
    import struct
    xing = bytes(32) + b"Xing" + struct.pack(">I", 1) + struct.pack(">I", 77)
    frame = bytes([0xFF, 0xFB, 0x90, 0x00]) + xing + bytes(417 - 4 - len(xing))
    return _id3(1000) + bytes(1000) + frame + _mp3_frame() * 5


DURATION_FILES = {
    "cbr.mp3": lambda: _mp3_frame() * 12,
    "mpeg2.mp3": lambda: (bytes([0xFF, 0xF3, 0x80, 0x00]) + bytes(204)) * 6,
    "xing.mp3": _xing_file,
    "false_sync.mp3": lambda: (bytes([0xFF, 0xFB, 0x20, 0x00]) + bytes(200)
                               + _mp3_frame() * 8),
    "v0.m4a": lambda: _mvhd_file(0, 1000, 2500),
    "v1.mp4": lambda: _mvhd_file(1, 44100, 3 * 44100 + 7),
    "garbage.mp3": lambda: bytes(300),
    "nomvhd.m4a": lambda: bytes(24),
}


@pytest.mark.parametrize("name", sorted(DURATION_FILES))
def test_header_durations_match_jax(tmp_path, name):
    path = tmp_path / name
    path.write_bytes(DURATION_FILES[name]())
    try:
        want = jduration.audio_duration(str(path))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tduration.audio_duration(str(path))
        assert str(got.value) == str(e)
        return
    assert tduration.audio_duration(str(path)) == want


def test_wav_durations_and_totals_match_jax(tmp_path, capsys):
    cfg = dataclasses.replace(_tiny_config().audio, sample_rate=8000)
    for spk, n in (("a", 3), ("b", 2)):
        (tmp_path / spk).mkdir()
        for i in range(n):
            jdsp.save_audio(np.zeros(8000 * (i + 1) + 123, np.float32),
                            str(tmp_path / spk / f"u{i}.wav"), cfg)
    (tmp_path / "a" / "broken.wav").write_bytes(b"RIFF")
    (tmp_path / "b" / "x.mp3").write_bytes(_mp3_frame() * 3)
    paths = sorted(str(p) for p in tmp_path.rglob("*.*"))
    assert tduration.get_durations(paths, print_detail=True) == \
        jduration.get_durations(paths, print_detail=True)
    patterns = [str(tmp_path / "a" / "*.wav"), str(tmp_path / "b" / "*")]
    assert tduration.dataset_totals(patterns) == \
        jduration.dataset_totals(patterns)
    capsys.readouterr()
    printed = []
    for mod in (jduration, tduration):
        mod.main(patterns + ["--detail"])
        printed.append(capsys.readouterr().out)
    assert printed[1] == printed[0] and "total: 6 files" in printed[1]


# ---------------------------------------------------- downloads and scraping

def _news_fetch(fetched):
    def fetch(url):
        fetched.append(url)
        if "PGI=1" in url:
            return LISTING_XML
        if "PGI=" in url:
            return "<root></root>"
        if "NID=NB11515152" in url:
            return ARTICLE_XML
        if "NID=" in url:
            return "<root><article_contents>x</article_contents></root>"
        if url.endswith("master.m3u8"):
            return MASTER_M3U8
        return MEDIA_M3U8
    return fetch


def _scrape_run(mod, base, monkeypatch):
    fetched, ran = [], []
    monkeypatch.setattr(mod.shutil, "which", lambda name: "/usr/bin/" + name)
    monkeypatch.setattr(mod.subprocess, "run",
                        lambda argv, **kw: ran.append((argv, kw)))
    s = mod.NewsApiScraper("http://api.example.com/news",
                           list_params={"NJC": "NJC300"},
                           article_params={"NJC": "NJC400"},
                           fetch=_news_fetch(fetched),
                           fetch_bytes=lambda url: b"TS" + url.encode())
    out = {"ids": s.collect_news_ids(), "article": s.fetch_article(
        "NB11515152"), "segments": s.resolve_segments(
        "http://vod.example.com/master.m3u8")}
    with pytest.raises(ValueError) as e:
        s.fetch_article("NB0")
    out["error"] = str(e.value)
    paths = s.download("NB11515152", str(base / "news"))
    out["download"] = {k: os.path.relpath(v, base) for k, v in paths.items()}
    out["files"] = {str(p.relative_to(base)): p.read_bytes()
                    for p in sorted(base.rglob("*")) if p.is_file()}
    feed = mod.PodcastFeed("http://feed.example.com/rss",
                           fetch=lambda url: fetched.append(url) or RSS_XML,
                           fetch_bytes=lambda url: b"AUDIO:" + url.encode())
    items = feed.parse_items(RSS_XML)
    out["items"] = items
    out["selected"] = feed.select_episodes(items, mod.KBS_YUINNA[
        "accept_list"], date_token_index=2)
    out["podcast"] = [os.path.relpath(p, base) for p in feed.download_all(
        str(base / "pod"), mod.KBS_YUINNA["accept_list"], max_num=2)]
    out["tags"] = (mod.extract_tagged(ARTICLE_XML, "VOD_PATH"),
                   mod.split_sentences("하나. 둘! 셋?\n넷"),
                   mod.parse_m3u8(MEDIA_M3U8, "http://h/a/b.m3u8"))
    out["fetched"] = fetched
    out["ran"] = [([a.replace(str(base), "<base>") for a in argv], kw)
                  for argv, kw in ran]
    return out


def test_scrape_matches_jax(tmp_path, monkeypatch):
    outs = {}
    for name, mod in (("jax", jscrape), ("port", tscrape)):
        (tmp_path / name).mkdir()
        outs[name] = _scrape_run(mod, tmp_path / name, monkeypatch)
    assert outs["port"]["ids"] == ["NB11515152", "NB11515153"]
    assert len(outs["port"]["ran"]) == 1
    assert outs["port"] == outs["jax"]
    assert tscrape.JTBC_NEWSROOM == jscrape.JTBC_NEWSROOM
    assert tscrape.KBS_YUINNA == jscrape.KBS_YUINNA


class _Response(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _tarball() -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        for member, data in (("son/checkpoint", b"model.ckpt-1\n"),
                             ("son/model.ckpt-1.index", b"\x00\x01")):
            info = tarfile.TarInfo(member)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    return buf.getvalue()


def _download_run(mod, base, monkeypatch):
    out, urls, ran = {}, [], []
    payload = _tarball()

    def urlopen(url, timeout):
        urls.append((url, timeout))
        if "park" in url or "0B_7wC0GyeTUHcmJMRlZzLS1HbU0" in url:
            raise OSError("offline")
        return _Response(payload)

    monkeypatch.setattr(mod.urllib.request, "urlopen", urlopen)
    got = mod.download_checkpoint("son", str(base / "ckpt"))
    out["son"] = os.path.relpath(got, base)
    out["extracted"] = sorted(str(p.relative_to(base))
                              for p in (base / "ckpt").rglob("*"))
    for name in ("park", "nobody"):
        with pytest.raises((RuntimeError, ValueError)) as e:
            mod.download_checkpoint(name, str(base / "ckpt"))
        out[name] = (type(e.value).__name__,
                     str(e.value).replace(str(base), "<base>"))

    monkeypatch.setattr(mod, "_find_binary", lambda *names: None)
    with pytest.raises(RuntimeError) as e:
        mod.download_clips(str(base / "meta.csv"))
    out["no_binaries"] = str(e.value)

    monkeypatch.setattr(mod, "_find_binary",
                        lambda *names: "/opt/bin/" + names[0])
    monkeypatch.setattr(mod.subprocess, "run",
                        lambda argv, **kw: ran.append((argv, kw)))
    (base / "clips").mkdir()
    (base / "clips" / "have.wav").write_bytes(b"")
    (base / "meta.csv").write_text(
        "clips/a.wav|http://v/1|t|0:01|0:03\n"
        "clips/have.wav|http://v/1|t|0:04|0:05\n"
        "short|row\n"
        "sub/b.wav|http://v/2|t|1.5|2.5\n"
        "clips/c.wav|http://v/1|t|7|9\n")
    out["clips"] = mod.download_clips(str(base / "meta.csv"))
    out["clips_out_dir"] = mod.download_clips(str(base / "meta.csv"),
                                              str(base / "elsewhere"))
    out["urls"] = urls
    out["ran"] = [([a.replace(str(base), "<base>") for a in argv], kw)
                  for argv, kw in ran]
    return out


def test_download_matches_jax(tmp_path, monkeypatch):
    outs = {}
    for name, mod in (("jax", jdownload), ("port", tdownload)):
        (tmp_path / name).mkdir()
        outs[name] = _download_run(mod, tmp_path / name, monkeypatch)
    port = outs["port"]
    assert port["son"] == os.path.join("ckpt", "son")
    # the first call fetches 2 media and cuts 3 clips (one exists); the
    # second, into an empty dir, fetches 2 and cuts 4
    assert port["clips"] == port["clips_out_dir"] == 4
    assert len(port["ran"]) == (2 + 3) + (2 + 4)
    assert port == outs["jax"]
    assert tdownload.PRETRAINED == jdownload.PRETRAINED


# ------------------------------------------------------------------ builder

TEXTS = ["안녕하세요 만나서 반갑습니다", "오늘은 날씨가 정말 좋네요",
         "음성 합성 시스템을 시험합니다", "스물 네 시간 열두 달",
         "어제는 비가 조금 내렸어요", "내일 아침 일찍 만나요"]


def _write_clips(root, seed, n=6):
    """``n`` short seeded clips, a ``metadata.csv`` with relative paths and
    an ``alignment.json`` with each form the ASR chain writes (plain,
    one-candidate list, two-candidate list) and a missing clip."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    cfg = _tiny_config().audio
    rows, align = [], {}
    for i in range(n):
        t = np.arange(int(SR * rng.uniform(0.3, 0.7))) / SR
        wav = (0.4 * np.sin(2 * np.pi * rng.uniform(150, 600) * t)
               + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
        name = f"utt{i:03d}.wav"
        jdsp.save_audio(wav, os.path.join(root, name), cfg)
        text = TEXTS[i % len(TEXTS)]
        rows.append(f"{name}|{text}")
        align[os.path.join(root, name)] = (
            text if i % 3 == 0 else [text] if i % 3 == 1
            else [text, "다른 후보"])
    align[os.path.join(root, "missing.wav")] = "없는 파일"
    with open(os.path.join(root, "metadata.csv"), "w") as fh:
        fh.write("\n".join(rows) + "\n\n")
    with open(os.path.join(root, "alignment.json"), "w") as fh:
        json.dump(align, fh, ensure_ascii=False)
    return root


def _built(data_dir):
    out = {}
    for name in sorted(os.listdir(data_dir)):
        with np.load(os.path.join(data_dir, name)) as d:
            out[name] = {k: d[k] for k in d.files}
    return out


def _assert_corpora_equal(got, want):
    assert sorted(got) == sorted(want)
    for name, arrays in want.items():
        assert sorted(got[name]) == sorted(arrays), name
        for key, w in arrays.items():
            g = got[name][key]
            assert g.dtype == w.dtype and g.shape == w.shape, (name, key)
            if key in ("linear", "mel"):
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("level,workers", [(0, 1), (1, 2), (2, 1),
                                           (0, 2), (1, 1), (2, 2)])
def test_build_from_path_matches_jax(tmp_path, level, workers):
    root = _write_clips(str(tmp_path / "spk"), seed=level)
    base = _tiny_config()
    cfg = base.replace(train=dataclasses.replace(
        base.train, ignore_recognition_level=level))
    # one pool per test: spawned workers take seconds to import scipy
    for meta, n in (("metadata.csv", 1), ("alignment.json", workers)):
        path = os.path.join(root, meta)
        want = jbuilder.build_from_path(path, cfg, f"jax_{meta}",
                                        num_workers=1)
        got = tbuilder.build_from_path(path, _port(cfg), f"port_{meta}",
                                       num_workers=n)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.hours == want.hours
        _assert_corpora_equal(_built(os.path.join(root, f"port_{meta}")),
                              _built(os.path.join(root, f"jax_{meta}")))
    # the policy of each level, on alignment.json's six clips
    assert got.num_built == {0: 6, 1: 4, 2: 2}[level]
    assert tbuilder.read_metadata(path) == jbuilder.read_metadata(path)
    with pytest.raises(ValueError, match="unknown metadata format"):
        tbuilder.read_metadata(os.path.join(root, "utt000.wav"))


def test_process_utterance_reuses_or_rebuilds(tmp_path):
    """An existing file is reused (its frame count returned, nothing
    written); one without ``wav`` is rebuilt for ``store_waveform``; an
    unreadable one is rebuilt."""
    root = _write_clips(str(tmp_path), seed=5, n=1)
    audio = _port(_tiny_config()).audio
    wav = os.path.join(root, "utt000.wav")
    out = str(tmp_path / "u.npz")
    n = tbuilder.process_utterance(wav, out, [1, 2, 3], 1.0, audio)
    mtime = os.stat(out).st_mtime_ns
    assert tbuilder.process_utterance(wav, out, [9], 0.5, audio) == n
    assert os.stat(out).st_mtime_ns == mtime
    assert tbuilder.process_utterance(wav, out, [9], 0.5, audio, True) == n
    with np.load(out) as d:
        assert d["tokens"].tolist() == [9] and d["wav"].dtype == np.int16
    with open(out, "wb") as fh:
        fh.write(b"not a zip")
    assert tbuilder.process_utterance(wav, out, [4], 1.0, audio) == n
    jout = str(tmp_path / "j.npz")
    jbuilder.process_utterance(wav, jout, [4], 1.0, _tiny_config().audio)
    _assert_corpora_equal({"u": dict(np.load(out))},
                          {"u": dict(np.load(jout))})


def test_builder_cli_store_waveform_matches_jax(tmp_path, capsys):
    root = _write_clips(str(tmp_path / "spk"), seed=9)
    meta = os.path.join(root, "metadata.csv")
    cfg_path = str(tmp_path / "config.json")
    with open(cfg_path, "w") as fh:
        fh.write(_tiny_config().to_json())
    printed = {}
    for name, mod in (("jax", jbuilder), ("port", tbuilder)):
        mod.main([meta, "--data_dirname", name, "--num_workers",
                  "1" if name == "jax" else "2", "--config", cfg_path,
                  "--store_waveform"])
        printed[name] = capsys.readouterr().out
    assert printed["port"] == printed["jax"]
    assert printed["port"].startswith("[*] built 6 utterances")
    port = _built(os.path.join(root, "port"))
    assert all("wav" in arrays for arrays in port.values())
    _assert_corpora_equal(port, _built(os.path.join(root, "jax")))


def test_port_feeder_reads_the_built_corpus(tmp_path):
    """Two speakers built by the port read as one batch, equal to the JAX
    feeder's batch of the JAX-built corpus."""
    cfg = _tiny_config()
    dirs = {"jax": [], "port": []}
    for spk in range(2):
        root = _write_clips(str(tmp_path / f"spk{spk}"), seed=20 + spk)
        meta = os.path.join(root, "metadata.csv")
        jbuilder.build_from_path(meta, cfg, "jax", num_workers=1)
        tbuilder.build_from_path(meta, _port(cfg), "port", num_workers=1)
        for name in dirs:
            dirs[name].append(os.path.join(root, name))
    want = next(JaxFeeder(dirs["jax"], cfg, batch_size=4, n_test=1,
                          seed=1).batches())
    got = next(PortFeeder(dirs["port"], _port(cfg), batch_size=4, n_test=1,
                          seed=1).batches())
    assert got.inputs.shape[0] == 4
    for field, g, w in zip(want._fields, got, want):
        if w is None:
            assert g is None, field
        else:
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=0, atol=1e-6, err_msg=field)
