"""Site-specific corpus scrapers (network-gated, parsing offline-testable):
a copy of the JAX package's ``tools/scrape.py``.

Successors to the reference's bespoke dataset downloaders:

- :class:`NewsApiScraper` — the JTBC-news recipe
  (the reference's ``datasets/son/download.py:19-118``): a paged XML
  listing API yields news ids; each article endpoint returns quasi-XML
  with an HTML-embedded ``<article_contents>`` body and a ``<vod_path>``
  pointing at an m3u8 playlist.  We clean the body into one sentence per
  line, resolve master playlist -> media playlist -> MPEG-TS segments,
  concatenate the segments, and extract audio with ffmpeg.
- :class:`PodcastFeed` — the KBS-podcast RSS recipe
  (the reference's ``datasets/yuinna/download.py:23-52``): filter feed
  items by an accept-list of episode titles, key each episode by the
  date token embedded in its media URL, and download the enclosures.

Design differences from the reference: no bs4/m3u8/nltk dependencies
(lenient regex tag extraction + a tiny HLS playlist parser + a
punctuation sentence splitter), and all network I/O goes through an
injectable ``fetch`` callable so every parsing rule is unit-testable
offline.  The 2017 endpoints themselves are long defunct; the classes
take the endpoint URLs as constructor arguments so the recipe outlives
any one host.
"""

from __future__ import annotations

import argparse
import html
import json
import os
import re
import shutil
import subprocess
import urllib.parse
import urllib.request
from typing import Callable, Dict, List, Optional, Sequence, Tuple

Fetch = Callable[[str], str]
FetchBytes = Callable[[str], bytes]


def _default_fetch(url: str) -> str:
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.read().decode("utf-8", errors="replace")
    except OSError as e:  # pragma: no cover - network path
        raise RuntimeError(
            f"cannot fetch {url} (network unavailable?): {e}") from e


def _default_fetch_bytes(url: str) -> bytes:
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.read()
    except OSError as e:  # pragma: no cover - network path
        raise RuntimeError(
            f"cannot fetch {url} (network unavailable?): {e}") from e


# ---------------------------------------------------------------------------
# lenient markup helpers (the APIs return quasi-XML with HTML inside)
# ---------------------------------------------------------------------------

def extract_tagged(text: str, tag: str) -> List[str]:
    """All inner texts of ``<tag>...</tag>``, case-insensitive, CDATA-aware."""
    pattern = re.compile(
        rf"<{tag}[^>]*>(.*?)</{tag}>", re.IGNORECASE | re.DOTALL)
    out = []
    for body in pattern.findall(text):
        m = re.match(r"\s*<!\[CDATA\[(.*?)\]\]>\s*$", body, re.DOTALL)
        out.append(m.group(1) if m else body)
    return out


def strip_html(text: str) -> str:
    """Drop markup tags and unescape entities (``<div>``-laden article bodies)."""
    text = re.sub(r"<\s*br\s*/?\s*>", "\n", text, flags=re.IGNORECASE)
    text = re.sub(r"</\s*(p|div)\s*>", "\n", text, flags=re.IGNORECASE)
    text = re.sub(r"<[^>]+>", "", text)
    return html.unescape(text)


def split_sentences(text: str) -> List[str]:
    """Terminal-punctuation sentence split (replaces the reference's nltk
    ``sent_tokenize``, ``son/download.py:73-80``); newline always splits."""
    pieces: List[str] = []
    for line in text.split("\n"):
        line = line.strip()
        if not line:
            continue
        start = 0
        for m in re.finditer(r"[.!?](?=\s|$)", line):
            pieces.append(line[start:m.end()].strip())
            start = m.end()
        tail = line[start:].strip()
        if tail:
            pieces.append(tail)
    return [p for p in pieces if p]


def clean_article_sentences(raw_html: str) -> List[str]:
    """Article body -> clean sentence list (one utterance candidate each).

    Mirrors the reference's cleanup rules (``son/download.py:75-90``):
    bracketed reporter quotes, promo/url blurbs and parentheticals are
    removed; ellipses become periods.
    """
    text = strip_html(raw_html)
    text = re.sub(r"\[.{0,80} :\s.+?\]", "", text, flags=re.DOTALL)
    text = re.sub(r"☞.+?http.+?\)", "", text)
    text = re.sub(r"\(https?://\S*?\)", "", text)
    sentences = []
    for sent in split_sentences(text):
        sent = re.sub(r"\([^)]*\)", "", sent)
        sent = sent.replace("…", ".").strip()
        if sent:
            sentences.append(sent)
    return sentences


# ---------------------------------------------------------------------------
# tiny HLS (m3u8) parser
# ---------------------------------------------------------------------------

def parse_m3u8(text: str, base_url: str) -> List[str]:
    """URIs in a playlist, resolved absolute (variant streams or segments)."""
    uris = []
    for line in text.splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            uris.append(urllib.parse.urljoin(base_url, line))
    return uris


# ---------------------------------------------------------------------------
# news-program scraper (JTBC recipe)
# ---------------------------------------------------------------------------

class NewsApiScraper:
    """Paged news-listing API -> per-article text + broadcast audio.

    ``list_params``/``article_params`` carry the site's opaque query codes
    (the reference hardcodes NJC300/NJC400 etc.,
    ``son/download.py:20-24,51-55``).
    """

    def __init__(self, base_url: str,
                 list_params: Optional[Dict[str, str]] = None,
                 article_params: Optional[Dict[str, str]] = None,
                 page_key: str = "PGI", id_key: str = "NID",
                 fetch: Optional[Fetch] = None,
                 fetch_bytes: Optional[FetchBytes] = None):
        self.base_url = base_url
        self.list_params = dict(list_params or {})
        self.article_params = dict(article_params or {})
        self.page_key = page_key
        self.id_key = id_key
        self.fetch = fetch or _default_fetch
        self.fetch_bytes = fetch_bytes or _default_fetch_bytes

    def _url(self, params: Dict[str, str]) -> str:
        return self.base_url + "?" + urllib.parse.urlencode(params)

    def list_news_ids(self, page: int) -> List[str]:
        params = dict(self.list_params)
        params[self.page_key] = str(page)
        return [t.strip() for t in
                extract_tagged(self.fetch(self._url(params)), "news_id")]

    def collect_news_ids(self, max_pages: int = 10_000) -> List[str]:
        """Walk listing pages until one comes back empty
        (``son/download.py:127-136``)."""
        ids: List[str] = []
        for page in range(1, max_pages + 1):
            batch = self.list_news_ids(page)
            if not batch:
                break
            ids.extend(batch)
        return ids

    def fetch_article(self, news_id: str) -> Tuple[List[str], str, str]:
        """-> (clean sentences, original text, vod playlist url)."""
        params = dict(self.article_params)
        params[self.id_key] = news_id
        doc = self.fetch(self._url(params))
        contents = extract_tagged(doc, "article_contents")
        vod_paths = extract_tagged(doc, "vod_path")
        if len(contents) != 1 or len(vod_paths) != 1:
            raise ValueError(
                f"article {news_id}: expected exactly one article_contents "
                f"and vod_path, got {len(contents)}/{len(vod_paths)}")
        original = strip_html(contents[0])
        return clean_article_sentences(contents[0]), original, \
            vod_paths[0].strip()

    def resolve_segments(self, playlist_url: str) -> List[str]:
        """Master playlist -> first variant -> media segment URLs
        (``son/download.py:100-101``)."""
        first = parse_m3u8(self.fetch(playlist_url), playlist_url)
        if not first:
            return []
        if first[0].rsplit("?", 1)[0].endswith(".m3u8"):
            return parse_m3u8(self.fetch(first[0]), first[0])
        return first

    def download(self, news_id: str, base_dir: str,
                 sample_rate: int = 24000) -> Dict[str, str]:
        """Write assets/{id}.txt (+original), video/{id}.ts, audio/{id}.wav."""
        asset_dir = os.path.join(base_dir, "assets")
        video_dir = os.path.join(base_dir, "video")
        audio_dir = os.path.join(base_dir, "audio")
        for d in (asset_dir, video_dir, audio_dir):
            os.makedirs(d, exist_ok=True)
        sentences, original, vod_url = self.fetch_article(news_id)
        text_path = os.path.join(asset_dir, f"{news_id}.txt")
        with open(os.path.join(asset_dir, f"original-{news_id}.txt"),
                  "w", encoding="utf-8") as f:
            f.write(original)
        with open(text_path, "w", encoding="utf-8") as f:
            f.write("\n".join(sentences))
        video_path = os.path.join(video_dir, f"{news_id}.ts")
        if not os.path.exists(video_path):
            with open(video_path, "wb") as f:
                for seg_url in self.resolve_segments(vod_url):
                    f.write(self.fetch_bytes(seg_url))
        audio_path = os.path.join(audio_dir, f"{news_id}.wav")
        if not os.path.exists(audio_path):
            ffmpeg = shutil.which("ffmpeg") or shutil.which("avconv")
            if ffmpeg is None:
                raise RuntimeError("audio extraction needs ffmpeg on PATH")
            subprocess.run(
                [ffmpeg, "-y", "-loglevel", "panic", "-i", video_path,
                 "-ac", "1", "-ar", str(sample_rate), "-vn", audio_path],
                check=True)
        return {"text": text_path, "video": video_path, "audio": audio_path}


# JTBC endpoint the reference targeted (defunct; kept for provenance).
JTBC_NEWSROOM = dict(
    base_url="http://nsvc.jtbc.joins.com/API/News/Newapp/Default.aspx",
    list_params={"NJC": "NJC300", "CAID": "NC10011174"},
    article_params={"NJC": "NJC400", "CD": "A0100"},
)


# ---------------------------------------------------------------------------
# podcast RSS scraper (KBS/yuinna recipe)
# ---------------------------------------------------------------------------

class PodcastFeed:
    """RSS feed -> accept-listed episodes keyed by the date token in
    their media URL."""

    def __init__(self, rss_url: str, fetch: Optional[Fetch] = None,
                 fetch_bytes: Optional[FetchBytes] = None):
        self.rss_url = rss_url
        self.fetch = fetch or _default_fetch
        self.fetch_bytes = fetch_bytes or _default_fetch_bytes

    @staticmethod
    def parse_items(rss_xml: str) -> List[Tuple[str, str]]:
        """-> [(title, media url)] per <item>; the url comes from <guid>
        or, failing that, the <enclosure url=...> attribute."""
        items = []
        for body in extract_tagged(rss_xml, "item"):
            titles = extract_tagged(body, "title")
            guids = extract_tagged(body, "guid")
            url = guids[0].strip() if guids else ""
            if not url:
                m = re.search(r"<enclosure[^>]*\burl\s*=\s*[\"']([^\"']+)",
                              body, re.IGNORECASE)
                url = m.group(1) if m else ""
            if titles and url:
                items.append((html.unescape(titles[0].strip()), url))
        return items

    @staticmethod
    def select_episodes(items: Sequence[Tuple[str, str]],
                        accept_list: Sequence[str],
                        max_num: Optional[int] = None,
                        date_token_index: int = 2) -> Dict[str, str]:
        """Keep items whose title contains an accepted show name and no
        ``-`` (re-runs/compilations in the source feed,
        ``yuinna/download.py:34-39``); key = date token split out of the
        media file name."""
        selected: Dict[str, str] = {}
        for title, url in items:
            if "-" in title or not any(a in title for a in accept_list):
                continue
            name = os.path.basename(urllib.parse.urlparse(url).path)
            parts = name.split("_")
            key = parts[date_token_index] if len(parts) > date_token_index \
                else os.path.splitext(name)[0]
            selected.setdefault(key, url)
            if max_num is not None and len(selected) >= max_num:
                break
        return selected

    def download_all(self, base_dir: str, accept_list: Sequence[str],
                     max_num: Optional[int] = None) -> List[str]:
        audio_dir = os.path.join(base_dir, "audio")
        os.makedirs(audio_dir, exist_ok=True)
        episodes = self.select_episodes(
            self.parse_items(self.fetch(self.rss_url)), accept_list, max_num)
        paths = []
        for key, url in sorted(episodes.items()):
            ext = os.path.splitext(urllib.parse.urlparse(url).path)[1] or ".mp4"
            path = os.path.join(audio_dir, f"{key}{ext}")
            if not os.path.exists(path):
                with open(path, "wb") as f:
                    f.write(self.fetch_bytes(url))
            paths.append(path)
        return paths


KBS_YUINNA = dict(
    rss_url=("http://enabler.kbs.co.kr/api/podcast_channel/feed.xml"
             "?channel_id=R2010-0440"),
    accept_list=["친절한 인나씨", "반납예정일", "귀욤열매 드세요"],
)


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="site-specific scrapers")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p1 = sub.add_parser("news", help="news-program scrape (JTBC recipe)")
    p1.add_argument("base_dir")
    p1.add_argument("--base_url", default=JTBC_NEWSROOM["base_url"])
    p1.add_argument("--max_pages", type=int, default=10_000)
    p1.add_argument("--skip_ids", nargs="*", default=[])
    p2 = sub.add_parser("podcast", help="podcast RSS scrape (KBS recipe)")
    p2.add_argument("base_dir")
    p2.add_argument("--rss_url", default=KBS_YUINNA["rss_url"])
    p2.add_argument("--accept", nargs="*", default=KBS_YUINNA["accept_list"])
    p2.add_argument("--max_num", type=int, default=100)
    args = parser.parse_args(argv)
    if args.cmd == "news":
        scraper = NewsApiScraper(
            args.base_url, JTBC_NEWSROOM["list_params"],
            JTBC_NEWSROOM["article_params"])
        ids_path = os.path.join(args.base_dir, "news_ids.json")
        if os.path.exists(ids_path):
            with open(ids_path) as f:
                ids = json.load(f)
        else:
            ids = scraper.collect_news_ids(args.max_pages)
            os.makedirs(args.base_dir, exist_ok=True)
            with open(ids_path, "w") as f:
                json.dump(ids, f, indent=2, ensure_ascii=False)
        for news_id in sorted(set(ids) - set(args.skip_ids)):
            try:
                scraper.download(news_id, args.base_dir)
                print(f" [*] {news_id}")
            except (ValueError, RuntimeError) as e:
                print(f" [!] {news_id}: {e}")
    else:
        feed = PodcastFeed(args.rss_url)
        for path in feed.download_all(args.base_dir, args.accept,
                                      args.max_num):
            print(f" [*] {path}")


if __name__ == "__main__":
    main()
