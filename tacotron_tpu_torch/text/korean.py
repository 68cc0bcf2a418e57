"""Korean text normalizer and jamo tokenizer.

Behavioral re-implementation of the reference frontend
(``text/korean.py``) without its external dependencies
(``jamo``, ``nltk``): hangul decomposition comes from
``tacotron_tpu_torch.text.hangul``, sentence splitting inside quotes falls back to a
regex when NLTK's punkt data is unavailable.

Pipeline of ``normalize`` (reference ``korean.py:151-164``):
  1. strip; drop "(N일)" date parentheticals and hanja parentheticals
  2. literal dictionary rewrites (etc_dictionary)
  3. English-word transliteration (english_dictionary)
  4. all-uppercase acronyms -> per-letter Korean readings
  5. quoted spans re-segmented into single-quoted sentences
  6. numbers -> Korean readings (Sino-Korean, or native Korean before counters)
"""

from __future__ import annotations

import re

from . import hangul
from .ko_dictionary import english_dictionary, etc_dictionary
from .symbols import ALL_SYMBOLS, EOS, PAD, char_to_id, id_to_char  # noqa: F401

# Matches text wrapped in any of the common quote characters
# (reference korean.py:26).
_QUOTE_RE = re.compile(r"([`\"'＂“‘])(.+?)([`\"'＂”’])")

# Hanja parenthetical, e.g. "(猪突)" (reference korean.py:155).
_HANJA_PAREN_RE = re.compile(
    "\\([⺀-⺙⺛-⻳⼀-⿕々〇〡-〩〸-〺〻㐀-䶵一-鿃豈-鶴侮-頻並-龎]+\\)")
_DATE_PAREN_RE = re.compile(r"\(\d+일\)")

# "digits, optionally signed/comma-grouped, optional decimal part"
# (reference korean.py:204-205).
_NUMBER_PATTERN = r"([+-]?\d[\d,]*)[\.]?\d*"
_COUNTER_PATTERN = (
    r"(시|명|가지|살|마리|포기|송이|수|톨|통|점|개|벌|척|채|다발|그루|자루|줄|"
    r"켤레|그릇|잔|마디|상자|사람|곡|병|판)")

_DIGIT_READINGS = dict(zip("0123456789", "영일이삼사오육칠팔구"))

_UNIT_READINGS_LONG = {
    "%": "퍼센트",
    "cm": "센치미터",
    "mm": "밀리미터",
    "km": "킬로미터",
    "kg": "킬로그람",
}
_UNIT_READINGS_SHORT = {"m": "미터"}

_ACRONYM_READINGS = dict(zip(
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ",
    ["에이", "비", "씨", "디", "이", "에프", "지", "에이치", "아이", "제이",
     "케이", "엘", "엠", "엔", "오", "피", "큐", "알", "에스", "티", "유",
     "브이", "더블유", "엑스", "와이", "지"]))

# Sino-Korean digit/place readings (reference korean.py:216-218).
_SINO_DIGITS = [""] + list("일이삼사오육칠팔구")
_GROUP_PLACES = [""] + list("만억조경해")
_SMALL_PLACES = [""] + list("십백천")

# Native Korean readings used before counting units (reference korean.py:221).
_NATIVE_DIGITS = [""] + ["한", "두", "세", "네", "다섯", "여섯", "일곱", "여덟", "아홉"]
_NATIVE_TENS = {
    "십": "열", "두십": "스물", "세십": "서른", "네십": "마흔", "다섯십": "쉰",
    "여섯십": "예순", "일곱십": "일흔", "여덟십": "여든", "아홉십": "아흔",
}


def tokenize(text: str, as_id: bool = False):
    """Normalize then decompose to a jamo token list, EOS-terminated
    (reference ``korean.py:139-146``)."""
    jamo_text = hangul.decompose(normalize(text))
    if as_id:
        return [char_to_id[token] for token in jamo_text] + [char_to_id[EOS]]
    return list(jamo_text) + [EOS]


def jamo_to_korean(text: str) -> str:
    """Recompose a jamo stream into readable Hangul."""
    return hangul.compose_text(text)


def normalize(text: str) -> str:
    text = text.strip()
    text = _DATE_PAREN_RE.sub("", text)
    text = _HANJA_PAREN_RE.sub("", text)
    text = _substitute(text, etc_dictionary)
    text = _normalize_english_words(text)
    text = re.sub("[a-zA-Z]+", _read_acronym, text)
    text = _normalize_quotes(text)
    text = normalize_number(text)
    return text


def _substitute(text: str, table: dict) -> str:
    if not any(key in text for key in table):
        return text
    pattern = re.compile("|".join(re.escape(key) for key in table))
    return pattern.sub(lambda m: table[m.group()], text)


def _normalize_english_words(text: str) -> str:
    return re.sub(
        "([A-Za-z]+)",
        lambda m: english_dictionary.get(m.group(), m.group()),
        text)


def _read_acronym(match: re.Match) -> str:
    word = match.group(0)
    if word.isupper():
        return "".join(_ACRONYM_READINGS[c] for c in word)
    return word


def _split_sentences(text: str) -> list[str]:
    """Sentence segmentation, preferring NLTK punkt when its data is present."""
    try:
        from nltk import sent_tokenize
        return sent_tokenize(text)
    except Exception:
        parts = re.split(r"(?<=[.!?])\s+", text.strip())
        return [p for p in parts if p]


def _normalize_quotes(text: str) -> str:
    def requote(match: re.Match) -> str:
        inner = match.group(0)[1:-1]
        return " ".join(f"'{sentence}'" for sentence in _split_sentences(inner))

    return _QUOTE_RE.sub(requote, text)


def normalize_number(text: str) -> str:
    text = _substitute(text, _UNIT_READINGS_LONG)
    text = _substitute(text, _UNIT_READINGS_SHORT)
    text = re.sub(
        _NUMBER_PATTERN + _COUNTER_PATTERN,
        lambda m: _read_number(m.group(1), m.group(2), is_count=True),
        text)
    text = re.sub(
        _NUMBER_PATTERN,
        lambda m: _read_number(m.group(), "", is_count=False),
        text)
    return text


def _read_integer(digit_str: str, is_count: bool) -> str:
    """Read an unsigned integer string in Korean.

    Sino-Korean by default; native Korean readings for counting words.
    Mirrors the grouping rules of reference ``korean.py:265-292``: digits are
    scanned most-significant first, each non-zero digit gets its small place
    (십/백/천), and every 4-digit group boundary appends its large place
    (만/억/조/...) provided the group was non-zero.
    """
    digits = _NATIVE_DIGITS if is_count else _SINO_DIGITS
    size = len(digit_str)
    reading = ""
    group: list[str] = []
    for pos, char in enumerate(digit_str, start=1):
        value = int(char)
        remaining = size - pos
        if value != 0:
            group.append(digits[value])
            group.append(_SMALL_PLACES[remaining % 4])
        if remaining % 4 == 0 and group:
            reading += "".join(group) + _GROUP_PLACES[remaining // 4]
            group = []

    if is_count:
        if reading.startswith("한") and len(reading) > 1:
            reading = reading[1:]
        if any(key in reading for key in _NATIVE_TENS):
            reading = re.sub(
                "|".join(_NATIVE_TENS), lambda m: _NATIVE_TENS[m.group()], reading)
    elif reading.startswith("일") and len(reading) > 1:
        reading = reading[1:]
    return reading


def _read_number(num_str: str, unit_str: str, is_count: bool) -> str:
    num_str = num_str.replace(",", "")

    if float(num_str) == 0:
        # reference quirk kept for parity: zero drops the counter word
        # ("0마리" -> "영", korean.py:246-247)
        return "영"

    integer_part, _, fraction_part = num_str.partition(".")
    if is_count and fraction_part:
        raise ValueError("counting words cannot follow a fractional number")

    sign = ""
    if integer_part.startswith("+"):
        sign, integer_part = "플러스 ", integer_part[1:]
    elif integer_part.startswith("-"):
        sign, integer_part = "마이너스 ", integer_part[1:]
    integer_part = str(int(integer_part)) if integer_part else "0"

    reading = _read_integer(integer_part, is_count)
    if fraction_part:
        reading += "쩜 " + "".join(_DIGIT_READINGS[d] for d in fraction_part)
    return sign + reading + unit_str
