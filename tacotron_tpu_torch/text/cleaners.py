"""Text cleaner registry.

Cleaners are composable text transforms selected by name (comma-separated in
``DataConfig.cleaners``), mirroring the reference registry
(``text/cleaners.py``).  Unlike the reference — whose
``english_cleaners`` crashes with a NameError because ``convert_to_ascii`` and
``normalize_numbers`` are never imported (``cleaners.py:84-91``) — every
cleaner here is functional and dependency-free (ASCII transliteration uses
``unicodedata`` instead of the unavailable Unidecode package).
"""

from __future__ import annotations

import re
import unicodedata
import warnings

from .english_numbers import normalize_numbers
from .korean import tokenize as _korean_tokenize

_WHITESPACE_RE = re.compile(r"\s+")

_ABBREVIATIONS = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), expansion)
    for abbr, expansion in [
        ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"),
        ("st", "saint"), ("co", "company"), ("jr", "junior"),
        ("maj", "major"), ("gen", "general"), ("drs", "doctors"),
        ("rev", "reverend"), ("lt", "lieutenant"), ("hon", "honorable"),
        ("sgt", "sergeant"), ("capt", "captain"), ("esq", "esquire"),
        ("ltd", "limited"), ("col", "colonel"), ("ft", "fort"),
    ]
]


def korean_cleaners(text: str):
    """Korean pipeline: normalization + jamo tokenization.

    Returns a list of jamo tokens (EOS-terminated), like the reference
    (``cleaners.py:22-25``); the codec layer drops the trailing EOS and
    re-appends its own.
    """
    return _korean_tokenize(text)


# Script transliteration tables for the common non-Latin scripts.  The
# reference intends Unidecode here (``text/cleaners.py:3-9``,
# unavailable offline); NFKD alone strips Latin diacritics but silently
# DELETES whole non-Latin words.  These tables cover Cyrillic and Greek with
# standard readable romanizations.  Documented divergences from Unidecode's
# exact output (goldens in tests/test_text.py): we use 'yo/yu/ya' for ё/ю/я
# where Unidecode uses 'io/iu/ia', 'ch' for χ where Unidecode uses 'kh',
# 'ph' for φ where Unidecode uses 'f'.  Scripts not covered (CJK, Arabic,
# ...) are dropped with an explicit warning instead of silently — the
# vocabulary cannot encode them either way.
_CYRILLIC = {
    "а": "a", "б": "b", "в": "v", "г": "g", "д": "d", "е": "e", "ё": "yo",
    "ж": "zh", "з": "z", "и": "i", "й": "i", "к": "k", "л": "l", "м": "m",
    "н": "n", "о": "o", "п": "p", "р": "r", "с": "s", "т": "t", "у": "u",
    "ф": "f", "х": "kh", "ц": "ts", "ч": "ch", "ш": "sh", "щ": "shch",
    "ъ": "", "ы": "y", "ь": "", "э": "e", "ю": "yu", "я": "ya",
    # Ukrainian/Belarusian extras
    "є": "ye", "і": "i", "ї": "yi", "ґ": "g", "ў": "u",
}
_GREEK = {
    "α": "a", "β": "b", "γ": "g", "δ": "d", "ε": "e", "ζ": "z", "η": "e",
    "θ": "th", "ι": "i", "κ": "k", "λ": "l", "μ": "m", "ν": "n", "ξ": "x",
    "ο": "o", "π": "p", "ρ": "r", "σ": "s", "ς": "s", "τ": "t", "υ": "y",
    "φ": "ph", "χ": "ch", "ψ": "ps", "ω": "o",
}
# Latin letters NFKD cannot decompose (no compatibility mapping)
_LATIN_EXTRA = {
    "ß": "ss", "æ": "ae", "œ": "oe", "ø": "o", "đ": "d", "ð": "d",
    "þ": "th", "ł": "l", "ħ": "h", "ŋ": "ng", "ı": "i", "ĸ": "k",
}

_WARNED_DROPPED: set = set()

_TRANSLIT = {**_CYRILLIC, **_GREEK, **_LATIN_EXTRA}
_TRANSLIT.update({k.upper(): v.capitalize() for k, v in _TRANSLIT.items()
                  if k.upper() != k})


def convert_to_ascii(text: str, warn_dropped: bool = True) -> str:
    """ASCII transliteration (the reference's Unidecode intent).

    Pipeline: transliteration table on the precomposed text (so ``ё``/``й``
    map as letters, not base+mark) -> NFKD decomposition (splits Latin
    diacritics and Greek tonos into base + combining marks) -> table again
    (for bases exposed by the decomposition) -> ASCII encode dropping what
    remains (combining marks, uncovered scripts).  Characters from
    uncovered scripts are reported in ONE warning per call rather than
    vanishing silently — the documented boundary where this implementation
    is narrower than Unidecode."""
    pre = "".join(_TRANSLIT.get(ch, ch) for ch in text)
    decomposed = unicodedata.normalize("NFKD", pre)
    mapped = "".join(_TRANSLIT.get(ch, ch) for ch in decomposed)
    out = mapped.encode("ascii", "ignore").decode("ascii")
    if warn_dropped:
        # warn once per CHARACTER process-wide, not once per unique
        # character SET: the default warning dedup keys on message text,
        # so embedding per-utterance sets would emit a near-unique line
        # per utterance across a large corpus build.
        dropped = {ch for ch in mapped if ord(ch) > 127
                   and not unicodedata.combining(ch)} - _WARNED_DROPPED
        if dropped:
            _WARNED_DROPPED.update(dropped)
            warnings.warn(
                f"convert_to_ascii dropped characters with no "
                f"transliteration: {''.join(sorted(dropped))!r} (script "
                f"not covered; the reference's Unidecode would "
                f"transliterate some of these; further drops of these "
                f"characters are silent)", stacklevel=2)
    return out


def lowercase(text: str) -> str:
    return text.lower()


def collapse_whitespace(text: str) -> str:
    return _WHITESPACE_RE.sub(" ", text)


def expand_abbreviations(text: str) -> str:
    for pattern, expansion in _ABBREVIATIONS:
        text = pattern.sub(expansion, text)
    return text


def expand_numbers(text: str) -> str:
    return normalize_numbers(text)


def basic_cleaners(text: str) -> str:
    """Lowercase + whitespace collapse, no transliteration."""
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text: str) -> str:
    """ASCII transliteration for non-English latin-script text."""
    return collapse_whitespace(lowercase(convert_to_ascii(text)))


def english_cleaners(text: str) -> str:
    """English pipeline: transliteration, numbers, abbreviations."""
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = expand_numbers(text)
    text = expand_abbreviations(text)
    text = collapse_whitespace(text)
    return text


_REGISTRY = {
    "korean_cleaners": korean_cleaners,
    "english_cleaners": english_cleaners,
    "basic_cleaners": basic_cleaners,
    "transliteration_cleaners": transliteration_cleaners,
}


def get_cleaner(name: str):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"Unknown cleaner: {name}") from None
