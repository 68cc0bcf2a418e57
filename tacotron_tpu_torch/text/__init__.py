"""Text <-> symbol-id codec.

Equivalent of the reference's ``text/__init__.py``: runs the configured
cleaners, maps symbols to ids (dropping anything outside the vocabulary and
any PAD/EOS produced by a cleaner), and appends a single EOS id.  Supports the
keithito ARPAbet curly-brace passthrough (``{HH AH0 ...}``) for API parity
(reference ``text/__init__.py:16,42-50``) even though the active Korean symbol
set contains no ARPAbet symbols.

No global config: cleaner names are an explicit argument (default Korean).
"""

from __future__ import annotations

import re
from typing import Iterable, Sequence

import numpy as np

from . import cleaners as _cleaners_module
from .cleaners import get_cleaner
from .korean import jamo_to_korean
from .symbols import (ALL_SYMBOLS, EN_SYMBOLS, EOS, EOS_ID, PAD, PAD_ID,
                      SYMBOL_SETS, VOCAB_SIZE, char_to_id, get_symbol_set,
                      id_to_char, symbols, vocab_size_for)

__all__ = [
    "text_to_sequence", "sequence_to_text", "tokens_to_ids",
    "ALL_SYMBOLS", "EN_SYMBOLS", "EOS", "EOS_ID", "PAD", "PAD_ID",
    "SYMBOL_SETS", "VOCAB_SIZE", "char_to_id", "get_symbol_set",
    "id_to_char", "symbols", "jamo_to_korean", "get_cleaner",
    "vocab_size_for", "round_trip_errors",
]

_CURLY_RE = re.compile(r"(.*?)\{(.+?)\}(.*)")

DEFAULT_CLEANERS = ("korean_cleaners",)


def text_to_sequence(
        text: str,
        cleaner_names: Sequence[str] = DEFAULT_CLEANERS,
        as_token: bool = False,
        symbol_set: str = "korean"):
    """Convert text to an int32 array of symbol ids, EOS-terminated.

    ``symbol_set`` selects the vocabulary ("korean" 80-symbol jamo set, the
    reference default, or "english" ASCII letters)."""
    table = _tables(symbol_set)[0]
    sequence: list[int] = []
    while text:
        match = _CURLY_RE.match(text)
        if not match:
            sequence.extend(_encode(_clean(text, cleaner_names), table))
            break
        sequence.extend(_encode(_clean(match.group(1), cleaner_names),
                                table))
        sequence.extend(_encode(("@" + s for s in match.group(2).split()),
                                table))
        text = match.group(3)

    sequence.append(EOS_ID)
    if as_token:
        return sequence_to_text(sequence, combine_jamo=True)
    return np.asarray(sequence, dtype=np.int32)


import functools as _functools


@_functools.lru_cache(maxsize=4)
def _tables(symbol_set: str):
    syms = get_symbol_set(symbol_set)
    return ({c: i for i, c in enumerate(syms)},
            {i: c for i, c in enumerate(syms)})


def tokens_to_ids(tokens: Iterable[str]) -> np.ndarray:
    """Map pre-tokenized symbols (e.g. jamo) to ids, appending EOS."""
    return np.asarray(
        [char_to_id[t] for t in tokens if _keep(t)] + [EOS_ID], dtype=np.int32)


def sequence_to_text(
        sequence: Iterable[int],
        skip_eos_and_pad: bool = False,
        combine_jamo: bool = False,
        symbol_set: str = "korean") -> str:
    """Invert ``text_to_sequence`` (reference ``text/__init__.py:61-79``)."""
    inverse = _tables(symbol_set)[1]
    result = ""
    for symbol_id in sequence:
        symbol = inverse.get(int(symbol_id))
        if symbol is None:
            continue
        if len(symbol) > 1 and symbol.startswith("@"):
            symbol = "{%s}" % symbol[1:]
        if skip_eos_and_pad and symbol in (EOS, PAD):
            continue
        result += symbol
    result = result.replace("}{", " ")
    return jamo_to_korean(result) if combine_jamo else result


def round_trip_errors(texts: Sequence[str],
                      cleaner_names: Sequence[str] = DEFAULT_CLEANERS,
                      symbol_set: str = "korean") -> list:
    """Startup sanity check (reference ``train.py:27-40``): encode each text
    and decode it back; returns ``(text, cleaned, decoded)`` triples that
    fail to round-trip to the cleaned, in-vocabulary symbol string."""
    table = _tables(symbol_set)[0]
    errors = []
    for text in texts:
        seq = text_to_sequence(text, cleaner_names, symbol_set=symbol_set)
        decoded = sequence_to_text(seq, skip_eos_and_pad=True,
                                   symbol_set=symbol_set)
        cleaned = "".join(s for s in _clean(text, cleaner_names)
                          if _keep(s, table))
        if decoded != cleaned:
            errors.append((text, cleaned, decoded))
    return errors


def _clean(text: str, cleaner_names: Sequence[str]):
    for name in cleaner_names:
        text = get_cleaner(name.strip())(text)
    return text


def _encode(cleaned, table=None) -> list[int]:
    """Symbols (string or token list) -> ids, dropping PAD/EOS/unknowns."""
    table = char_to_id if table is None else table
    return [table[s] for s in cleaned if _keep(s, table)]


def _keep(symbol: str, table=None) -> bool:
    table = char_to_id if table is None else table
    return symbol in table and symbol not in (PAD, EOS)
