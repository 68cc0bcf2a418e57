"""Plain Korean text frontend: Hangul syllables to jamo symbol ids.

The symbol table is the reference's 80-symbol layout (PAD, EOS, 19 lead,
21 vowel and 27 tail jamo, punctuation, space).  A syllable U+AC00 +
(lead * 21 + vowel) * 28 + tail maps to its lead, its vowel and, when tail
is not 0, its tail; punctuation and the space map to themselves; one EOS
closes the sequence.  The benchmark's texts hold nothing else, and any other
character raises.
"""

from __future__ import annotations

from typing import List

PAD_ID = 0
EOS_ID = 1
N_LEADS, N_VOWELS, N_TAILS = 19, 21, 27
LEAD0 = 2
VOWEL0 = LEAD0 + N_LEADS
TAIL0 = VOWEL0 + N_VOWELS
PUNCTUATION = "!'(),-.:;?"
PUNCT0 = TAIL0 + N_TAILS
SPACE_ID = PUNCT0 + len(PUNCTUATION)
VOCAB_SIZE = SPACE_ID + 1


def text_to_ids(text: str) -> List[int]:
    ids: List[int] = []
    for ch in text:
        code = ord(ch) - 0xAC00
        if 0 <= code < N_LEADS * N_VOWELS * 28:
            lead, rest = divmod(code, N_VOWELS * 28)
            vowel, tail = divmod(rest, 28)
            ids += [LEAD0 + lead, VOWEL0 + vowel]
            if tail:
                ids.append(TAIL0 + tail - 1)
        elif ch == " ":
            ids.append(SPACE_ID)
        elif ch in PUNCTUATION:
            ids.append(PUNCT0 + PUNCTUATION.index(ch))
        else:
            raise ValueError(f"character {ch!r} is outside the benchmark's "
                             f"texts")
    ids.append(EOS_ID)
    return ids


def token_count(text: str) -> int:
    """Ids of ``text``, EOS included."""
    return len(text_to_ids(text))
