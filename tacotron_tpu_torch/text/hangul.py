"""Self-contained Hangul <-> jamo codec.

The reference delegates jamo decomposition/composition to the external ``jamo``
package (``text/korean.py:7``).  That package is not a dependency of this
project, and the math is tiny, so this module implements the Unicode Hangul
composition algorithm directly (Unicode standard ch. 3.12).

A precomposed syllable S in U+AC00..U+D7A3 decomposes as::

    index = S - 0xAC00
    lead  = index // (21 * 28)        -> U+1100 + lead     (19 choseong)
    vowel = (index % (21 * 28)) // 28 -> U+1161 + vowel    (21 jungseong)
    tail  = index % 28                -> U+11A7 + tail     (27 jongseong, tail>0)
"""

from __future__ import annotations

SYLLABLE_BASE = 0xAC00
SYLLABLE_END = 0xD7A3
LEAD_BASE = 0x1100
VOWEL_BASE = 0x1161
TAIL_BASE = 0x11A7  # tail index 1..27 maps to U+11A8..U+11C2

NUM_LEADS = 19
NUM_VOWELS = 21
NUM_TAILS = 28  # including "no tail" at index 0

JAMO_LEADS = "".join(chr(LEAD_BASE + i) for i in range(NUM_LEADS))
JAMO_VOWELS = "".join(chr(VOWEL_BASE + i) for i in range(NUM_VOWELS))
JAMO_TAILS = "".join(chr(TAIL_BASE + i) for i in range(1, NUM_TAILS))

# Hangul Compatibility Jamo (U+3131..U+3163) equivalents, used when a lone
# lead/tail jamo must be rendered as standalone text (the reference reaches
# these through jamo's ``_jamo_char_to_hcj``).
_LEAD_TO_HCJ = "ㄱㄲㄴㄷㄸㄹㅁㅂㅃㅅㅆㅇㅈㅉㅊㅋㅌㅍㅎ"
_TAIL_TO_HCJ = "ㄱㄲㄳㄴㄵㄶㄷㄹㄺㄻㄼㄽㄾㄿㅀㅁㅂㅄㅅㅆㅇㅈㅊㅋㅌㅍㅎ"
_VOWEL_TO_HCJ = "".join(chr(0x314F + i) for i in range(NUM_VOWELS))


def is_hangul_syllable(char: str) -> bool:
    return SYLLABLE_BASE <= ord(char) <= SYLLABLE_END


def is_lead(char: str) -> bool:
    return LEAD_BASE <= ord(char) < LEAD_BASE + NUM_LEADS


def is_vowel(char: str) -> bool:
    return VOWEL_BASE <= ord(char) < VOWEL_BASE + NUM_VOWELS


def is_tail(char: str) -> bool:
    return TAIL_BASE + 1 <= ord(char) <= TAIL_BASE + NUM_TAILS - 1


def decompose_char(char: str) -> str:
    """Decompose one precomposed syllable into 2-3 jamo; pass others through."""
    if not is_hangul_syllable(char):
        return char
    index = ord(char) - SYLLABLE_BASE
    lead = index // (NUM_VOWELS * NUM_TAILS)
    vowel = (index % (NUM_VOWELS * NUM_TAILS)) // NUM_TAILS
    tail = index % NUM_TAILS
    out = chr(LEAD_BASE + lead) + chr(VOWEL_BASE + vowel)
    if tail:
        out += chr(TAIL_BASE + tail)
    return out


def decompose(text: str) -> str:
    """Hangul string -> jamo string (equivalent of jamo's ``h2j``)."""
    return "".join(decompose_char(c) for c in text)


def compose(lead: str, vowel: str, tail: str | None = None) -> str:
    """Compose lead+vowel(+tail) jamo into one syllable (jamo's ``j2h``)."""
    lead_i = ord(lead) - LEAD_BASE
    vowel_i = ord(vowel) - VOWEL_BASE
    tail_i = (ord(tail) - TAIL_BASE) if tail else 0
    if not (0 <= lead_i < NUM_LEADS and 0 <= vowel_i < NUM_VOWELS
            and 0 <= tail_i < NUM_TAILS):
        raise ValueError(f"not composable jamo: {lead!r} {vowel!r} {tail!r}")
    return chr(SYLLABLE_BASE + (lead_i * NUM_VOWELS + vowel_i) * NUM_TAILS + tail_i)


def jamo_char_to_hcj(char: str) -> str:
    """Render a lone jamo as its standalone compatibility form."""
    code = ord(char)
    if is_lead(char):
        return _LEAD_TO_HCJ[code - LEAD_BASE]
    if is_vowel(char):
        return _VOWEL_TO_HCJ[code - VOWEL_BASE]
    if is_tail(char):
        return _TAIL_TO_HCJ[code - TAIL_BASE - 1]
    return char


def compose_text(text: str) -> str:
    """Greedy jamo -> Hangul recomposition.

    Re-implements the reference's ``jamo_to_korean``
    (``text/korean.py:55-81``): walk the jamo stream, buffering
    a (lead, vowel, tail) candidate; a new lead or a non-jamo character flushes
    the buffer.  Lone jamo that cannot form a syllable are emitted as
    compatibility jamo.
    """
    text = decompose(text)
    out: list[str] = []
    buf: list[str] = []

    def flush() -> None:
        if not buf:
            return
        if len(buf) == 1:
            out.append(jamo_char_to_hcj(buf[0]))
        else:
            out.append(compose(*buf[:3]))
        buf.clear()

    for char in text:
        if is_lead(char):
            flush()
            buf.append(char)
        elif is_vowel(char) or is_tail(char):
            if buf:
                buf.append(char)
            else:
                out.append(jamo_char_to_hcj(char))
        else:
            flush()
            out.append(char)
    flush()
    return "".join(out)
