"""The 80-symbol vocabulary shared by the Korean frontend and the model.

Layout matches the reference exactly so that token id streams interchange
(``text/korean.py:11-24``, ``text/symbols.py:13``):

    id 0           '_'  PAD
    id 1           '~'  EOS
    ids 2..20      19 lead jamo    (U+1100..U+1112)
    ids 21..41     21 vowel jamo   (U+1161..U+1175)
    ids 42..68     27 tail jamo    (U+11A8..U+11C2)
    ids 69..78     punctuation     !'(),-.:;?
    id 79          ' '  space
"""

from .hangul import JAMO_LEADS, JAMO_TAILS, JAMO_VOWELS

PAD = "_"
EOS = "~"
PUNCTUATION = "!'(),-.:;?"
SPACE = " "

VALID_CHARS = JAMO_LEADS + JAMO_VOWELS + JAMO_TAILS + PUNCTUATION + SPACE
ALL_SYMBOLS = PAD + EOS + VALID_CHARS

symbols = ALL_SYMBOLS

char_to_id = {char: i for i, char in enumerate(ALL_SYMBOLS)}
id_to_char = {i: char for i, char in enumerate(ALL_SYMBOLS)}

PAD_ID = char_to_id[PAD]
EOS_ID = char_to_id[EOS]

VOCAB_SIZE = len(ALL_SYMBOLS)

# English/ASCII vocabulary.  The reference ships this commented out
# (``text/symbols.py:12``) — its Korean set is always
# active, so English synthesis was not actually usable there.  Here it is a
# first-class selectable set with the same PAD/EOS ids.
EN_LETTERS = ("ABCDEFGHIJKLMNOPQRSTUVWXYZ"
              "abcdefghijklmnopqrstuvwxyz")
EN_SYMBOLS = PAD + EOS + EN_LETTERS + PUNCTUATION + SPACE

SYMBOL_SETS = {"korean": ALL_SYMBOLS, "english": EN_SYMBOLS}


def get_symbol_set(name: str) -> str:
    try:
        return SYMBOL_SETS[name]
    except KeyError:
        raise ValueError(f"unknown symbol set {name!r}; "
                         f"choose from {sorted(SYMBOL_SETS)}") from None


def vocab_size_for(name: str) -> int:
    return len(get_symbol_set(name))
