"""English number verbalization (self-contained ``inflect`` replacement).

Covers what the reference uses from the ``inflect`` package
(``text/en_numbers.py``): cardinal numbers, ordinals, year-style
two-digit grouping, currency, and decimal points.
"""

from __future__ import annotations

import re

_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven",
         "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
         "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALES = ["", "thousand", "million", "billion", "trillion", "quadrillion",
           "quintillion"]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _two_digits_to_words(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    if ones == 0:
        return _TENS[tens]
    return f"{_TENS[tens]}-{_ONES[ones]}"


def _three_digits_to_words(n: int) -> str:
    hundreds, rest = divmod(n, 100)
    parts = []
    if hundreds:
        parts.append(f"{_ONES[hundreds]} hundred")
    if rest or not hundreds:
        parts.append(_two_digits_to_words(rest))
    return " ".join(parts)


def number_to_words(n: int) -> str:
    """Cardinal reading: 1234 -> 'one thousand, two hundred thirty-four'."""
    if n < 0:
        return "minus " + number_to_words(-n)
    if n == 0:
        return "zero"
    groups: list[int] = []
    while n:
        groups.append(n % 1000)
        n //= 1000
    if len(groups) > len(_SCALES):
        raise ValueError("number too large to verbalize")
    parts = []
    for scale_index in reversed(range(len(groups))):
        group = groups[scale_index]
        if group == 0:
            continue
        words = _three_digits_to_words(group)
        if scale_index:
            words += f" {_SCALES[scale_index]}"
        parts.append(words)
    return ", ".join(parts)


def ordinal_to_words(n: int) -> str:
    """Ordinal reading: 21 -> 'twenty-first'."""
    words = number_to_words(n)
    head, sep, last = words.rpartition("-") if "-" in words.rsplit(" ", 1)[-1] \
        else words.rpartition(" ")
    if last in _ORDINAL_IRREGULAR:
        last = _ORDINAL_IRREGULAR[last]
    elif last.endswith("y"):
        last = last[:-1] + "ieth"
    else:
        last = last + "th"
    return head + sep + last


def year_to_words(n: int) -> str:
    """Year-style reading used for 1000 < n < 3000 by the reference
    (``en_numbers.py:47-57``): two-digit groups, 'oh' for a zero tens group."""
    if n == 2000:
        return "two thousand"
    if 2000 < n < 2010:
        return "two thousand " + number_to_words(n % 100)
    if n % 100 == 0:
        return number_to_words(n // 100) + " hundred"
    high, low = divmod(n, 100)
    low_words = "oh " + _ONES[low] if low < 10 else _two_digits_to_words(low)
    return f"{number_to_words(high)} {low_words}"


# ----------------------------------------------------------------- text pass

_COMMA_NUMBER_RE = re.compile(r"([0-9][0-9\,]+[0-9])")
_DECIMAL_RE = re.compile(r"([0-9]+\.[0-9]+)")
_POUNDS_RE = re.compile(r"£([0-9\,]*[0-9]+)")
_DOLLARS_RE = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ORDINAL_RE = re.compile(r"([0-9]+)(st|nd|rd|th)")
_NUMBER_RE = re.compile(r"[0-9]+")


def _expand_dollars(match: re.Match) -> str:
    amount = match.group(1)
    parts = amount.split(".")
    if len(parts) > 2:
        return amount + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    dollar_unit = "dollar" if dollars == 1 else "dollars"
    cent_unit = "cent" if cents == 1 else "cents"
    if dollars and cents:
        return f"{dollars} {dollar_unit}, {cents} {cent_unit}"
    if dollars:
        return f"{dollars} {dollar_unit}"
    if cents:
        return f"{cents} {cent_unit}"
    return "zero dollars"


def _expand_number(match: re.Match) -> str:
    num = int(match.group(0))
    if 1000 < num < 3000:
        return year_to_words(num)
    return number_to_words(num)


def normalize_numbers(text: str) -> str:
    text = _COMMA_NUMBER_RE.sub(lambda m: m.group(1).replace(",", ""), text)
    text = _POUNDS_RE.sub(r"\1 pounds", text)
    text = _DOLLARS_RE.sub(_expand_dollars, text)
    text = _DECIMAL_RE.sub(lambda m: m.group(1).replace(".", " point "), text)
    text = _ORDINAL_RE.sub(lambda m: ordinal_to_words(int(m.group(1))), text)
    text = _NUMBER_RE.sub(_expand_number, text)
    return text
