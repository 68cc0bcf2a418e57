"""Book-scale ASR matching: locate each ASR clip transcript inside a long
source text.

A copy of the JAX package's ``tools/book_align.py``.  Successor to the
reference's ``audio/google_speech.py:69-380`` (ngram-based
matching of audiobook ASR output with merge/missing-word recovery), built on
a cleaner two-stage design:

1. **anchor**: word n-grams of the ASR hypothesis vote for candidate
   positions in the book via an inverted n-gram index — O(words), robust to
   scattered ASR errors;
2. **refine**: the best-voted window is trimmed with a character-level
   ``SequenceMatcher`` so the returned span starts/ends on the actually
   spoken words.

Clips whose votes are too weak (mumbled/out-of-book audio) come back with
``confidence < threshold`` and are down-weighted downstream exactly like
uncertain single-sentence alignments (``data/builder.py`` loss_coeff).
"""

from __future__ import annotations

import argparse
import json
import os
from collections import Counter, defaultdict
from difflib import SequenceMatcher
from typing import Dict, List, Optional, Sequence, Tuple

from .alignment import plain_text


def _words(text: str) -> List[str]:
    return [w for w in text.split() if w]


def _norm_word(word: str) -> str:
    return plain_text(word)


class BookIndex:
    """Inverted n-gram index over the book's word stream."""

    def __init__(self, book_text: str, n: int = 2):
        self.n = n
        self.words = _words(book_text)
        self.norm = [_norm_word(w) for w in self.words]
        self.index: Dict[Tuple[str, ...], List[int]] = defaultdict(list)
        for i in range(len(self.norm) - n + 1):
            self.index[tuple(self.norm[i:i + n])].append(i)

    def locate(self, asr_text: str) -> Tuple[int, int, float]:
        """Best (start_word, end_word, vote_coverage) for an ASR hypothesis.

        Each ASR n-gram that exists in the book votes for the implied window
        start; the modal start wins.  Coverage = fraction of ASR n-grams
        voting for the winner (within slack), the confidence signal.
        """
        asr_words = [_norm_word(w) for w in _words(asr_text)]
        n = self.n
        if len(asr_words) < n:
            return 0, 0, 0.0
        votes: Counter = Counter()
        total = 0
        for j in range(len(asr_words) - n + 1):
            gram = tuple(asr_words[j:j + n])
            total += 1
            for pos in self.index.get(gram, ()):
                votes[pos - j] += 1
        if not votes:
            return 0, 0, 0.0
        start, _ = votes.most_common(1)[0]
        slack = max(2, len(asr_words) // 4)
        support = sum(c for s, c in votes.items() if abs(s - start) <= slack)
        coverage = support / max(1, total)
        start = max(0, start)
        end = min(len(self.words), start + len(asr_words))
        return start, end, coverage

    def refine(self, start: int, end: int, asr_text: str,
               max_grow: int = 5) -> Tuple[int, int]:
        """Nudge the window boundaries to maximize character similarity."""
        target = plain_text(asr_text)

        def score(s, e):
            return SequenceMatcher(
                None, plain_text(" ".join(self.words[s:e])), target).ratio()

        best = (score(start, end), start, end)
        for ds in range(-max_grow, max_grow + 1):
            for de in range(-max_grow, max_grow + 1):
                s = max(0, start + ds)
                e = min(len(self.words), max(s + 1, end + de))
                sc = score(s, e)
                if sc > best[0]:
                    best = (sc, s, e)
        return best[1], best[2]


def align_book(recognition: Dict[str, str], book_text: str,
               ngram: int = 2,
               confidence_threshold: float = 0.3) -> Dict[str, object]:
    """{clip: asr_text} x book -> alignment.json-style mapping.

    Confident clips map to the book's exact wording (string); weak matches
    keep the raw ASR text as an uncertain single-element list.
    """
    index = BookIndex(book_text, ngram)
    result: Dict[str, object] = {}
    for clip, asr_text in recognition.items():
        if isinstance(asr_text, list):
            asr_text = asr_text[0] if asr_text else ""
        start, end, coverage = index.locate(asr_text)
        if coverage >= confidence_threshold and end > start:
            start, end = index.refine(start, end, asr_text)
            result[clip] = " ".join(index.words[start:end])
        else:
            result[clip] = [asr_text]
    return result


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        description="match ASR clip transcripts against a book text")
    parser.add_argument("--recognition_path", required=True)
    parser.add_argument("--book_path", required=True)
    parser.add_argument("--out_path", default=None)
    parser.add_argument("--ngram", type=int, default=2)
    parser.add_argument("--confidence_threshold", type=float, default=0.3)
    args = parser.parse_args(argv)

    with open(args.recognition_path) as fh:
        recognition = json.load(fh)
    with open(args.book_path) as fh:
        book_text = fh.read()
    result = align_book(recognition, book_text, args.ngram,
                        args.confidence_threshold)
    out_path = args.out_path or os.path.join(
        os.path.dirname(args.recognition_path), "alignment.json")
    with open(out_path, "w") as fh:
        json.dump(result, fh, ensure_ascii=False, indent=2)
    confident = sum(1 for v in result.values() if isinstance(v, str))
    print(f"[*] matched {len(result)} clips "
          f"({confident} confident, {len(result) - confident} uncertain)")


if __name__ == "__main__":
    main()
