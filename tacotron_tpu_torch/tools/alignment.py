"""Fuzzy alignment of ASR transcripts to source-script sentences.

A copy of the JAX package's ``tools/alignment.py``, successor to the
reference's ``recognition/alignment.py``: given an ASR
hypothesis per audio clip and the candidate sentences of the source script,
pick the best-matching sentence by ``difflib.SequenceMatcher`` ratio and
reconcile word boundaries.  Output is ``alignment.json`` mapping
``audio_path -> text`` — a plain string when confident, a single-element
list when not (which the corpus builder later turns into a reduced
``loss_coeff``; see ``data/builder.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import string
from difflib import SequenceMatcher
from typing import Dict, List, Optional, Sequence, Union


def plain_text(text: str) -> str:
    """Strip punctuation/whitespace for robust comparisons."""
    return "".join(ch for ch in text
                   if ch not in string.punctuation and not ch.isspace())


def similarity(text_a: str, text_b: str) -> float:
    """SequenceMatcher ratio on punctuation-stripped text
    (reference ``alignment.py:20-26``)."""
    return SequenceMatcher(None, plain_text(text_a),
                           plain_text(text_b)).ratio()


def _first_word_variants(text: str) -> List[str]:
    words = text.split()
    if len(words) > 1:
        return [words[0], words[0] + words[1]]
    return [words[0]] if words else []


def _merged_first_word_texts(text: str) -> List[str]:
    words = text.split()
    if len(words) > 2:
        return [text, " ".join([words[0] + words[1]] + words[2:])]
    if len(words) == 2:
        return [text, words[0] + words[1]]
    return [text]


def search_optimal(found_text: str, recognition_text: str) -> Optional[str]:
    """Reconcile the scripted sentence with the ASR hypothesis: trim the
    script to the span the ASR actually covers (the script may include
    words the clip does not; reference ``alignment.py:48-90``)."""
    if not recognition_text.split():
        return None
    if plain_text(recognition_text) in plain_text(found_text):
        return recognition_text

    found = False
    for candidate in _merged_first_word_texts(found_text):
        for first_word in _first_word_variants(recognition_text):
            if first_word in candidate:
                start = candidate.find(first_word)
                if candidate != found_text:
                    found_text = found_text[max(0, start - 1):].strip()
                else:
                    found_text = found_text[start:].strip()
                found = True
                break
        if found:
            break

    last_word = recognition_text.split()[-1]
    if last_word in found_text:
        end = found_text.find(last_word)
        tail = end + len(last_word)
        punct = ""
        if len(found_text) > tail and found_text[tail] in string.punctuation:
            punct = found_text[tail]
        found_text = found_text[:end] + last_word + punct
        found = True

    return found_text if found else None


_SENT_END = re.compile(r"[.?!]$")


def add_punctuation(text: str) -> str:
    return text if _SENT_END.search(text) else text + "."


def align_text(recognition_text: str, candidates: Sequence[str],
               score_threshold: float = 0.5
               ) -> Union[str, List[str], None]:
    """Best-matching candidate sentence for one ASR hypothesis.

    Returns a plain string when confidently aligned, ``[text]`` when kept
    but uncertain (drives loss_coeff down-weighting), or None to drop.
    (reference ``align_text_fn``, ``alignment.py:93-136``)
    """
    if not candidates:
        return [recognition_text]
    scores = sorted(((similarity(c, recognition_text), c)
                     for c in candidates), reverse=True)
    best_score, best = scores[0]
    second_score = scores[1][0] if len(scores) > 1 else -1.0

    if best_score > second_score and best_score >= score_threshold:
        aligned = search_optimal(best, recognition_text)
        if aligned is not None:
            return add_punctuation(aligned)
        if abs(len(plain_text(best))
               - len(plain_text(recognition_text))) > 10:
            return [recognition_text]
        return [add_punctuation(best), recognition_text]
    return [recognition_text]


def align_batch(recognition_path: str, script_path: str,
                out_path: Optional[str] = None,
                score_threshold: float = 0.5) -> Dict[str, object]:
    """recognition.json {audio: asr_text} x script (one sentence per line)
    -> alignment.json."""
    with open(recognition_path) as fh:
        recognition = json.load(fh)
    with open(script_path) as fh:
        candidates = [line.strip().replace('"', "").replace("'", "")
                      for line in fh if line.strip()]

    result: Dict[str, object] = {}
    for audio_path, asr_text in recognition.items():
        if isinstance(asr_text, list):
            asr_text = asr_text[0] if asr_text else ""
        aligned = align_text(asr_text, candidates, score_threshold)
        if aligned is not None:
            result[audio_path] = aligned

    if out_path is None:
        out_path = os.path.join(os.path.dirname(recognition_path),
                                "alignment.json")
    with open(out_path, "w") as fh:
        json.dump(result, fh, ensure_ascii=False, indent=2)
    return result


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        description="align ASR transcripts to script sentences")
    parser.add_argument("--recognition_path", required=True,
                        help="recognition.json from the ASR step")
    parser.add_argument("--script_path", required=True,
                        help="source script, one sentence per line")
    parser.add_argument("--out_path", default=None)
    parser.add_argument("--score_threshold", type=float, default=0.5)
    args = parser.parse_args(argv)

    result = align_batch(args.recognition_path, args.script_path,
                         args.out_path, args.score_threshold)
    confident = sum(1 for v in result.values() if isinstance(v, str))
    print(f"[*] aligned {len(result)} clips "
          f"({confident} confident, {len(result) - confident} uncertain)")


if __name__ == "__main__":
    main()
