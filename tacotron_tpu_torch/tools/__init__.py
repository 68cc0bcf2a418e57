"""Corpus-construction toolchain (offline, host-side): copies of the JAX
package's ``tools/``.

Successors to the reference's data-prep utilities (its
``audio/silence.py``, ``recognition/``): silence-based utterance splitting,
ASR transcription (gated on the optional Google Cloud client), and fuzzy
ASR-to-script alignment producing ``alignment.json`` for the corpus
builder; with book-scale alignment, duration accounting, downloads,
scrapers and the multi-speaker evaluation harness (``speaker_eval``, the
one tool that runs the device path).
"""

from .alignment import align_text, similarity, search_optimal
from .silence import detect_nonsilent, split_on_silence

__all__ = ["align_text", "detect_nonsilent", "search_optimal", "similarity",
           "split_on_silence"]
