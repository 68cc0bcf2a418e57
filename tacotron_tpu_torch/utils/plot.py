"""Alignment heatmap plotting: a copy of the JAX package's ``utils/plot.py``
(the reference's ``utils/plot.py``).

X-axis ticks show the decoded input symbols; the plot is cropped to the true
input length.  matplotlib is imported when a plot is drawn, not when this
module is imported: the port's driver and synthesizer import this module on
machines without matplotlib, where :func:`save_alignment_png` logs the
skipped image and the callers go on writing the wav and the ``.npy``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..text import sequence_to_text
from .infolog import log


_KOREAN_FONT: Optional[str] = None


def _pyplot():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError(
            "plot_alignment needs matplotlib, which is not installed") from e
    return plt


def _korean_font() -> Optional[str]:
    """Best available Hangul-capable font family, or None.

    The reference ships NanumBarunGothic.ttf; here we pick up whatever CJK
    font the host has (Noto/Nanum/Malgun are common) so tick labels render
    as Hangul rather than tofu boxes where possible — and degrade silently
    where not."""
    global _KOREAN_FONT
    if _KOREAN_FONT is None:
        from matplotlib import font_manager
        names = sorted({f.name for f in font_manager.fontManager.ttflist})
        # priority-ordered, Hangul-specific keywords — a bare "gothic"
        # would also match Latin-only fonts like URW/Century Gothic
        _KOREAN_FONT = ""
        for key in ("cjk kr", "nanum", "malgun", "batang", "gulim", "cjk"):
            hit = next((n for n in names if key in n.lower()), None)
            if hit:
                _KOREAN_FONT = hit
                break
    return _KOREAN_FONT or None


def plot_alignment(alignment: np.ndarray, path: str,
                   info: Optional[str] = None,
                   token_ids: Optional[Sequence[int]] = None,
                   input_length: Optional[int] = None) -> None:
    """Save an alignment heatmap.  ``alignment``: [T_in, T_dec].  Raises
    ImportError when matplotlib is not installed."""
    plt = _pyplot()
    alignment = np.asarray(alignment)
    if input_length is not None:
        alignment = alignment[:input_length]

    fig, ax = plt.subplots(figsize=(len(alignment) / 5, 5))
    im = ax.imshow(alignment.T, aspect="auto", origin="lower",
                   interpolation="none")
    fig.colorbar(im, ax=ax)

    if token_ids is not None:
        text = sequence_to_text(list(token_ids), skip_eos_and_pad=False,
                                combine_jamo=False)
        chars = list(text)[:alignment.shape[0]]
        ax.set_xticks(range(len(chars)))
        ax.set_xticklabels(chars, fontsize=6,
                           fontfamily=_korean_font() or "sans-serif")

    ax.set_xlabel("Encoder timestep" + (f"\n\n{info}" if info else ""))
    ax.set_ylabel("Decoder timestep")
    # Without a Hangul-capable font the ticks degrade to boxes, which is
    # fine for a diagnostic heatmap — don't spam warnings about it.
    import warnings
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Glyph .* missing")
        plt.tight_layout()
        plt.savefig(path, format="png", dpi=120)
    plt.close(fig)


def save_alignment_png(alignment: np.ndarray, path: str, **kwargs) -> bool:
    """:func:`plot_alignment`, or one log line naming the skipped ``path``
    when matplotlib is not installed.  Returns whether the PNG was
    written."""
    try:
        plot_alignment(alignment, path, **kwargs)
    except ImportError as e:
        log(f"alignment PNG {path} skipped: {e}")
        return False
    return True
