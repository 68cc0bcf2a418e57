"""Synthesis layer: batched greedy decode, trimming, vocoding, CLI."""

from .synthesizer import (STEP_LADDER, Synthesizer, adaptive_max_steps,
                          attention_trim_frames, trim_silence_db)

__all__ = ["STEP_LADDER", "Synthesizer", "adaptive_max_steps",
           "attention_trim_frames", "trim_silence_db"]
