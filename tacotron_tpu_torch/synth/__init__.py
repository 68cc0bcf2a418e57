"""Synthesis layer: batched greedy decode, trimming, vocoding, CLI."""

from .synthesizer import (STEP_LADDER, Synthesizer, adaptive_max_steps,
                          attention_health, attention_trim_frames,
                          attention_trim_index, make_sharded_synthesis,
                          posthoc_attention, split_text, trim_silence_db)

__all__ = ["STEP_LADDER", "Synthesizer", "adaptive_max_steps",
           "attention_health", "attention_trim_frames",
           "attention_trim_index", "make_sharded_synthesis",
           "posthoc_attention", "split_text",
           "trim_silence_db"]
