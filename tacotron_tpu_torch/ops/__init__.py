"""Recurrences, attention and the hand-written CUDA kernels."""
