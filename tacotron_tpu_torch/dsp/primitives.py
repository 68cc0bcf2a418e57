"""Shared DSP constants: analysis windows and mel filterbanks.

Self-contained replacements for what the reference pulls from librosa
(``audio/__init__.py:99-144``): a periodic Hann window padded
to n_fft, and a Slaney-scale, area-normalized mel filterbank identical to
``librosa.filters.mel(sr, n_fft, n_mels)`` defaults (htk=False, norm='slaney'),
which is what the reference's ``_build_mel_basis`` produces.
"""

from __future__ import annotations

import functools

import numpy as np


def periodic_hann(win_length: int) -> np.ndarray:
    """'fftbins=True' Hann window, as used by librosa/scipy for STFT."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float64)


def padded_window(win_length: int, n_fft: int) -> np.ndarray:
    """Hann(win_length) centered inside an n_fft-long buffer."""
    if win_length > n_fft:
        raise ValueError("win_length must be <= n_fft")
    window = periodic_hann(win_length)
    pad = (n_fft - win_length) // 2
    out = np.zeros(n_fft, dtype=np.float64)
    out[pad:pad + win_length] = window
    return out


def _hz_to_mel(frequencies: np.ndarray) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, logarithmic above."""
    frequencies = np.asanyarray(frequencies, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = frequencies / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = frequencies >= min_log_hz
    mels = np.where(
        log_region,
        min_log_mel + np.log(np.maximum(frequencies, min_log_hz) / min_log_hz)
        / logstep,
        mels)
    return mels


def _mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asanyarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = mels >= min_log_mel
    freqs = np.where(
        log_region,
        min_log_hz * np.exp(logstep * (np.maximum(mels, min_log_mel)
                                       - min_log_mel)),
        freqs)
    return freqs


@functools.lru_cache(maxsize=8)
def mel_basis(sample_rate: int, n_fft: int, n_mels: int,
              fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """[n_mels, 1 + n_fft/2] triangular filterbank, Slaney-normalized."""
    if fmax is None:
        fmax = sample_rate / 2.0

    fft_freqs = np.linspace(0.0, sample_rate / 2.0, 1 + n_fft // 2)
    mel_points = np.linspace(_hz_to_mel(np.float64(fmin)),
                             _hz_to_mel(np.float64(fmax)), n_mels + 2)
    mel_freqs = _mel_to_hz(mel_points)

    fdiff = np.diff(mel_freqs)
    ramps = mel_freqs[:, None] - fft_freqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney-style area normalization
    enorm = 2.0 / (mel_freqs[2:n_mels + 2] - mel_freqs[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=8)
def inv_mel_basis(sample_rate: int, n_fft: int, n_mels: int) -> np.ndarray:
    """Pseudo-inverse used for mel -> linear magnitude recovery
    (reference ``audio/__init__.py:136-140``)."""
    return np.linalg.pinv(
        mel_basis(sample_rate, n_fft, n_mels).astype(np.float64)
    ).astype(np.float32)
