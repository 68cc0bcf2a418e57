"""Host-side (numpy/scipy) DSP: a copy of the JAX package's ``dsp/host.py``.

The reference analysis chain (its ``audio/__init__.py:48-67``, librosa on the
CPU): preemphasis -> centered reflect-padded STFT -> |.| -> (mel) -> dB ->
normalize to [0, 1] against min_level_db, and its Griffin-Lim inversion.  The
port uses it to write corpora and for the train driver's sample dumps; the
training and serving hot paths use the tensor versions in ``chip.py``.
"""

from __future__ import annotations

import numpy as np
from scipy import signal as sp_signal
from scipy.io import wavfile

from ..config import AudioConfig
from .primitives import inv_mel_basis, mel_basis, padded_window


# ------------------------------------------------------------------- wav I/O

def load_audio(path: str, config: AudioConfig) -> np.ndarray:
    """Load a wav as float32 in [-1, 1], resampling to config.sample_rate."""
    rate, data = wavfile.read(path)
    if data.ndim > 1:
        data = data.mean(axis=1)
    if data.dtype == np.int16:
        audio = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        audio = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        audio = (data.astype(np.float32) - 128.0) / 128.0
    else:
        audio = data.astype(np.float32)
    if rate != config.sample_rate:
        audio = resample(audio, rate, config.sample_rate)
    return audio


def save_audio(audio: np.ndarray, path: str, config: AudioConfig,
               sample_rate: int | None = None) -> None:
    """Peak-normalize to int16 and write (reference ``audio/__init__.py:22-27``)."""
    audio = np.asarray(audio, dtype=np.float32)
    scaled = audio * (32767 / max(0.01, float(np.max(np.abs(audio)))))
    wavfile.write(path, sample_rate or config.sample_rate,
                  scaled.astype(np.int16))


def frame_rms(audio: np.ndarray, frame_length: int,
              hop_length: int) -> tuple[np.ndarray, np.ndarray]:
    """Strided frame matrix + per-frame RMS of a 1-D signal.

    Requires ``len(audio) >= frame_length``.
    Returns ``(frames [n_frames, frame_length], rms [n_frames])``.
    """
    n_frames = 1 + (len(audio) - frame_length) // hop_length
    idx = (np.arange(frame_length)[None, :]
           + hop_length * np.arange(n_frames)[:, None])
    frames = audio[idx]
    return frames, np.sqrt(np.mean(frames ** 2, axis=1))


def rms_db_below_peak(rms: np.ndarray) -> np.ndarray | None:
    """Per-frame level in dB relative to the peak frame RMS (floored at
    -200 dB); ``None`` for an all-silent signal (peak RMS == 0)."""
    ref = float(rms.max()) if rms.size else 0.0
    if ref <= 0:
        return None
    return 20.0 * np.log10(np.maximum(rms / ref, 1e-10))


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    gcd = np.gcd(orig_sr, target_sr)
    return sp_signal.resample_poly(
        audio, target_sr // gcd, orig_sr // gcd).astype(np.float32)


# ---------------------------------------------------------------- STFT core

def stft(y: np.ndarray, config: AudioConfig) -> np.ndarray:
    """Centered STFT, librosa semantics: reflect pad n_fft//2, periodic Hann
    of win_length zero-padded to n_fft.  Returns complex [n_freq, frames]."""
    n_fft = config.n_fft
    window = padded_window(config.win_length, n_fft)
    y = np.pad(y, n_fft // 2, mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // config.hop_length
    strides = (y.strides[0] * config.hop_length, y.strides[0])
    frames = np.lib.stride_tricks.as_strided(
        y, shape=(n_frames, n_fft), strides=strides)
    return np.fft.rfft(frames * window, axis=1).T


def istft(stft_matrix: np.ndarray, config: AudioConfig) -> np.ndarray:
    """Windowed overlap-add inverse with squared-window normalization,
    trimming the n_fft//2 center padding."""
    n_fft = config.n_fft
    hop = config.hop_length
    window = padded_window(config.win_length, n_fft)
    frames = np.fft.irfft(stft_matrix.T, n=n_fft, axis=1)
    n_frames = frames.shape[0]
    out_len = n_fft + hop * (n_frames - 1)
    out = np.zeros(out_len, dtype=np.float64)
    win_sum = np.zeros(out_len, dtype=np.float64)
    win_sq = window ** 2
    for t in range(n_frames):
        start = t * hop
        out[start:start + n_fft] += frames[t] * window
        win_sum[start:start + n_fft] += win_sq
    out[win_sum > 1e-10] /= win_sum[win_sum > 1e-10]
    return out[n_fft // 2: out_len - n_fft // 2].astype(np.float32)


# ------------------------------------------------------------- scaling chain

def preemphasis(x: np.ndarray, config: AudioConfig) -> np.ndarray:
    return sp_signal.lfilter([1, -config.preemphasis], [1], x)


def inv_preemphasis(x: np.ndarray, config: AudioConfig) -> np.ndarray:
    return sp_signal.lfilter([1], [1, -config.preemphasis], x)


def amp_to_db(x: np.ndarray) -> np.ndarray:
    return 20.0 * np.log10(np.maximum(1e-5, x))


def db_to_amp(x: np.ndarray) -> np.ndarray:
    return np.power(10.0, x * 0.05)


def normalize_db(S: np.ndarray, config: AudioConfig) -> np.ndarray:
    return np.clip((S - config.min_level_db) / -config.min_level_db, 0, 1)


def denormalize_db(S: np.ndarray, config: AudioConfig) -> np.ndarray:
    return (np.clip(S, 0, 1) * -config.min_level_db) + config.min_level_db


# ----------------------------------------------------------------- features

def spectrogram(y: np.ndarray, config: AudioConfig) -> np.ndarray:
    """Waveform -> normalized linear spectrogram [n_freq, frames]."""
    D = stft(preemphasis(y, config), config)
    S = amp_to_db(np.abs(D)) - config.ref_level_db
    return normalize_db(S, config)


def melspectrogram(y: np.ndarray, config: AudioConfig) -> np.ndarray:
    """Waveform -> normalized mel spectrogram [n_mels, frames]."""
    D = stft(preemphasis(y, config), config)
    basis = mel_basis(config.sample_rate, config.n_fft, config.num_mels)
    S = amp_to_db(basis @ np.abs(D))
    return normalize_db(S, config)


# ----------------------------------------------------------------- inversion

def griffin_lim(S: np.ndarray, config: AudioConfig,
                rng: np.random.Generator | None = None) -> np.ndarray:
    """Iterative phase reconstruction (reference ``audio/__init__.py:76-84``).

    ``rng=None`` starts from zero phase (the deterministic formulation of the
    reference's in-graph TF variant, ``audio/__init__.py:87-96``); passing a
    generator reproduces the numpy random-phase variant.
    """
    S = np.abs(S).astype(np.complex128)
    if rng is None:
        angles = np.ones_like(S)
    else:
        angles = np.exp(2j * np.pi * rng.random(S.shape))
    y = istft(S * angles, config)
    for _ in range(config.griffin_lim_iters):
        angles = np.exp(1j * np.angle(stft(y, config)))
        y = istft(S * angles, config)
    return y


def inv_spectrogram(spec: np.ndarray, config: AudioConfig) -> np.ndarray:
    """Normalized linear spectrogram [n_freq, frames] -> waveform."""
    S = db_to_amp(denormalize_db(spec, config) + config.ref_level_db)
    return inv_preemphasis(
        griffin_lim(S ** config.power, config), config).astype(np.float32)


def inv_melspectrogram(mel: np.ndarray, config: AudioConfig) -> np.ndarray:
    """Normalized mel spectrogram [n_mels, frames] -> waveform."""
    amp = db_to_amp(denormalize_db(mel, config))
    inv_basis = inv_mel_basis(config.sample_rate, config.n_fft, config.num_mels)
    S = np.maximum(1e-10, inv_basis @ amp)
    return inv_preemphasis(
        griffin_lim(S ** config.power, config), config).astype(np.float32)
