"""Plain PyTorch reference of the vocoder and the wire: a normalized linear
spectrogram to the waveform a client receives.

Denormalize (dB in [min_level_db, 0] plus ref_level_db, to amplitude),
raise to ``power``, Griffin-Lim from zero phase (Hann-windowed frames and
the window-sum-square normalized overlap-add; with momentum a != 0 the fast
Griffin-Lim ``t_n = P(y_n); y_{n+1} = t_n + a (t_n - t_{n-1})``) at the
precision the configuration's engine states: each real DFT as half-size
products (decimation in frequency: the frame's two halves summed against
the even bins, subtracted against the odd ones) with bf16 operands and
float32 sums (``precision="fp8"``, the control, rounds the same operands
and products to float8 e4m3); inverse
pre-emphasis 1 / (1 - coef z^-1) applied in float64, then the wire: peak
normalization, int16 samples and the peak's dB in hundredths.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def hann_padded(win_length: int, n_fft: int, device) -> torch.Tensor:
    n = torch.arange(win_length, dtype=torch.float64, device=device)
    w = 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / win_length)
    out = torch.zeros(n_fft, dtype=torch.float64, device=device)
    pad = (n_fft - win_length) // 2
    out[pad:pad + win_length] = w
    return out


#: the longest decode the carried (fused) iteration takes at n_fft 2048;
#: longer ones run the batched engine
MAX_FUSED_FRAMES = 383


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 with one scale per tensor (its peak at
    448), back in float32: the control's precision."""
    scale = torch.clamp(x.abs().amax(), min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class GriffinLim:
    """Griffin-Lim at the precision of the configuration's engine for
    ``n_frames`` frames.

    ``engine="half"`` (the batched engine): each iteration reflect-pads the
    centered signal, frames it, and inverts each product rounded to bf16,
    with the Hermitian weights in the inverse matrices.  ``engine="fused"``
    (the carried iteration, up to :data:`MAX_FUSED_FRAMES` frames): the
    full-length overlap-added signal is carried between iterations and
    framed without padding, the windowed frames and the projected spectra
    are rounded to bf16, the Hermitian weights are folded into the target
    magnitudes, and the inverse products stay float32."""

    def __init__(self, audio: dict, n_frames: int, device,
                 precision: str = "bf16", engine: str = "half"):
        if precision not in ("bf16", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        if engine not in ("half", "fused"):
            raise ValueError(f"unknown engine {engine!r}")
        self.r = round_bf16 if precision == "bf16" else round_fp8
        self.engine = engine
        self.n_fft = (audio["num_freq"] - 1) * 2
        self.hop = int(audio["frame_shift_ms"] / 1000 * audio["sample_rate"])
        win = int(audio["frame_length_ms"] / 1000 * audio["sample_rate"])
        self.n_frames = n_frames
        self.num_samples = (n_frames - 1) * self.hop
        self.out_len = self.n_fft + self.hop * (n_frames - 1)
        w64 = hann_padded(win, self.n_fft, device)
        self.window = w64.float()
        ones = torch.ones(1, self.n_fft, n_frames, dtype=torch.float64,
                          device=device)
        wss = F.fold(ones * (w64 ** 2)[None, :, None], (1, self.out_len),
                     (1, self.n_fft), stride=(1, self.hop))[0, 0, 0]
        wss[wss < 1e-10] = 1.0
        self.wss = wss.float()
        self.inv_wss = (1.0 / wss).float()
        # half-size DFT matrices, in float64, then float32, then rounded
        N, M = self.n_fft, self.n_fft // 2
        n = torch.arange(M, dtype=torch.float64, device=device)[:, None]
        even = 2.0 * math.pi * n * (2 * torch.arange(
            M // 2 + 1, dtype=torch.float64, device=device))[None] / N
        odd = 2.0 * math.pi * n * (2 * torch.arange(
            M // 2, dtype=torch.float64, device=device) + 1)[None] / N
        w = torch.full((M // 2 + 1,), 2.0, dtype=torch.float64,
                       device=device)
        w[0] = w[-1] = 1.0
        self.w_even = (w / N).float()
        self.w_odd = 2.0 / N

        def b(x):
            return self.r(x.float())

        self.fwd = [b(torch.cos(even)), b(-torch.sin(even)),
                    b(torch.cos(odd)), b(-torch.sin(odd))]
        self.inv = [b((w * torch.cos(even) / N).T),
                    b((w * -torch.sin(even) / N).T),
                    b((2.0 * torch.cos(odd) / N).T),
                    b((2.0 * -torch.sin(odd) / N).T)]

    def rounded_product(self, a: torch.Tensor, b: torch.Tensor
                        ) -> torch.Tensor:
        """``a @ b`` of rounded operands, the result rounded: on the card
        a bf16 matrix product (float32 sums, a bf16 result)."""
        if a.is_cuda and self.r is round_bf16:
            return (a.to(torch.bfloat16) @ b.to(torch.bfloat16)).float()
        return self.r(self.r(a) @ b)

    def ola(self, frames: torch.Tensor) -> torch.Tensor:
        """[B, T, n_fft] frames -> windowed, normalized full signal (the
        fused engine multiplies by the normalizer's reciprocal)."""
        sig = F.fold((frames * self.window).transpose(1, 2),
                     (1, self.out_len), (1, self.n_fft),
                     stride=(1, self.hop))[:, 0, 0]
        if self.engine == "fused":
            return sig * self.inv_wss
        return sig / self.wss

    def center(self, full: torch.Tensor) -> torch.Tensor:
        start = self.n_fft // 2
        return full[:, start:start + self.num_samples]

    def frames(self, y: torch.Tensor) -> torch.Tensor:
        """Centered, reflect-padded, windowed frames of [B, S]."""
        half = self.n_fft // 2
        padded = F.pad(y[:, None, :], (half, half), mode="reflect")[:, 0]
        return padded.unfold(-1, self.n_fft, self.hop)[:, :self.n_frames] \
            * self.window

    def dft(self, frames: torch.Tensor):
        """[R, n_fft] -> (even re, even im, odd re, odd im)."""
        M = self.n_fft // 2
        u = self.r(frames[:, :M] + frames[:, M:])
        v = self.r(frames[:, :M] - frames[:, M:])
        er, ei, o_r, oi = self.fwd
        return u @ er, u @ ei, v @ o_r, v @ oi

    def idft_half(self, xe_r, xe_i, xo_r, xo_i) -> torch.Tensor:
        ur, ui, vr, vi = self.inv
        u = self.rounded_product(xe_r, ur) + self.rounded_product(xe_i, ui)
        v = self.rounded_product(xo_r, vr) + self.rounded_product(xo_i, vi)
        return torch.cat([u + v, u - v], dim=1)

    def idft_fused(self, xe_r, xe_i, xo_r, xo_i) -> torch.Tensor:
        er, ei, o_r, oi = self.fwd
        u = xe_r @ er.T + xe_i @ ei.T
        v = xo_r @ o_r.T + xo_i @ oi.T
        return torch.cat([u + v, u - v], dim=1)

    def __call__(self, magnitude: torch.Tensor, iters: int,
                 momentum: float) -> torch.Tensor:
        B, T, _ = magnitude.shape
        mag = magnitude.reshape(B * T, -1)
        mag_e, mag_o = mag[:, 0::2], mag[:, 1::2]
        fused = self.engine == "fused"
        if fused:
            mag_e, mag_o = mag_e * self.w_even, mag_o * self.w_odd

        def project(re, im, target):
            s = target * torch.rsqrt(torch.clamp(re * re + im * im,
                                                 min=1e-16))
            if fused:
                return self.r(re * s), self.r(im * s)
            return s * re, s * im

        def step(y):
            if fused:
                fr = self.r(y.unfold(-1, self.n_fft, self.hop)[:, :T]
                            * self.window)
            else:
                fr = self.frames(y)
            er, ei, o_r, oi = self.dft(fr.reshape(B * T, -1))
            er, ei = project(er, ei, mag_e)
            o_r, oi = project(o_r, oi, mag_o)
            inv = self.idft_fused if fused else self.idft_half
            full = self.ola(inv(er, ei, o_r, oi).reshape(B, T, -1))
            return full if fused else self.center(full)

        if fused:
            zero = torch.zeros_like
            y = self.ola(self.idft_fused(
                self.r(mag_e), zero(mag_e), self.r(mag_o),
                zero(mag_o)).reshape(B, T, -1))
        else:
            y = self.center(self.ola(self.idft_half(
                mag_e, torch.zeros_like(mag_e), mag_o,
                torch.zeros_like(mag_o)).reshape(B, T, -1)))
        t_prev = y
        for _ in range(iters):
            t = step(y)
            y = t if momentum == 0.0 else t + momentum * (t - t_prev)
            t_prev = t
        return self.center(y) if fused else y


def inv_preemphasis(x: torch.Tensor, coef: float) -> torch.Tensor:
    """1 / (1 - coef z^-1) as an FIR of the impulse response's first 1500
    taps (coef**1500 is far below float32 resolution for 0.97), in
    float64."""
    if coef == 0.0:
        return x
    S = x.shape[-1]
    k = coef ** torch.arange(1500, dtype=torch.float64, device=x.device)
    n = 1 << (S + 1500 - 2).bit_length()
    y = torch.fft.irfft(torch.fft.rfft(x.double(), n) * torch.fft.rfft(k, n),
                        n)
    return y[..., :S].float()


@torch.no_grad()
def spectrogram_to_waveform(linear: torch.Tensor, audio: dict, iters: int,
                            momentum: float,
                            precision: str = "bf16") -> torch.Tensor:
    """Normalized linear spectrograms [B, T, F] -> float waveforms
    [B, (T - 1) * hop], through the engine the configuration's vocoder
    runs for T frames on this device."""
    db = (torch.clamp(linear, 0.0, 1.0) * -audio["min_level_db"]
          + audio["min_level_db"] + audio["ref_level_db"])
    amp = torch.pow(10.0, db * 0.05) ** audio["power"]
    # the configuration's engine "auto": the carried iteration on the card
    # up to MAX_FUSED_FRAMES frames, the batched engine otherwise
    fused = linear.is_cuda and linear.shape[1] <= MAX_FUSED_FRAMES
    engine = "fused" if fused else "half"
    gl = GriffinLim(audio, linear.shape[1], linear.device, precision, engine)
    return inv_preemphasis(gl(amp, iters, momentum), audio["preemphasis"])


def int16_wire(wavs: torch.Tensor) -> torch.Tensor:
    """What a client reads back from the int16 wire: each row scaled so its
    peak (at least 0.01) is 32767, truncated to int16, then scaled back by
    the peak's dB carried in hundredths."""
    peak = torch.clamp(wavs.abs().amax(dim=1, keepdim=True), min=0.01)
    denom_q = torch.round(20.0 * torch.log10(peak) * 100.0)
    q = torch.clamp(wavs * (32767.0 / peak), -32768, 32767).to(torch.int16)
    return q.float() * (10.0 ** (denom_q / 100.0 / 20.0) / 32767.0)

