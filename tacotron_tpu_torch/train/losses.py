"""Training losses: the counterparts of ``tacotron_tpu/train/losses.py``.

L1 on the mel and linear spectrograms, each weighted by a per-utterance
``loss_coeff``, with an optional "prioritized" re-weighting of the 165 Hz to
5 kHz linear bins.  Padding frames are not masked: the decoder learns to
emit zeros past an utterance's end, as in the reference.

With ``target_lengths`` the means run over the reference-equivalent frame
count ``round_up(max(target_lengths) + 1, r)`` (the reference pads each
batch to exactly that), so frames that exist only because the feeder pads
to a static bucket neither dilute the loss nor count in its denominator.
That count stays a device tensor: no host sync.

Under data parallelism (a ``DataShard`` passed as ``shard``) each rank
holds its rows of the global batch, and the denominators are the global
batch's: ``ref_len`` from the group's largest ``target_lengths``, the row
count ``local rows * shard.size``, the guided prior's step count summed
over the group.  A rank's loss is then its rows' numerator over the global
denominator, so the ranks' losses (and gradients) sum to the JAX step's.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def tacotron_loss(mel_outputs: torch.Tensor, linear_outputs: torch.Tensor,
                  mel_targets: torch.Tensor, linear_targets: torch.Tensor,
                  loss_coeff: Optional[torch.Tensor], train_config,
                  audio_config,
                  target_lengths: Optional[torch.Tensor] = None,
                  reduction_factor: int = 1,
                  shard=None) -> Dict[str, torch.Tensor]:
    """Returns ``loss`` (optimized), ``mel_loss``, ``linear_loss`` and
    ``loss_without_coeff`` (reported), as scalar tensors."""
    dtype = mel_outputs.dtype
    if loss_coeff is None:
        loss_coeff = torch.ones(mel_outputs.shape[0], dtype=dtype,
                                device=mel_outputs.device)
    coeff = loss_coeff[:, None, None].to(dtype)

    mel_l1 = torch.abs(mel_targets - mel_outputs)
    lin_l1 = torch.abs(linear_targets - linear_outputs)

    n_frames_padded = mel_targets.shape[1]
    if target_lengths is not None:
        r = max(1, int(reduction_factor))
        ref_len = torch.max(target_lengths)
        if shard is not None:
            ref_len = shard.max(ref_len)
        ref_len = ref_len + 1
        ref_len = torch.clamp((ref_len + r - 1) // r * r,
                              max=n_frames_padded)
        frames = torch.arange(n_frames_padded, device=mel_l1.device)
        frame_mask = (frames[None, :, None] < ref_len).to(dtype)
        denom_frames = ref_len.to(dtype)
    else:
        frame_mask = None
        denom_frames = float(n_frames_padded)
    batch = mel_l1.shape[0] * (1 if shard is None else shard.size)

    def _mean(x: torch.Tensor) -> torch.Tensor:
        """Mean over the reference-equivalent region [N, ref_len, D]."""
        total = torch.sum(x if frame_mask is None else x * frame_mask)
        return total / (batch * denom_frames * x.shape[-1])

    if train_config.prioritize_loss:
        nyquist = audio_config.sample_rate * 0.5
        lo = int(165 / nyquist * audio_config.num_freq)
        hi = int(5000 / nyquist * audio_config.num_freq)
        lin_priority = lin_l1[:, :, lo:hi]
        loss = (_mean(mel_l1 * coeff) + 0.5 * _mean(lin_l1 * coeff)
                + 0.5 * _mean(lin_priority * coeff))
        linear_loss = 0.5 * (_mean(lin_l1) + _mean(lin_priority))
    else:
        loss = _mean(mel_l1 * coeff) + _mean(lin_l1 * coeff)
        linear_loss = _mean(lin_l1)

    mel_loss = _mean(mel_l1)
    return {"loss": loss, "mel_loss": mel_loss, "linear_loss": linear_loss,
            "loss_without_coeff": mel_loss + linear_loss}


def guided_attention_loss(alignments: torch.Tensor,
                          input_lengths: torch.Tensor,
                          target_lengths: Optional[torch.Tensor],
                          reduction_factor: int,
                          sigma: float = 0.2, shard=None) -> torch.Tensor:
    """Soft-diagonal attention prior (DC-TTS eq. 3) with a mass anchor.

    ``alignments`` [N, T_in, T_dec].  Returns the off-diagonal attention
    mass per true decode step, ``mean_t sum_n A[n, t] * (1 - exp(-(n/N -
    t/T)^2 / (2 sigma^2)))``, plus the mass-conservation term ``mean_t (1 -
    sum_n A[n, t])^2``; both average over true decode steps only, with
    padding tokens and steps masked out.  The anchor keeps the monotonic
    attention from escaping the diagonal penalty by leaking its mass past
    the last token (the JAX docstring tells the history)."""
    N, T_in, T_dec = alignments.shape
    dev, dtype = alignments.device, alignments.dtype
    r = max(1, int(reduction_factor))
    if target_lengths is None:
        dec_steps = torch.full((N,), float(T_dec), device=dev)
    else:
        dec_steps = torch.clamp(
            torch.ceil(target_lengths.to(torch.float32) / r), 1.0,
            float(T_dec))
    in_len = input_lengths.to(torch.float32)

    n = torch.arange(T_in, dtype=torch.float32, device=dev)[None, :, None]
    t = torch.arange(T_dec, dtype=torch.float32, device=dev)[None, None, :]
    n_rel = n / torch.clamp(in_len - 1.0, min=1.0)[:, None, None]
    t_rel = t / torch.clamp(dec_steps - 1.0, min=1.0)[:, None, None]
    weight = 1.0 - torch.exp(-((n_rel - t_rel) ** 2)
                             / (2.0 * sigma * sigma))

    mask = ((n < in_len[:, None, None])
            & (t < dec_steps[:, None, None])).to(dtype)
    penalty = alignments * weight.to(dtype) * mask
    step_mask = (t[:, 0, :] < dec_steps[:, None]).to(dtype)
    n_steps = torch.sum(step_mask)
    if shard is not None:
        n_steps = shard.sum(n_steps)
    n_steps = torch.clamp(n_steps, min=1.0)
    diag = torch.sum(penalty) / n_steps

    mass = torch.sum(alignments * mask, dim=1)                 # [N, T_dec]
    mass_pen = torch.sum(((1.0 - mass) ** 2) * step_mask) / n_steps
    return diag + mass_pen
