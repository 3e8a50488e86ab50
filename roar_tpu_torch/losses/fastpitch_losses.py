"""FastPitch regression losses (masked MSEs).

Port of roar_tpu/losses/fastpitch_losses.py: duration loss on log(dur + 1),
pitch and energy losses under the text mask, and the mel loss masked by
`spect_tgt != 0`.  Tensors are [B, T] or [B, T, C] (channels last).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from roar_tpu_torch.ops.lengths import mask_from_lens


def _masked_mean(loss: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def duration_loss(log_durs_predicted, durs_tgt, lens, loss_scale: float = 0.1):
    mask = mask_from_lens(lens, durs_tgt.shape[1]).float()
    log_durs_tgt = torch.log(durs_tgt.float() + 1.0)
    return loss_scale * _masked_mean((log_durs_predicted - log_durs_tgt).square(), mask)


def pitch_loss(pitch_predicted, pitch_tgt, lens, loss_scale: float = 0.1):
    mask = mask_from_lens(lens, pitch_tgt.shape[1]).float()
    ldiff = pitch_tgt.shape[1] - pitch_predicted.shape[1]
    if ldiff > 0:
        pitch_predicted = F.pad(pitch_predicted, (0, ldiff))
    return loss_scale * _masked_mean((pitch_tgt - pitch_predicted).square(), mask)


def energy_loss(energy_predicted, energy_tgt, lens, loss_scale: float = 0.1):
    if energy_tgt is None:
        return torch.zeros((), device=energy_predicted.device)
    mask = mask_from_lens(lens, energy_tgt.shape[1]).float()
    return loss_scale * _masked_mean((energy_tgt - energy_predicted).square(), mask)


def mel_loss(spect_predicted, spect_tgt):
    """spect_*: [B, T, n_mel]; mask = target != 0."""
    ldiff = spect_tgt.shape[1] - spect_predicted.shape[1]
    if ldiff > 0:
        spect_predicted = F.pad(spect_predicted, (0, 0, 0, ldiff))
    elif ldiff < 0:
        spect_predicted = spect_predicted[:, : spect_tgt.shape[1]]
    mask = (spect_tgt != 0).float()
    return _masked_mean((spect_predicted - spect_tgt).square(), mask)
