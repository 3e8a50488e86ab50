"""HiFi-GAN losses (LSGAN + feature matching + L1 mel).

Port of roar_tpu/losses/hifigan_losses.py:
- feature_matching_loss: 2 * sum of mean |fmap_r - fmap_g|
- discriminator_loss: sum over discriminators of mean (1-r)^2 + mean g^2
- generator_loss: sum of mean (1-g)^2
- l1_mel_loss: unmasked mean
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def feature_matching_loss(fmap_r, fmap_g) -> torch.Tensor:
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl - gl))
    return loss * 2.0


def discriminator_loss(
    disc_real_outputs: Sequence[torch.Tensor],
    disc_generated_outputs: Sequence[torch.Tensor],
) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real_outputs, disc_generated_outputs):
        r = torch.mean(torch.square(1.0 - dr))
        g = torch.mean(torch.square(dg))
        loss = loss + r + g
        r_losses.append(r)
        g_losses.append(g)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    loss = 0.0
    gen_losses = []
    for dg in disc_outputs:
        one = torch.mean(torch.square(1.0 - dg))
        gen_losses.append(one)
        loss = loss + one
    return loss, gen_losses


def l1_mel_loss(spect_predicted: torch.Tensor, spect_tgt: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(spect_predicted - spect_tgt))
