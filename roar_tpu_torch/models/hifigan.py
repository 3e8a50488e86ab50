"""HiFi-GAN generator, inference only.

Port of roar_tpu/models/hifigan.py:236-322 (`ResBlock1`, `ResBlock2`,
`Generator`): conv_pre -> [leaky ReLU, transposed-conv upsample, mean of the
multi-receptive-field resblocks] x N -> leaky ReLU(0.01) -> conv_post -> tanh.

The JAX modules wrap every conv in flax `nn.WeightNorm`.  The port holds
plain conv weights: training/convert.py folds scale * v / ||v|| once, at load.
Internally the generator runs channels-first [B, C, T]; its input is the
JAX layout, a mel [B, T, n_mel], and its output audio [B, T * hop].

Geometry: flax `ConvTranspose(padding="SAME")` with stride u and kernel k
gives T * u samples; torch's ConvTranspose1d matches it with padding
(k - u) // 2 and a spatially flipped kernel (roar_tpu/training/convert.py:192-199),
which requires k - u to be even.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1
POST_SLOPE = 0.01  # before conv_post the JAX generator uses leaky_relu's default


def _same_conv(channels_in: int, channels_out: int, kernel_size: int, dilation: int = 1):
    return nn.Conv1d(channels_in, channels_out, kernel_size, dilation=dilation, padding="same")


class ResBlock1(nn.Module):
    """Two-conv residual units with dilated first convs."""

    def __init__(self, channels: int, kernel_size: int, dilation: Sequence[int]):
        super().__init__()
        self.convs1 = nn.ModuleList(
            _same_conv(channels, channels, kernel_size, d) for d in dilation)
        self.convs2 = nn.ModuleList(_same_conv(channels, channels, kernel_size) for _ in dilation)

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + c2(F.leaky_relu(c1(F.leaky_relu(x, LRELU_SLOPE)), LRELU_SLOPE))
        return x


class ResBlock2(nn.Module):
    """Single-conv residual units."""

    def __init__(self, channels: int, kernel_size: int, dilation: Sequence[int]):
        super().__init__()
        self.convs = nn.ModuleList(_same_conv(channels, channels, kernel_size, d) for d in dilation)

    def forward(self, x):
        for c in self.convs:
            x = x + c(F.leaky_relu(x, LRELU_SLOPE))
        return x


class Generator(nn.Module):
    """mel [B, T, n_mel] -> audio [B, T * prod(upsample_rates)]."""

    def __init__(self, resblock: int = 1, upsample_rates: Sequence[int] = (8, 8, 2, 2),
                 upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
                 upsample_initial_channel: int = 512,
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
                 initial_input_size: int = 80):
        super().__init__()
        self.upsample_factor = int(np.prod(upsample_rates))
        block_cls = ResBlock1 if resblock == 1 else ResBlock2
        ch = upsample_initial_channel
        self.conv_pre = _same_conv(initial_input_size, ch, 7)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for u, k in zip(upsample_rates, upsample_kernel_sizes):
            if (k - u) % 2:
                raise ValueError(f"upsample kernel {k} and rate {u}: k - u must be even")
            self.ups.append(nn.ConvTranspose1d(ch, ch // 2, k, stride=u, padding=(k - u) // 2))
            ch //= 2
            self.resblocks.append(nn.ModuleList(
                block_cls(ch, rk, rd)
                for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes)))
        self.conv_post = _same_conv(ch, 1, 7)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.conv_pre(mel.transpose(1, 2))
        for up, blocks in zip(self.ups, self.resblocks):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            xs = blocks[0](x)
            for block in blocks[1:]:
                xs = xs + block(x)
            x = xs / len(blocks)
        x = self.conv_post(F.leaky_relu(x, POST_SLOPE))
        return torch.tanh(x)[:, 0]
