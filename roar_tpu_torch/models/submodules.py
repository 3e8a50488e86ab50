"""Shared neural submodules: `ConvNorm`, conditional LayerNorm, conditional
input, and the dropout the training modules share.

Port of roar_tpu/models/submodules.py:54-163.  Activations are [B, T, C].
LayerNorm epsilon is 1e-6, flax's default, not torch's 1e-5.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

SUPPORTED_CONDITION_TYPES = ("add", "concat", "layernorm")
LN_EPS = 1e-6
XAVIER_GAINS = {"linear": 1.0, "relu": 2.0 ** 0.5, "tanh": 5.0 / 3.0, "sigmoid": 1.0}


def trunc_normal_(t: torch.Tensor, std: float, generator: Optional[torch.Generator]) -> None:
    """Fill `t` from jax's truncated normal at +-2 sigma, rescaled to the asked
    std (what flax's lecun-normal draws).  The numbers are drawn on the
    generator's device (the CPU when there is none)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = lo + (1.0 - 2.0 * lo) * torch.rand(
        t.shape, generator=generator, device=None if generator is None else generator.device)
    t.copy_(torch.erfinv(2.0 * u - 1.0) * (math.sqrt(2.0) * std / 0.87962566103423978))


def check_support_condition_types(condition_types: Sequence[str]) -> None:
    for tp in condition_types:
        if tp not in SUPPORTED_CONDITION_TYPES:
            raise ValueError(f"Unknown conditioning type {tp}")


class Dropout(nn.Module):
    """flax `nn.Dropout`: in training mode each element is kept with
    probability 1 - rate and scaled by 1 / (1 - rate); the identity in eval
    mode or at rate 0.  The mask comes from `generator` (on the input's
    device) when one was set with `set_dropout_generator`, else from torch's
    default generator of that device."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or self.rate <= 0.0:
            return x
        keep = torch.rand(x.shape, device=x.device, generator=self.generator) >= self.rate
        return x * keep.to(x.dtype) / (1.0 - self.rate)


def set_dropout_generator(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Make every `Dropout` under `module` draw its masks from `generator`."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class ConvNorm(nn.Module):
    """1-D conv over [B, T, C] with "same" padding
    (roar_tpu/models/submodules.py:54; `w_init_gain` names the xavier gain
    its initialiser uses)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 1,
                 w_init_gain: str = "linear"):
        super().__init__()
        self.w_init_gain = w_init_gain
        self.conv = nn.Conv1d(in_channels, features, kernel_size, padding="same")

    def forward(self, x):
        return self.conv(x.transpose(1, 2)).transpose(1, 2)


class ConditionalLayerNorm(nn.Module):
    """LayerNorm whose scale and shift are linear maps of a conditioning
    vector when 'layernorm' is in condition_types; a plain affine LayerNorm
    otherwise."""

    def __init__(self, hidden_dim: int, condition_dim: Optional[int] = None,
                 condition_types: Sequence[str] = ()):
        super().__init__()
        check_support_condition_types(condition_types)
        self.condition = "layernorm" in condition_types
        self.norm = nn.LayerNorm(hidden_dim, eps=LN_EPS, elementwise_affine=not self.condition)
        if self.condition:
            cdim = condition_dim or hidden_dim
            self.scale_proj = nn.Linear(cdim, hidden_dim)
            self.shift_proj = nn.Linear(cdim, hidden_dim)

    def forward(self, x, conditioning=None):
        y = self.norm(x)
        if self.condition:
            if conditioning is None:
                raise ValueError(
                    "conditioning required for ConditionalLayerNorm with "
                    "'layernorm' condition type")
            y = y * self.scale_proj(conditioning) + self.shift_proj(conditioning)
        return y


class ConditionalInput(nn.Module):
    """Adds and/or concatenates a (projected) conditioning embedding."""

    def __init__(self, hidden_dim: int, condition_dim: int,
                 condition_types: Sequence[str] = ()):
        super().__init__()
        check_support_condition_types(condition_types)
        self.add = "add" in condition_types
        self.concat = "concat" in condition_types
        if self.add and condition_dim != hidden_dim:
            self.add_proj = nn.Linear(condition_dim, hidden_dim)
        if self.concat:
            self.concat_proj = nn.Linear(hidden_dim + condition_dim, hidden_dim)

    def forward(self, x, conditioning=None):
        if not (self.add or self.concat):
            return x
        if conditioning is None:
            raise ValueError("conditioning required for ConditionalInput")
        if self.add:
            c = self.add_proj(conditioning) if hasattr(self, "add_proj") else conditioning
            x = x + c
        if self.concat:
            c = conditioning.expand(x.shape[0], x.shape[1], conditioning.shape[-1])
            x = self.concat_proj(torch.cat([x, c], dim=-1))
        return x
