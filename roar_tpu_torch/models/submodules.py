"""Shared neural submodules: conditional LayerNorm and conditional input.

Port of roar_tpu/models/submodules.py:75-163.  Activations are [B, T, C].
LayerNorm epsilon is 1e-6, flax's default, not torch's 1e-5.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

SUPPORTED_CONDITION_TYPES = ("add", "concat", "layernorm")
LN_EPS = 1e-6


def check_support_condition_types(condition_types: Sequence[str]) -> None:
    for tp in condition_types:
        if tp not in SUPPORTED_CONDITION_TYPES:
            raise ValueError(f"Unknown conditioning type {tp}")


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
