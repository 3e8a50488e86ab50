"""Rotary position embeddings (RoPE).

Port of roar_tpu/ops/rope.py: the cache is built in float64 numpy and kept as
float32, the rotation is the half-split form (channel i pairs with channel
i + D/2).  Partial rotary (`rope_n_elem` < head size) is the caller's slice:
`models/gpt.py` rotates the first `rope_n_elem` channels and passes the rest
through.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=16)
def build_rope_cache(seq_len: int, n_elem: int, base: float = 10000.0,
                     condense_ratio: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) float32 arrays of shape [seq_len, n_elem // 2].

    `condense_ratio` > 1 is position interpolation: positions are divided by
    it, so a longer window reuses the rotation range the model was trained on."""
    theta = 1.0 / (base ** (np.arange(0, n_elem, 2, dtype=np.float64) / n_elem))
    seq = np.arange(seq_len, dtype=np.float64) / condense_ratio
    angles = np.outer(seq, theta)  # [T, n_elem / 2]
    return np.cos(angles).astype(np.float32), np.sin(angles).astype(np.float32)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs of head-dim channels.  x: [B, T, H, D] (D even); cos/sin:
    [T, D/2] float32.  The rotation is computed in float32 and the result
    comes back in x's type."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
