"""FastPitch "FFT" transformer blocks, for serving and training.

Port of roar_tpu/models/transformer.py: sinusoidal positions, `MultiHeadAttn`,
`PositionwiseConvFF`, `TransformerLayer`, `FFTransformerDecoder` and
`FFTransformerEncoder`.  Activations are [B, T, C] and attention heads
[B, T, H, D], as in the JAX package.  `dropout`, `dropatt` and `dropemb` act
in training mode only (`submodules.Dropout`).

Attention has two paths, as in JAX:
- `use_flash=True`: `ops.flash_attention.flash_self_attention`, the CUDA
  kernels on a CUDA tensor, forward and backward (segment semantics: pad
  queries see pad keys);
- otherwise the plain einsum path with an additive -1e9 key mask.
Both give the same valid rows; pad rows are zeroed by the layer's mask.
The flash kernels cannot drop attention probabilities, so, as in JAX
(roar_tpu/models/transformer.py:165-166), `use_flash` with `dropatt > 0`
takes the einsum path while the module is in training mode.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from roar_tpu_torch.models.submodules import (
    ConditionalInput,
    ConditionalLayerNorm,
    Conv1d,
    Dropout,
    Embedding,
    Linear,
)
from roar_tpu_torch.ops.flash_attention import flash_self_attention

_MASK_NEG = -1e9


@functools.lru_cache(maxsize=64)
def sinusoidal_positional_embedding(length: int, d_model: int, device=None,
                                    dtype=torch.float32) -> torch.Tensor:
    """[length, d_model] = concat(sin(pos * inv_freq), cos(pos * inv_freq)),
    computed in float64 on the host as the JAX package does.  Cached: the
    serving buckets ask for the same few lengths on every request.  Callers
    must not modify the result."""
    inv_freq = 1.0 / (10000.0 ** (np.arange(0.0, d_model, 2.0) / d_model))
    sinusoid = np.outer(np.arange(length, dtype=np.float64), inv_freq)
    emb = np.concatenate([np.sin(sinusoid), np.cos(sinusoid)], axis=-1)
    return torch.as_tensor(emb, dtype=dtype, device=device)


def conv1d_btc(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """Apply a channels-first Conv1d to a [B, T, C] tensor."""
    return conv(x.transpose(1, 2)).transpose(1, 2)


class MultiHeadAttn(nn.Module):
    """Fused-QKV self-attention with post (or pre) conditional LayerNorm."""

    def __init__(self, n_head: int, d_model: int, d_head: int, pre_lnorm: bool = False,
                 condition_types: Sequence[str] = (), use_rope: bool = False,
                 use_flash: bool = False, dropout: float = 0.0, dropatt: float = 0.0):
        super().__init__()
        if use_rope:
            raise NotImplementedError("RoPE attention is not ported yet")
        self.n_head, self.d_head = n_head, d_head
        self.pre_lnorm, self.use_flash = pre_lnorm, use_flash
        self.scale = 1.0 / math.sqrt(d_head)
        self.qkv_net = Linear(d_model, 3 * n_head * d_head)
        self.o_net = Linear(n_head * d_head, d_model, bias=False)
        self.layer_norm = ConditionalLayerNorm(d_model, d_model, condition_types)
        self.drop = Dropout(dropout)
        self.dropatt = Dropout(dropatt)

    def attention_path(self) -> str:
        """"flash" or "einsum": the path `forward` takes in the module's
        present mode."""
        drop_active = self.dropatt.rate > 0.0 and self.training
        return "flash" if self.use_flash and not drop_active else "einsum"

    def forward(self, x, key_mask=None, conditioning=None):
        residual = x
        if self.pre_lnorm:
            x = self.layer_norm(x, conditioning)
        b, t, _ = x.shape
        q, k, v = (z.reshape(b, t, self.n_head, self.d_head).contiguous()
                   for z in self.qkv_net(x).chunk(3, dim=-1))
        if self.attention_path() == "flash":
            attn = flash_self_attention(q, k, v, key_mask, self.scale)
        else:
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * self.scale
            if key_mask is not None:
                scores = scores + torch.where(key_mask[:, None, None, :], 0.0,
                                              _MASK_NEG).to(scores.dtype)
            probs = self.dropatt(torch.softmax(scores, dim=-1))
            attn = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        out = self.drop(self.o_net(attn.reshape(b, t, self.n_head * self.d_head)))
        if self.pre_lnorm:
            return residual + out
        return self.layer_norm(residual + out, conditioning)


class PositionwiseConvFF(nn.Module):
    """Conv1d(k) -> ReLU -> Conv1d(k) with "SAME" padding, residual and
    conditional LayerNorm."""

    def __init__(self, d_model: int, d_inner: int, kernel_size: int,
                 pre_lnorm: bool = False, condition_types: Sequence[str] = (),
                 dropout: float = 0.0):
        super().__init__()
        self.pre_lnorm = pre_lnorm
        self.conv1 = Conv1d(d_model, d_inner, kernel_size, padding="same")
        self.conv2 = Conv1d(d_inner, d_model, kernel_size, padding="same")
        self.layer_norm = ConditionalLayerNorm(d_model, d_model, condition_types)
        self.drop = Dropout(dropout)

    def _core(self, x):
        return self.drop(conv1d_btc(self.conv2, F.relu(conv1d_btc(self.conv1, x))))

    def forward(self, x, conditioning=None):
        if self.pre_lnorm:
            return x + self._core(self.layer_norm(x, conditioning))
        return self.layer_norm(x + self._core(x), conditioning)


class TransformerLayer(nn.Module):
    def __init__(self, n_head: int, d_model: int, d_head: int, d_inner: int,
                 kernel_size: int, pre_lnorm: bool = False,
                 condition_types: Sequence[str] = (), use_rope: bool = False,
                 use_flash: bool = False, dropout: float = 0.0, dropatt: float = 0.0):
        super().__init__()
        self.dec_attn = MultiHeadAttn(n_head, d_model, d_head, pre_lnorm,
                                      condition_types, use_rope, use_flash, dropout, dropatt)
        self.pos_ff = PositionwiseConvFF(d_model, d_inner, kernel_size, pre_lnorm,
                                         condition_types, dropout)

    def forward(self, x, mask, conditioning=None):
        # mask: [B, T, 1] float, 1 = valid
        out = self.dec_attn(x, key_mask=mask[..., 0] > 0, conditioning=conditioning)
        out = self.pos_ff(out * mask, conditioning)
        return out * mask


class FFTransformerDecoder(nn.Module):
    """Positional embedding + conditional input + a stack of TransformerLayers
    over pre-embedded input."""

    def __init__(self, n_layer: int, n_head: int, d_model: int, d_head: int,
                 d_inner: int, kernel_size: int, pre_lnorm: bool = False,
                 condition_types: Sequence[str] = (), use_rope: bool = False,
                 use_flash: bool = False, dropout: float = 0.0, dropatt: float = 0.0,
                 dropemb: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.cond_input = ConditionalInput(d_model, d_model, condition_types)
        self.dropemb = Dropout(dropemb)
        self.layers = nn.ModuleList(
            TransformerLayer(n_head, d_model, d_head, d_inner, kernel_size, pre_lnorm,
                             condition_types, use_rope, use_flash, dropout, dropatt)
            for _ in range(n_layer))

    def attention_path(self) -> str:
        return self.layers[0].dec_attn.attention_path() if len(self.layers) else "none"

    def forward(self, x, mask, conditioning=None):
        pos = sinusoidal_positional_embedding(x.shape[1], self.d_model, x.device, x.dtype)
        x = self.dropemb(self.cond_input(x + pos[None] * mask, conditioning))
        for layer in self.layers:
            x = layer(x, mask, conditioning)
        return x, mask


class FFTransformerEncoder(nn.Module):
    """Token embedding (the padding token embeds to zero and defines the mask)
    followed by an FFTransformerDecoder stack."""

    def __init__(self, n_layer: int, n_head: int, d_model: int, d_head: int,
                 d_inner: int, kernel_size: int, n_embed: int,
                 d_embed: Optional[int] = None, padding_idx: int = 0,
                 pre_lnorm: bool = False, condition_types: Sequence[str] = (),
                 use_rope: bool = False, use_flash: bool = False, dropout: float = 0.0,
                 dropatt: float = 0.0, dropemb: float = 0.0):
        super().__init__()
        self.padding_idx = padding_idx
        self.word_emb = Embedding(n_embed, d_embed or d_model)
        self.stack = FFTransformerDecoder(n_layer, n_head, d_model, d_head, d_inner,
                                          kernel_size, pre_lnorm, condition_types,
                                          use_rope, use_flash, dropout, dropatt, dropemb)

    def embed(self, tokens):
        """(embeddings with the padding token's zeroed [B, T, C], mask [B, T, 1])."""
        mask = (tokens != self.padding_idx)[..., None]
        emb = self.word_emb(tokens)
        mask = mask.to(emb.dtype)
        return emb * mask, mask

    def forward(self, tokens, conditioning=None):
        emb, mask = self.embed(tokens)
        return self.stack(emb, mask, conditioning)
