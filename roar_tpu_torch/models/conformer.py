"""Conformer blocks: the encoder / decoder option of FastPitch and JETS.

Port of roar_tpu/models/conformer.py: `ConvolutionalModule`,
`PositionwiseFF`, `ConformerLayer`, `FFConformerDecoder` and
`FFConformerEncoder`.  A layer is FF(x0.5) -> MHA -> conv module (pointwise
-> GLU -> depthwise k -> LayerNorm -> SiLU -> pointwise) -> FF(x0.5) over
[B, T, C].  The conv module's norm is the JAX package's per-step LayerNorm
where the reference has BatchNorm1d.  Dropout acts in training mode only.

Kept as the JAX package has them:
- `ConformerLayer` hands the stack's `dropatt` to `MultiHeadAttn`'s OUTPUT
  dropout (the fourth positional argument there) and leaves its
  attention-probability dropout at 0.1, so every training-mode forward takes
  the einsum path whatever `use_flash` says; only deterministic forwards
  (`infer`, synthesis, serving) reach the flash kernels, and JETS validation,
  a training-mode forward as in the JAX runner, is not one of them;
- the attention block is post-norm, `LN(residual + attn)`, and the layer adds
  the residual to it once more;
- the conv module reads the padding rows, which the two attention paths fill
  differently, so the paths give other outputs near the padding;
- the conv module is always pre-norm, and the stacks have no `pre_lnorm`,
  adapters or remat: the factories in models/fastpitch.py do not pass them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch.nn.functional as F
from torch import nn

from roar_tpu_torch.models.submodules import (
    LN_EPS,
    ConditionalInput,
    ConditionalLayerNorm,
    Conv1d,
    Dropout,
    Embedding,
    LayerNorm,
    Linear,
)
from roar_tpu_torch.models.transformer import (
    MultiHeadAttn,
    TokenEncoder,
    conv1d_btc,
    sinusoidal_positional_embedding,
)

ATTN_PROB_DROPOUT = 0.1  # MultiHeadAttn's own default in the JAX package


class ConvolutionalModule(nn.Module):
    """Conformer convolution module over [B, T, C], pre-norm (the one form
    `ConformerLayer` builds)."""

    def __init__(self, d_model: int, kernel_size: int = 31, dropout: float = 0.1,
                 condition_types: Sequence[str] = ()):
        super().__init__()
        self.layer_norm = ConditionalLayerNorm(d_model, d_model, condition_types)
        self.pointwise_in = Conv1d(d_model, 2 * d_model, 1)
        self.depthwise = Conv1d(d_model, d_model, kernel_size, padding="same", groups=d_model)
        self.norm = LayerNorm(d_model, eps=LN_EPS)
        self.pointwise_out = Conv1d(d_model, d_model, 1)
        self.drop = Dropout(dropout)

    def forward(self, x, conditioning=None):
        z = F.glu(conv1d_btc(self.pointwise_in, self.layer_norm(x, conditioning)), dim=-1)
        z = F.silu(self.norm(conv1d_btc(self.depthwise, z)))
        return self.drop(conv1d_btc(self.pointwise_out, z))


class PositionwiseFF(nn.Module):
    """Linear -> SiLU -> Dropout -> Linear -> Dropout, with an unconditioned
    LayerNorm before (pre-norm) or after it."""

    def __init__(self, embed_dim: int, hidden_size: int, dropout_l1: float = 0.0,
                 dropout_l2: float = 0.0, pre_lnorm: bool = False):
        super().__init__()
        self.pre_lnorm = pre_lnorm
        self.layer_norm = ConditionalLayerNorm(embed_dim)
        self.linear_in = Linear(embed_dim, hidden_size)
        self.drop_l1 = Dropout(dropout_l1)
        self.linear_out = Linear(hidden_size, embed_dim)
        self.drop_l2 = Dropout(dropout_l2)

    def _core(self, z):
        return self.drop_l2(self.linear_out(self.drop_l1(F.silu(self.linear_in(z)))))

    def forward(self, x):
        if self.pre_lnorm:
            return self._core(self.layer_norm(x))
        return self.layer_norm(self._core(x))


class ConformerLayer(nn.Module):
    """FF(x0.5) -> MHA -> conv module -> FF(x0.5)."""

    def __init__(self, n_head: int, d_model: int, d_head: int, d_inner: int,
                 conv_kernel_size: int = 31, dropout: float = 0.1, dropout_att: float = 0.1,
                 condition_types: Sequence[str] = (), use_rope: bool = False,
                 use_flash: bool = False):
        super().__init__()
        self.ff1 = PositionwiseFF(d_model, d_inner, dropout_l1=dropout, pre_lnorm=True)
        self.self_attn = MultiHeadAttn(n_head, d_model, d_head, condition_types=condition_types,
                                       use_rope=use_rope, use_flash=use_flash,
                                       dropout=dropout_att, dropatt=ATTN_PROB_DROPOUT)
        self.convolutional_block = ConvolutionalModule(d_model, conv_kernel_size, dropout,
                                                       condition_types)
        self.ff2 = PositionwiseFF(d_model, d_inner, dropout_l1=dropout, dropout_l2=dropout,
                                  pre_lnorm=False)

    def forward(self, x, mask, conditioning=None):
        # mask: [B, T, 1] float, 1 = valid
        residual = self.ff1(x) * 0.5 + x
        residual = self.self_attn(residual, key_mask=mask[..., 0] > 0,
                                  conditioning=conditioning) + residual
        residual = self.convolutional_block(residual, conditioning) + residual
        return (self.ff2(residual) * 0.5 + residual) * mask


class FFConformerDecoder(nn.Module):
    """Positional embedding + conditional input + a stack of ConformerLayers
    over pre-embedded input."""

    def __init__(self, n_layer: int, n_head: int, d_model: int, d_head: int, d_inner: int,
                 kernel_size: int = 31, dropout: float = 0.1, dropatt: float = 0.1,
                 dropemb: float = 0.0, condition_types: Sequence[str] = (),
                 use_rope: bool = False, use_flash: bool = False):
        super().__init__()
        self.d_model = d_model
        self.cond_input = ConditionalInput(d_model, d_model, condition_types)
        self.dropemb = Dropout(dropemb)
        self.layers = nn.ModuleList(
            ConformerLayer(n_head, d_model, d_head, d_inner, kernel_size, dropout, dropatt,
                           condition_types, use_rope, use_flash)
            for _ in range(n_layer))

    def attention_path(self) -> str:
        """"flash" or "einsum": the path the layers' attention takes in the
        module's present mode."""
        return self.layers[0].self_attn.attention_path() if len(self.layers) else "none"

    def forward(self, x, mask, conditioning=None):
        pos = sinusoidal_positional_embedding(x.shape[1], self.d_model, x.device, x.dtype)
        x = self.dropemb(self.cond_input(x + pos[None] * mask, conditioning))
        for layer in self.layers:
            x = layer(x, mask, conditioning)
        return x, mask


class FFConformerEncoder(TokenEncoder):
    """Token embedding followed by an FFConformerDecoder stack."""

    def __init__(self, n_layer: int, n_head: int, d_model: int, d_head: int, d_inner: int,
                 kernel_size: int = 31, dropout: float = 0.1, dropatt: float = 0.1,
                 n_embed: int = 256, d_embed: Optional[int] = None, padding_idx: int = 0,
                 dropemb: float = 0.0, condition_types: Sequence[str] = (),
                 use_rope: bool = False, use_flash: bool = False):
        super().__init__()
        self.padding_idx = padding_idx
        self.word_emb = Embedding(n_embed, d_embed or d_model)
        self.stack = FFConformerDecoder(n_layer, n_head, d_model, d_head, d_inner, kernel_size,
                                        dropout, dropatt, dropemb, condition_types, use_rope,
                                        use_flash)
