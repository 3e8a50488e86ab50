"""Shared neural submodules: `ConvNorm`, conditional LayerNorm, conditional
input, the speaker embeddings, the global style token (GST) and the dropout
the training modules share; and the parameterised layers of the TTS models
with their compute type.

Port of roar_tpu/models/submodules.py:54-279.  Activations are [B, T, C].
LayerNorm epsilon is 1e-6, flax's default, not torch's 1e-5.

Compute type.  The JAX package trains in bf16 by casting the whole parameter
tree to bf16 (`cast_floating`, roar_tpu/training/trainer.py:152-174 and
gan.py:162-258) and letting each flax layer compute in the promoted type of
its input and its parameters: bf16 where the activations are bf16, fp32 where
an fp32 input meets a bf16 parameter (the aligner's mel queries).  The port's
layers (`Linear`, `Conv1d`, `ConvTranspose1d`, `LayerNorm`, `Embedding`,
and HiFi-GAN's normed convs) do the same where they use a parameter: with
`compute_dtype` set (`set_compute_dtype`), each parameter is first rounded to
it, then input and parameters are cast to their promoted type.  The masters
stay in their own type and autograd hands them their gradients through the
casts; with `compute_dtype` None nothing is cast.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
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


class CastsParameters:
    """Mixin of a module that applies `compute_dtype` where it uses a parameter."""

    compute_dtype: Optional[torch.dtype] = None

    def cast_parameter(self, p: torch.Tensor) -> torch.Tensor:
        """A parameter as the JAX step's cast tree holds it."""
        return p if self.compute_dtype is None else p.to(self.compute_dtype)

    def operands(self, x: torch.Tensor, *params: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, List[Optional[torch.Tensor]]]:
        """x and the (cast) parameters in their promoted type, as a flax layer
        computes them (`promote_dtype`)."""
        cast = [None if p is None else self.cast_parameter(p) for p in params]
        dtype = x.dtype
        for p in cast:
            if p is not None:
                dtype = torch.promote_types(dtype, p.dtype)
        return x.to(dtype), [None if p is None else p.to(dtype) for p in cast]


def set_compute_dtype(module: nn.Module, dtype: Optional[torch.dtype]) -> None:
    """Set `compute_dtype` on every layer under `module` that applies it."""
    for m in module.modules():
        if isinstance(m, CastsParameters):
            m.compute_dtype = dtype


class Linear(CastsParameters, nn.Linear):
    def forward(self, x):
        x, (w, b) = self.operands(x, self.weight, self.bias)
        return F.linear(x, w, b)


class Conv1d(CastsParameters, nn.Conv1d):
    def forward(self, x):
        x, (w, b) = self.operands(x, self.weight, self.bias)
        return self._conv_forward(x, w, b)


class ConvTranspose1d(CastsParameters, nn.ConvTranspose1d):
    def forward(self, x):
        x, (w, b) = self.operands(x, self.weight, self.bias)
        return F.conv_transpose1d(x, w, b, self.stride, self.padding, self.output_padding,
                                  self.groups, self.dilation)


class Conv2d(CastsParameters, nn.Conv2d):
    def forward(self, x):
        x, (w, b) = self.operands(x, self.weight, self.bias)
        return self._conv_forward(x, w, b)


class LayerNorm(CastsParameters, nn.LayerNorm):
    def forward(self, x):
        x, (w, b) = self.operands(x, self.weight, self.bias)
        return F.layer_norm(x, self.normalized_shape, w, b, self.eps)


class Embedding(CastsParameters, nn.Embedding):
    def forward(self, ids):
        return F.embedding(ids, self.cast_parameter(self.weight), self.padding_idx,
                           self.max_norm, self.norm_type, self.scale_grad_by_freq, self.sparse)


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


def replay_dropout_generators(module: nn.Module):
    """`context_fn` of a `torch.utils.checkpoint` around `module`: the forward
    context saves the state of every distinct generator the module's
    `Dropout`s draw from; the recompute context sets those states back, so the
    recomputed forward draws the same masks, and on exit restores the states
    the generators held before the recompute.  `preserve_rng_state` covers
    only torch's global generators, which a `Dropout` without a generator
    uses."""
    generators = list({id(m.generator): m.generator for m in module.modules()
                       if isinstance(m, Dropout) and m.generator is not None}.values())
    saved: List[torch.Tensor] = []

    @contextlib.contextmanager
    def forward():
        saved[:] = [g.get_state() for g in generators]
        yield

    @contextlib.contextmanager
    def recompute():
        now = [g.get_state() for g in generators]
        for g, state in zip(generators, saved):
            g.set_state(state)
        try:
            yield
        finally:
            for g, state in zip(generators, now):
                g.set_state(state)

    return forward(), recompute()


class ConvNorm(nn.Module):
    """1-D conv over [B, T, C] with "same" padding
    (roar_tpu/models/submodules.py:54; `w_init_gain` names the xavier gain
    its initialiser uses)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 1,
                 w_init_gain: str = "linear"):
        super().__init__()
        self.w_init_gain = w_init_gain
        self.conv = Conv1d(in_channels, features, kernel_size, padding="same")

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
        self.norm = LayerNorm(hidden_dim, eps=LN_EPS, elementwise_affine=not self.condition)
        if self.condition:
            cdim = condition_dim or hidden_dim
            self.scale_proj = Linear(cdim, hidden_dim)
            self.shift_proj = Linear(cdim, hidden_dim)

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
            self.add_proj = Linear(condition_dim, hidden_dim)
        if self.concat:
            self.concat_proj = Linear(hidden_dim + condition_dim, hidden_dim)

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


class SpeakerLookupTable(nn.Module):
    """Trainable speaker embedding table (flax scope `Embed_0`)."""

    def __init__(self, n_speakers: int, embedding_dim: int):
        super().__init__()
        self.table = Embedding(n_speakers, embedding_dim)

    def forward(self, speaker):
        return self.table(speaker)


class SpeakerEncoder(nn.Module):
    """The lookup embedding or a projection of a precomputed one
    (`precomputed_embedding_dim` -> `embedding_dim`, flax scope `Dense_0`),
    as [B, 1, D]; None with neither."""

    def __init__(self, lookup: Optional[SpeakerLookupTable] = None,
                 precomputed_embedding_dim: Optional[int] = None,
                 embedding_dim: Optional[int] = None):
        super().__init__()
        self.lookup = lookup
        self.proj = (Linear(precomputed_embedding_dim, embedding_dim)
                     if precomputed_embedding_dim is not None else None)

    def forward(self, batch_size: int, speaker=None, embedding=None):
        if self.proj is not None:
            if embedding is None:
                raise ValueError("precomputed speaker embedding expected")
            return self.proj(embedding)[:, None, :]
        if self.lookup is not None:
            if speaker is None:
                raise ValueError("speaker ids required for lookup embedding")
            return self.lookup(speaker)[:, None, :]
        return None


def _same_pad_2d(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Pad the last two axes of [B, C, H, W] as flax's `padding="SAME"` does:
    ceil(n / stride) outputs, the total padding split with its smaller half
    before (at stride 2 and an even n: none before, one after)."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad takes the last axis first
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class ReferenceEncoder(nn.Module):
    """Mel reference encoder: six 3 x 3 stride-2 convs with "SAME" padding
    over the [B, T, n_mel] image, each followed by a LayerNorm over its
    channels and a ReLU, then the mean over the first ceil(len / 64) frames
    (all frames without lengths) of the flattened (n_mel, channels) axes, a
    projection and tanh.  Flax scopes `convs_{i}`, `norm_{i}`, `proj`."""

    def __init__(self, n_mel: int, ref_enc_filters: Sequence[int] = (32, 32, 64, 64, 128, 128),
                 gru_rnn_units: int = 128):
        super().__init__()
        chans = [1, *ref_enc_filters]
        self.convs = nn.ModuleList(Conv2d(chans[i], chans[i + 1], 3, stride=2)
                                   for i in range(len(ref_enc_filters)))
        self.norm = nn.ModuleList(LayerNorm(c, eps=LN_EPS) for c in ref_enc_filters)
        m = n_mel
        for _ in ref_enc_filters:
            m = -(-m // 2)
        self.proj = Linear(m * chans[-1], gru_rnn_units)

    def forward(self, spec, spec_lens=None):
        x = spec[:, None]  # [B, 1, T, n_mel]
        for conv, norm in zip(self.convs, self.norm):
            x = conv(_same_pad_2d(x, 3, 2))
            x = F.relu(norm(x.permute(0, 2, 3, 1))).permute(0, 3, 1, 2)
        b, c, t, m = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, t, m * c)  # channels fastest, as flax flattens
        if spec_lens is not None:
            down = 2 ** len(self.convs)
            lens = torch.clamp((spec_lens + down - 1) // down, min=1)
            mask = (torch.arange(t, device=x.device)[None, :] < lens[:, None]).to(x.dtype)
            mask = mask[..., None]
            pooled = (x * mask).sum(1) / torch.clamp(mask.sum(1), min=1.0)
        else:
            pooled = x.mean(1)
        return torch.tanh(self.proj(pooled))  # [B, gru_rnn_units]


class StyleAttention(CastsParameters, nn.Module):
    """Multi-head attention of the reference embedding over a learned bank of
    `n_style_token` style tokens (tanh applied where they are used; q, k and
    v projections without bias)."""

    def __init__(self, gst_size: int = 128, n_style_token: int = 10, n_style_attn_head: int = 4):
        super().__init__()
        self.gst_size, self.n_head = gst_size, n_style_attn_head
        d_k = gst_size // n_style_attn_head
        self.style_tokens = nn.Parameter(torch.randn(n_style_token, d_k) * 0.5)
        self.q_proj = Linear(gst_size, gst_size, bias=False)
        self.k_proj = Linear(d_k, gst_size, bias=False)
        self.v_proj = Linear(d_k, gst_size, bias=False)

    def forward(self, ref_emb):
        b, h = ref_emb.shape[0], self.n_head
        d = self.gst_size // h
        keys = torch.tanh(self.cast_parameter(self.style_tokens))[None].expand(b, -1, -1)
        n = keys.shape[1]
        q = self.q_proj(ref_emb).reshape(b, h, 1, d)
        k = self.k_proj(keys).reshape(b, n, h, d).transpose(1, 2)
        v = self.v_proj(keys).reshape(b, n, h, d).transpose(1, 2)
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(d)
        probs = torch.softmax(scores, dim=-1)
        return torch.einsum("bhqk,bhkd->bhqd", probs, v).reshape(b, self.gst_size)


class GlobalStyleToken(nn.Module):
    """ReferenceEncoder (its output `gst_size` wide) + StyleAttention:
    [B, T, n_mel] reference mel -> [B, gst_size]."""

    def __init__(self, n_mel: int, gst_size: int = 128, n_style_token: int = 10,
                 n_style_attn_head: int = 4):
        super().__init__()
        self.reference_encoder = ReferenceEncoder(n_mel, gru_rnn_units=gst_size)
        self.style_attention = StyleAttention(gst_size, n_style_token, n_style_attn_head)

    def forward(self, ref_spec, ref_spec_lens=None):
        return self.style_attention(self.reference_encoder(ref_spec, ref_spec_lens))
