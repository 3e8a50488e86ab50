"""One-TTS-Alignment encoder.

Port of roar_tpu/models/aligner.py:22-101 `AlignmentEncoder`: conv projections
of the text embeddings (keys) and the mel (queries), L2 or cosine distance,
temperature-scaled attention with an optional beta-binomial log-prior, masked
softmax over the text axis.  Layout is [B, T, C].
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from roar_tpu_torch.models.submodules import ConditionalInput, ConvNorm
from roar_tpu_torch.ops.mas import binarize_attention

_MASK_NEG = -1e9


class AlignmentEncoder(nn.Module):
    def __init__(self, n_mel_channels: int = 80, n_text_channels: int = 512,
                 n_att_channels: int = 80, temperature: float = 0.0005,
                 condition_types: Sequence[str] = (), dist_type: str = "l2"):
        super().__init__()
        if dist_type not in ("l2", "cosine"):
            raise ValueError(f"Unknown distance type '{dist_type}'")
        self.temperature, self.dist_type = temperature, dist_type
        self.cond_input = ConditionalInput(n_text_channels, n_text_channels, condition_types)
        self.key_proj = nn.ModuleList([
            ConvNorm(n_text_channels, n_text_channels * 2, kernel_size=3, w_init_gain="relu"),
            ConvNorm(n_text_channels * 2, n_att_channels, kernel_size=1),
        ])
        self.query_proj = nn.ModuleList([
            ConvNorm(n_mel_channels, n_mel_channels * 2, kernel_size=3, w_init_gain="relu"),
            ConvNorm(n_mel_channels * 2, n_mel_channels, kernel_size=1),
            ConvNorm(n_mel_channels, n_att_channels, kernel_size=1),
        ])

    def _project(self, queries, keys):
        # queries: [B, T_mel, n_mel]; keys: [B, T_text, n_text]
        k = self.key_proj[1](F.relu(self.key_proj[0](keys)))
        q = F.relu(self.query_proj[0](queries))
        q = self.query_proj[2](F.relu(self.query_proj[1](q)))
        return q, k

    def _distance(self, q, k):
        """[B, T_mel, T_text] distance."""
        if self.dist_type == "l2":
            # ||q - k||^2 = |q|^2 + |k|^2 - 2 q.k, the expanded form of the JAX module
            q2 = q.square().sum(-1)[:, :, None]
            k2 = k.square().sum(-1)[:, None, :]
            return q2 + k2 - 2.0 * torch.einsum("bqc,bkc->bqk", q, k)
        qn = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-8)
        kn = k / torch.clamp(torch.linalg.norm(k, dim=-1, keepdim=True), min=1e-8)
        return -torch.einsum("bqc,bkc->bqk", qn, kn)

    def forward(self, queries: torch.Tensor, keys: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None,
                attn_prior: Optional[torch.Tensor] = None,
                conditioning: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (attn [B, 1, T_mel, T_text], attn_logprob of the same shape).

        queries: [B, T_mel, n_mel]; keys: [B, T_text, n_text]; key_mask:
        [B, T_text] bool (True = valid); attn_prior: [B, T_mel, T_text].
        """
        keys = self.cond_input(keys, conditioning)
        q, k = self._project(queries, keys)
        attn = -self.temperature * self._distance(q, k)
        if attn_prior is not None:
            attn = F.log_softmax(attn, dim=-1) + torch.log(attn_prior + 1e-8)
        attn_logprob = attn[:, None]
        if key_mask is not None:
            attn = torch.where(key_mask[:, None, :], attn, _MASK_NEG)
        return torch.softmax(attn, dim=-1)[:, None], attn_logprob

    @staticmethod
    def get_durations(attn_soft, text_lens, mel_lens):
        """Binarize and reduce to per-token durations [B, T_text]."""
        return binarize_attention(attn_soft, text_lens, mel_lens)[:, 0].sum(dim=1)
