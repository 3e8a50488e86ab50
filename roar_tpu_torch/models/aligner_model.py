"""AlignerModel: the standalone speech-text aligner.

Port of roar_tpu/models/aligner_model.py: `AlignerNet` (token embedding +
`AlignmentEncoder`) and the task `AlignerModel`, trained with the forward-sum
loss plus the binarization loss, which switches on at epoch
`ceil(bin_loss_start_ratio * max_epochs)` with a scale that grows linearly over
`bin_loss_warmup_epochs` from a floor of 1 / warmup.  `align` gives each
token's duration in mel frames: the hard (MAS) alignment summed over frames,
which sums to the utterance's mel length.  The task has the interface
`training/run.py::train_supervised` asks of FastPitch.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from roar_tpu_torch.models.aligner import AlignmentEncoder
from roar_tpu_torch.models.fastpitch import init_parameters
from roar_tpu_torch.models.fastpitch_model import (
    make_tokenizer,
    preprocessor_config,
    spec_from_batch,
)
from roar_tpu_torch.models.submodules import Embedding, set_dropout_generator
from roar_tpu_torch.ops.forward_sum import bin_loss, forward_sum_loss
from roar_tpu_torch.ops.lengths import mask_from_lens
from roar_tpu_torch.ops.mas import binarize_attention


class AlignerNet(nn.Module):
    """Embedding + AlignmentEncoder (flax scopes `embed`, `alignment_encoder`)."""

    def __init__(self, n_tokens: int, symbols_embedding_dim: int = 384, n_mel_channels: int = 80,
                 n_att_channels: int = 80, temperature: float = 0.0005, dist_type: str = "l2"):
        super().__init__()
        self.embed = Embedding(n_tokens, symbols_embedding_dim)
        self.alignment_encoder = AlignmentEncoder(
            n_mel_channels=n_mel_channels, n_text_channels=symbols_embedding_dim,
            n_att_channels=n_att_channels, temperature=temperature, dist_type=dist_type)

    def forward(self, spec, text, text_len, attn_prior=None):
        """(attn_soft, attn_logprob), each [B, 1, T_mel, T_text]."""
        key_mask = mask_from_lens(text_len, text.shape[1])
        return self.alignment_encoder(spec, self.embed(text), key_mask=key_mask,
                                      attn_prior=attn_prior)


class AlignerModel:
    """Task wrapper: the `model` block of configs/aligner.yaml -> tokenizer +
    AlignerNet + losses.  `generator`, when given, seeds the parameters (the
    flax initialisers' distributions); without one they are to be filled by
    `convert.load_aligner_params`."""

    def __init__(self, cfg: Dict[str, Any], generator: Optional[torch.Generator] = None):
        self.cfg = cfg
        tok_cfg = cfg.get("text_tokenizer")
        self.tokenizer = make_tokenizer(tok_cfg) if tok_cfg else None
        n_tokens = cfg.get("n_symbols") or len(self.tokenizer.tokens)
        self.mel_cfg = preprocessor_config(cfg.get("preprocessor") or {})
        enc_cfg = cfg.get("alignment_encoder") or {}
        self.module = AlignerNet(
            n_tokens=n_tokens,
            symbols_embedding_dim=cfg.get("symbols_embedding_dim", 384),
            n_mel_channels=self.mel_cfg.nfilt,
            n_att_channels=enc_cfg.get("n_att_channels", self.mel_cfg.nfilt),
            temperature=enc_cfg.get("temperature", 0.0005),
            dist_type=enc_cfg.get("dist_type", "l2"),
        ).eval()
        if generator is not None:
            init_parameters(self.module, generator)
        self.bin_loss_start_ratio = cfg.get("bin_loss_start_ratio", 0.2)
        self.bin_loss_warmup_epochs = cfg.get("bin_loss_warmup_epochs", 100)
        self.max_epochs = cfg.get("max_epochs", 100)

    @property
    def bin_loss_start_epoch(self) -> int:
        return math.ceil(self.bin_loss_start_ratio * self.max_epochs)

    def bin_loss_scale(self, epoch: int) -> float:
        """0 before the start epoch; then (epoch - start) / warmup clipped to
        [1 / warmup, 1]."""
        warmup = max(self.bin_loss_warmup_epochs, 1)
        if epoch < self.bin_loss_start_epoch:
            return 0.0
        return max(min(max((epoch - self.bin_loss_start_epoch) / warmup, 0.0), 1.0), 1.0 / warmup)

    # ------------------------------------------------------------------
    def parameters(self):
        return list(self.module.parameters())

    def to_jax_tree(self) -> Dict[str, Any]:
        """The parameters as the flax tree the JAX task holds."""
        from roar_tpu_torch.training import convert

        return convert.aligner_to_jax_tree(self.module)

    def set_dropout_generator(self, generator: Optional[torch.Generator]) -> None:
        """The aligner has no dropout; kept for the trainer's interface."""
        set_dropout_generator(self.module, generator)

    def _forward(self, batch: Dict[str, torch.Tensor]):
        spec, mel_lens = spec_from_batch(batch, self.mel_cfg)
        attn_soft, attn_logprob = self.module(spec, batch["text"].long(), batch["text_len"],
                                              batch.get("align_prior_matrix"))
        return attn_soft, attn_logprob, mel_lens

    def loss_fn(self, batch: Dict[str, torch.Tensor], epoch: int = 0,
                mark=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(forward-sum + scaled binarization loss, metrics) of one batch
        (roar_tpu/models/aligner_model.py:103-126)."""
        mark = mark or (lambda name: None)
        attn_soft, attn_logprob, mel_lens = self._forward(batch)
        mark("model_forward")
        fs = forward_sum_loss(attn_logprob, batch["text_len"], mel_lens)
        attn_hard = binarize_attention(attn_soft, batch["text_len"], mel_lens)
        lb = bin_loss(attn_hard, attn_soft) * self.bin_loss_scale(epoch)
        loss = fs + lb
        mark("losses")
        metrics = {"forward_sum_loss": fs, "bin_loss": lb, "loss": loss}
        return loss, {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def align(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(durations [B, T_text], soft attention [B, 1, T_mel, T_text]) of a
        batch of tensors on the module's device; the module is put in eval
        mode (it has no dropout)."""
        self.module.eval()
        attn_soft, _, mel_lens = self._forward(batch)
        attn_hard = binarize_attention(attn_soft, batch["text_len"], mel_lens)
        return attn_hard[:, 0].sum(dim=1), attn_soft
