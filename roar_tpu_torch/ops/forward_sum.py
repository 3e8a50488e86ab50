"""Forward-sum (One-TTS-Alignment) loss and the binarization loss.

Port of roar_tpu/ops/forward_sum.py:108-157.  The attention log-prob matrix
is padded with a blank column (log-prob -1), masked beyond the text length
and log-softmaxed over the text axis, exactly as there; the monotonic-lattice
likelihood is then CTC against the targets [1, 2, ..., K].  The JAX package
writes that recursion as a `lax.scan` (no Pallas kernel); here
`F.ctc_loss(zero_infinity=True)` evaluates it in one call, as the reference
implementation the JAX package was modelled on does.  Reduction: mean over
the batch of nll / target length, and an infeasible utterance (text longer
than its mel) contributes 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def forward_sum_loss(attn_logprob: torch.Tensor, text_lens: torch.Tensor,
                     mel_lens: torch.Tensor, blank_logprob: float = -1.0,
                     loss_scale: float = 1.0) -> torch.Tensor:
    """Scalar loss from attn_logprob [B, 1, T_mel, T_text] (or [B, T_mel,
    T_text]), the unnormalized attention log-probs of the alignment encoder."""
    if attn_logprob.dim() == 4:
        attn_logprob = attn_logprob[:, 0]
    b, t_mel, t_text = attn_logprob.shape
    padded = F.pad(attn_logprob, (1, 0), value=blank_logprob)
    key_inds = torch.arange(t_text + 1, device=attn_logprob.device)
    invalid = key_inds[None, None, :] > text_lens[:, None, None]
    log_probs = F.log_softmax(padded.masked_fill(invalid, -1e15), dim=-1)

    targets = key_inds[1:].expand(b, t_text)
    nll = F.ctc_loss(log_probs.transpose(0, 1), targets, mel_lens.long(), text_lens.long(),
                     blank=0, reduction="none", zero_infinity=True)
    per = nll / torch.clamp(text_lens.to(nll.dtype), min=1.0)
    return loss_scale * per.mean()


def bin_loss(hard_attention: torch.Tensor, soft_attention: torch.Tensor,
             loss_scale: float = 1.0) -> torch.Tensor:
    """-sum(log(soft where hard == 1)) / sum(hard)."""
    log_soft = torch.log(torch.clamp(soft_attention, min=1e-12))
    picked = torch.where(hard_attention == 1.0, log_soft, 0.0)
    return loss_scale * (-picked.sum() / torch.clamp(hard_attention.sum(), min=1.0))
