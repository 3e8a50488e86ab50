"""Monotonic Alignment Search (MAS), on the device.

Port of roar_tpu/ops/mas.py:42-110 `mas_width1` and :276-295
`binarize_attention`: the width-1 Viterbi DP over mel frames, batched, with no
host round trip.  The JAX `lax.scan`s are Python loops of `T_mel` steps over
batched tensors here (two launches per frame forward, two backward); every
operation is an add, a max or a comparison of float32, so the hard alignment
equals the JAX package's exactly, ties included.

Recurrence (mel-major):
    log_p[0, :]  = log_attn[0, :] with log_p[0, 1:] = -inf
    log_p[i, j]  = log_attn[i, j] + max(log_p[i-1, j], log_p[i-1, j-1])
Backtrack from (mel_len - 1, text_len - 1), stepping j -> j-1 when
log_p[i-1, j-1] >= log_p[i-1, j].
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30  # finite stand-in for -inf: max and compare stay well-defined in fp32


@torch.no_grad()
def mas_width1(log_attn: torch.Tensor, text_lens: torch.Tensor,
               mel_lens: torch.Tensor) -> torch.Tensor:
    """Batched width-1 MAS.

    log_attn: [B, T_mel, T_text] log of the soft attention (padded);
    text_lens, mel_lens: [B] valid lengths.  Returns the [B, T_mel, T_text]
    float32 hard alignment (0/1), zero outside the valid rectangle.
    """
    b, t_mel, t_text = log_attn.shape
    device = log_attn.device
    text_idx = torch.arange(t_text, device=device)
    mel_idx = torch.arange(t_mel, device=device)

    # invalid text columns are -inf, so the DP never selects them
    col_valid = text_idx[None, :] < text_lens[:, None]  # [B, T_text]
    la = torch.where(col_valid[:, None, :], log_attn.float(), _NEG_INF).transpose(0, 1)

    # log_p with a -inf column in front, so "shifted right by one" is a view
    log_p = torch.full((t_mel, b, t_text + 1), _NEG_INF, dtype=torch.float32, device=device)
    log_p[0, :, 1] = la[0, :, 0]
    best = torch.empty((b, t_text), dtype=torch.float32, device=device)
    rows, frames = log_p.unbind(0), la.unbind(0)
    for i in range(1, t_mel):
        prev = rows[i - 1]
        torch.maximum(prev[:, 1:], prev[:, :-1], out=best)
        torch.add(frames[i], best, out=rows[i][:, 1:])

    # frame i (1 .. T_mel-1) steps back from column j when log_p[i-1, j-1] >=
    # log_p[i-1, j] and j > 0; frames at or past mel_len carry j along
    move = (log_p[:-1, :, :-1] >= log_p[:-1, :, 1:]) & (text_idx > 0)
    active = (mel_idx[1:, None] < mel_lens[None, :])[..., None]
    step_back = (move & active).to(torch.int64).unbind(0)  # T_mel-1 x [B, T_text]
    # an empty text (length 0) starts at column 0 here; its columns are all
    # invalid, so its rows come out zero either way
    j = (text_lens - 1).to(torch.int64).clamp(min=0)[:, None]
    cols = [j]
    for i in range(t_mel - 1, 0, -1):
        j = j - step_back[i - 1].gather(1, j)
        cols.append(j)
    cols.reverse()

    opt = (torch.cat(cols, dim=1)[..., None] == text_idx).to(torch.float32)  # [B, T_mel, T_text]
    row_valid = (mel_idx[None, :] < mel_lens[:, None])[..., None]
    return opt * row_valid * col_valid[:, None, :]


@torch.no_grad()
def binarize_attention(attn_soft: torch.Tensor, text_lens: torch.Tensor,
                       mel_lens: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Hard alignment from soft attention probabilities, without a gradient.
    attn_soft: [B, 1, T_mel, T_text] or [B, T_mel, T_text]."""
    squeeze = attn_soft.dim() == 4
    a = attn_soft[:, 0] if squeeze else attn_soft
    hard = mas_width1(torch.log(torch.clamp(a, min=eps)), text_lens, mel_lens)
    return hard[:, None] if squeeze else hard
