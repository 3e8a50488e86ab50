"""Length / duration utilities: masks, duration decoding, length regulation,
feature averaging.

Port of roar_tpu/ops/lengths.py:25-121 (`mask_from_lens`, `regulate_len`,
`average_features`, `log_to_duration`).  The JAX `regulate_len` is a
one-hot-matrix product; here it is a gather of the token each frame falls
in, which selects the same rows exactly.  The decoder length stays a caller-chosen bucket `max_len`, and
frames past the regulated length are zero.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def mask_from_lens(lens: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B, max_len] bool mask, True for valid positions."""
    return torch.arange(max_len, device=lens.device)[None, :] < lens[:, None]


def log_to_duration(log_dur: torch.Tensor, min_dur: float, max_dur: float,
                    mask: torch.Tensor) -> torch.Tensor:
    """exp(log_dur) - 1, clamped to [min_dur, max_dur], zero where masked."""
    dur = torch.clamp(torch.exp(log_dur) - 1.0, min_dur, max_dur)
    return dur * mask.to(dur.dtype)


def regulate_len(durations: torch.Tensor, enc_out: torch.Tensor, pace: float = 1.0,
                 max_len: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """Repeat each encoder frame by its duration.

    durations: [B, T_text]; enc_out: [B, T_text, C].  Returns
    (enc_rep [B, max_len, C], dec_lens [B]).  Each duration becomes
    floor(d / pace + 0.5) frames; dec_lens is clamped to max_len.
    """
    reps = torch.floor(durations.float() / pace + 0.5).long()
    ends = torch.cumsum(reps, dim=1)  # [B, T_text]
    frames = torch.arange(max_len, device=enc_out.device).expand(ends.shape[0], -1)
    # frame f belongs to the first token whose end lies past f; a zero-length
    # token is never chosen, and frames past the last end index the zero row
    idx = torch.searchsorted(ends, frames.contiguous(), right=True)
    padded = torch.cat([enc_out, enc_out.new_zeros(enc_out.shape[0], 1, enc_out.shape[2])], 1)
    enc_rep = torch.gather(padded, 1, idx[..., None].expand(-1, -1, enc_out.shape[2]))
    dec_lens = torch.clamp(ends[:, -1], max=max_len)
    return enc_rep, dec_lens


def average_features(feats: torch.Tensor, durs: torch.Tensor) -> torch.Tensor:
    """Average frame-level features over each token's duration span.

    feats: [B, n_formants, T_mel]; durs: [B, T_text] int or float.
    Returns [B, n_formants, T_text].  Nonzero-aware mean: frames with value 0
    are left out of the denominator, and all-zero spans average to 0.  For
    float durations the CUMULATIVE sums are truncated, so fractional
    durations accumulate into later tokens.
    """
    ends = torch.cumsum(durs, dim=1).long()  # [B, T_text]
    starts = F.pad(ends[:, :-1], (1, 0))
    t_mel = feats.shape[-1]
    ends = torch.clamp(ends, 0, t_mel)
    starts = torch.clamp(starts, 0, t_mel)

    nonzero_cums = F.pad(torch.cumsum((feats != 0.0).float(), dim=2), (1, 0))
    cums = F.pad(torch.cumsum(feats.float(), dim=2), (1, 0))

    def gather_spans(c):  # c: [B, n_formants, T_mel + 1]
        index = lambda i: i[:, None, :].expand(-1, c.shape[1], -1)
        return torch.gather(c, 2, index(ends)) - torch.gather(c, 2, index(starts))

    sums = gather_spans(cums)
    nelems = gather_spans(nonzero_cums)
    return torch.where(nelems == 0.0, 0.0, sums / torch.clamp(nelems, min=1.0))
