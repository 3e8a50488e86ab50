"""Length / duration utilities: masks, duration decoding, length regulation,
feature averaging.

Port of roar_tpu/ops/lengths.py:25-153 (`mask_from_lens`, `regulate_len`,
`average_features`, `log_to_duration`, `slice_segments`,
`rand_slice_segments`).  The JAX `regulate_len` is a
one-hot-matrix product; here it is a gather of the token each frame falls
in, which selects the same rows exactly.  The decoder length stays a caller-chosen bucket `max_len`, and
frames past the regulated length are zero.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def slice_segments(x: torch.Tensor, start_idxs: torch.Tensor, segment_size: int) -> torch.Tensor:
    """[B, C, T] -> [B, C, segment_size] slices at per-row offsets, one gather
    on the device.  As `jax.lax.dynamic_slice` does, a start is clamped to
    [0, T - segment_size] so every slice lies inside the row."""
    t = x.shape[-1]
    if segment_size > t:
        raise ValueError(f"segment of {segment_size} is longer than the axis of {t}")
    starts = torch.clamp(start_idxs.long(), 0, t - segment_size)
    idx = starts[:, None] + torch.arange(segment_size, device=x.device)  # [B, segment_size]
    return torch.gather(x, 2, idx[:, None, :].expand(-1, x.shape[1], -1))


def draw_segment_starts(x_lengths: torch.Tensor, segment_size: int,
                        generator: Optional[torch.Generator]) -> torch.Tensor:
    """[B] int32 starts, floor(u_b * max(len_b - segment_size + 1, 1)) with
    u_b drawn in [0, 1) from `generator` (torch's default generator of the
    lengths' device when None): where `rand_slice_segments` takes its
    randomness."""
    ids_str_max = torch.clamp(x_lengths - segment_size + 1, min=1)
    u = torch.rand(x_lengths.shape[0], generator=generator, device=x_lengths.device)
    return (u * ids_str_max.to(u.dtype)).to(torch.int32)


def rand_slice_segments(x: torch.Tensor, x_lengths: Optional[torch.Tensor] = None,
                        segment_size: int = 4, generator: Optional[torch.Generator] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random fixed-size segments of [B, C, T]: (segments [B, C, segment_size],
    starts [B]), the starts drawn by `draw_segment_starts`."""
    if x_lengths is None:
        x_lengths = torch.full((x.shape[0],), x.shape[-1], dtype=torch.long, device=x.device)
    ids_str = draw_segment_starts(x_lengths, segment_size, generator)
    return slice_segments(x, ids_str, segment_size), ids_str
