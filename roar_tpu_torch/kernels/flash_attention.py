"""K5-fwd: segment-masked flash attention, forward (CUDA kernel + plain version).

Port of roar_tpu/models/transformer.py:72 `flash_self_attention`, which calls
the upstream Pallas TPU kernel `jax.experimental.pallas.ops.tpu.flash_attention`
(non-causal, `SegmentIds`).  The kernel is `csrc/flash_attention_fwd.cu`; its
source note says what bounds it on the H100 and what its design does about it.

Semantics: softmax attention in which query i sees key j only when both carry
the same segment id.  Valid tokens have id 0 and padding id 1, so a valid
query sees the valid keys and a pad query sees only the pad keys.  Every query
sees at least its own key, so no row is empty.  Rows past T do not exist: the
kernel masks its ragged tile edge instead of padding T.

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor launches
the kernel or raises.  `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

LAUNCHES = 0
HEAD_DIMS = (32, 64, 128)


def segment_ids(key_mask: Optional[torch.Tensor], batch: int, length: int,
                device) -> torch.Tensor:
    """[B, T] int32 segment ids: 0 where key_mask is True (valid), 1 elsewhere."""
    if key_mask is None:
        return torch.zeros(batch, length, dtype=torch.int32, device=device)
    if key_mask.shape != (batch, length):
        raise ValueError(f"key_mask {tuple(key_mask.shape)} != {(batch, length)}")
    return (~key_mask.bool()).to(torch.int32)


def flash_self_attention_plain(q, k, v, key_mask, scale: float) -> torch.Tensor:
    """The kernel's plain PyTorch version: einsum, segment mask, softmax,
    einsum.  q/k/v: [B, T, H, D]; key_mask: [B, T] bool, True = valid."""
    b, t = q.shape[:2]
    seg = segment_ids(key_mask, b, t, q.device)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    visible = seg[:, None, :, None] == seg[:, None, None, :]
    probs = torch.softmax(scores.masked_fill(~visible, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def flash_self_attention(q, k, v, key_mask, scale: float) -> torch.Tensor:
    """Segment-masked attention over [B, T, H, D] q/k/v (contract of
    roar_tpu/models/transformer.py:72).  Returns [B, T, H, D]."""
    if q.device.type == "cpu":
        return flash_self_attention_plain(q, k, v, key_mask, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_self_attention: no kernel for device {q.device}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q/k/v must share one [B, T, H, D] shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, t, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported (kernel takes {HEAD_DIMS})")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    seg = segment_ids(key_mask, b, t, q.device).to(q.device).contiguous()
    out = torch.empty_like(q)

    from roar_tpu_torch.kernels.library import check, load_library

    lib = load_library()
    err = lib.roar_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), out.data_ptr(),
        b, t, h, d, float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    check(lib, err, "flash_attention_fwd launch")
    global LAUNCHES
    LAUNCHES += 1
    return out
