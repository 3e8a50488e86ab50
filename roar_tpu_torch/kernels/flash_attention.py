"""K5: segment-masked flash attention, forward and backward (CUDA kernels +
plain versions).

Port of roar_tpu/models/transformer.py:72 `flash_self_attention`, which calls
the upstream Pallas TPU kernel `jax.experimental.pallas.ops.tpu.flash_attention`
(non-causal, `SegmentIds`), and of the two kernels its custom VJP launches,
`_flash_attention_bwd_dkv` and `_flash_attention_bwd_dq`.  The kernels are
`csrc/flash_attention_fwd.cu` and `csrc/flash_attention_bwd.cu`; their source
notes say what bounds them on the H100 and what their design does about it.

Semantics: softmax attention in which query i sees key j only when both carry
the same segment id.  Valid tokens have id 0 and padding id 1, so a valid
query sees the valid keys and a pad query sees only the pad keys.  Every query
sees at least its own key, so no row is empty.  Rows past T do not exist: the
kernels mask their ragged tile edge instead of padding T.

The forward's residual is one tensor, the per-row log-sum-exp `lse[B, H, T]`
of the scaled, masked scores, in place of the TPU kernel's lane-broadcast `l`
and `m`.  The backward recomputes `p = exp(s * scale - lse)` from it:

    dV = p^T dO,  dP = dO v^T,  dS = p * (dP - delta) * scale,
    dK = dS^T q,  dQ = dS k,    delta = sum(o * dO, -1)

`delta` is a plain reduction here, as it is plain JAX upstream.

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor launches
the kernel or raises.  `LAUNCHES`, `LAUNCHES_BWD_DKV` and `LAUNCHES_BWD_DQ`
count kernel launches.  The differentiable entry point is
`roar_tpu_torch.ops.flash_attention.flash_self_attention`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

LAUNCHES = 0
LAUNCHES_BWD_DKV = 0
LAUNCHES_BWD_DQ = 0
HEAD_DIMS = (32, 64, 128)


def segment_ids(key_mask: Optional[torch.Tensor], batch: int, length: int,
                device) -> torch.Tensor:
    """[B, T] int32 segment ids: 0 where key_mask is True (valid), 1 elsewhere."""
    if key_mask is None:
        return torch.zeros(batch, length, dtype=torch.int32, device=device)
    if key_mask.shape != (batch, length):
        raise ValueError(f"key_mask {tuple(key_mask.shape)} != {(batch, length)}")
    return (~key_mask.bool()).to(torch.int32)


def _masked_scores(q, k, key_mask, scale: float) -> torch.Tensor:
    b, t = q.shape[:2]
    seg = segment_ids(key_mask, b, t, q.device)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    visible = seg[:, None, :, None] == seg[:, None, None, :]
    return scores.masked_fill(~visible, float("-inf"))


def flash_self_attention_plain(q, k, v, key_mask, scale: float, return_lse: bool = False):
    """The forward kernel's plain PyTorch version: einsum, segment mask,
    softmax, einsum.  q/k/v: [B, T, H, D]; key_mask: [B, T] bool, True =
    valid.  With `return_lse`, (o, lse [B, H, T])."""
    scores = _masked_scores(q, k, key_mask, scale)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
    if return_lse:
        return out, torch.logsumexp(scores, dim=-1)
    return out


def flash_self_attention_bwd_plain(q, k, v, key_mask, scale: float, o, lse, do
                                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' plain PyTorch version, from the formulas above
    (the arithmetic of upstream's `mha_reference_bwd`).  Returns (dq, dk, dv),
    each [B, T, H, D]."""
    p = torch.exp(_masked_scores(q, k, key_mask, scale) - lse[..., None])  # [B, H, Tq, Tk]
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    delta = (o * do).sum(-1).permute(0, 2, 1)  # [B, H, Tq]
    ds = p * (dp - delta[..., None]) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k)
    return dq, dk, dv


def _check_bthd(**tensors) -> Tuple[int, int, int, int]:
    """Raise on what the kernels do not take; returns (B, T, H, D)."""
    (first_name, first), *_ = tensors.items()
    if first.device.type != "cuda":
        raise ValueError(f"flash_self_attention: no kernel for device {first.device}")
    if first.dim() != 4:
        raise ValueError(f"{first_name} must be [B, T, H, D], got {tuple(first.shape)}")
    b, t, h, d = first.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported (kernel takes {HEAD_DIMS})")
    for name, x in tensors.items():
        if x.shape != first.shape:
            raise ValueError(f"{name} {tuple(x.shape)} != {first_name} {tuple(first.shape)}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != first.device:
            raise ValueError(f"{name} is on {x.device}, {first_name} on {first.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return b, t, h, d


def flash_self_attention(q, k, v, key_mask, scale: float, return_lse: bool = False):
    """Segment-masked attention over [B, T, H, D] q/k/v (contract of
    roar_tpu/models/transformer.py:72), forward only.  Returns [B, T, H, D],
    or with `return_lse` also the log-sum-exp residual [B, H, T]."""
    if q.device.type == "cpu":
        return flash_self_attention_plain(q, k, v, key_mask, scale, return_lse)
    b, t, h, d = _check_bthd(q=q, k=k, v=v)
    seg = segment_ids(key_mask, b, t, q.device).to(q.device).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty(b, h, t, dtype=torch.float32, device=q.device) if return_lse else None

    from roar_tpu_torch.kernels.library import check, load_library

    lib = load_library()
    err = lib.roar_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), out.data_ptr(),
        lse.data_ptr() if return_lse else None,
        b, t, h, d, float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    check(lib, err, "flash_attention_fwd launch")
    global LAUNCHES
    LAUNCHES += 1
    return (out, lse) if return_lse else out


def flash_self_attention_bwd(q, k, v, key_mask, scale: float, o, lse, do,
                             need_dq: bool = True, need_dkv: bool = True, delta=None):
    """(dq, dk, dv) of `flash_self_attention` for the cotangent `do`, from the
    forward's `o` and `lse`.  `need_dq` / `need_dkv` say which kernel to
    launch; what is not asked for comes back as None.  `delta` [B, H, T], when
    given, is taken as `sum(o * do, -1)` instead of being reduced here."""
    if q.device.type == "cpu":
        dq, dk, dv = flash_self_attention_bwd_plain(q, k, v, key_mask, scale, o, lse, do)
        return (dq if need_dq else None, *((dk, dv) if need_dkv else (None, None)))
    b, t, h, d = _check_bthd(q=q, k=k, v=v, o=o, do=do)
    if lse.shape != (b, h, t) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous float32 {(b, h, t)}, got {tuple(lse.shape)}")
    seg = segment_ids(key_mask, b, t, q.device).to(q.device).contiguous()
    if delta is None:
        delta = (o * do).sum(-1).permute(0, 2, 1).contiguous()  # [B, H, T]
    elif delta.shape != (b, h, t) or delta.dtype != torch.float32 or not delta.is_contiguous():
        raise ValueError(f"delta must be contiguous float32 {(b, h, t)}")

    from roar_tpu_torch.kernels.library import check, load_library

    lib = load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    shared = (q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), lse.data_ptr(),
              delta.data_ptr(), do.data_ptr())
    dq = dk = dv = None
    global LAUNCHES_BWD_DKV, LAUNCHES_BWD_DQ
    if need_dkv:
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        err = lib.roar_flash_attention_bwd_dkv(*shared, dk.data_ptr(), dv.data_ptr(),
                                               b, t, h, d, float(scale), stream)
        check(lib, err, "flash_attention_bwd_dkv launch")
        LAUNCHES_BWD_DKV += 1
    if need_dq:
        dq = torch.empty_like(q)
        err = lib.roar_flash_attention_bwd_dq(*shared, dq.data_ptr(),
                                              b, t, h, d, float(scale), stream)
        check(lib, err, "flash_attention_bwd_dq launch")
        LAUNCHES_BWD_DQ += 1
    return dq, dk, dv
