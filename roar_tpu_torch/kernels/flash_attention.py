"""K5: segment-masked flash attention, non-causal and causal, forward and
backward, fp32 and bf16 (CUDA kernels + plain versions).

Port of roar_tpu/models/transformer.py:72 `flash_self_attention` and of
roar_tpu/models/gpt.py:491 `_causal_flash`, which call the upstream Pallas TPU
kernel `jax.experimental.pallas.ops.tpu.flash_attention` (`SegmentIds`, with
`causal=False` and `causal=True`), and of the two kernels its custom VJP
launches, `_flash_attention_bwd_dkv` and `_flash_attention_bwd_dq`.  The
kernels are `csrc/flash_attention_fwd.cu` and `csrc/flash_attention_bwd.cu`;
their source notes say what bounds them on the H100 and what their design does
about it.  Every kernel runs on the tensor cores (`mma.sync`): in bf16 the
forward, the dK/dV and the dQ kernel (`csrc/flash_attention_mma.cuh`); in
fp32 the same three in 3xTF32 (TF32 products of operands split into big +
small, each k-chunk's products flushed into a round-to-nearest fp32 sum:
`csrc/tf32x3.cuh`, `csrc/flash_attention_tf32.cuh`), at fp32's level.  The C
interface is the same for all.

Semantics: softmax attention in which query i sees key j only when both carry
the same segment id and, with `causal`, j <= i.  Valid tokens have id 0 and
padding id 1, so a valid query sees the valid keys and a pad query sees only
the pad keys.  Every query sees at least its own key, so no row is empty.
Rows past T do not exist: the kernels mask their ragged tile edge instead of
padding T, and with `causal` they skip the key tiles above the diagonal.

The forward's residual is one tensor, the per-row log-sum-exp `lse[B, H, T]`
of the scaled, masked scores, in place of the TPU kernel's lane-broadcast `l`
and `m`.  The backward recomputes `p = exp(s * scale - lse)` from it:

    dV = p^T dO,  dP = dO v^T,  dS = p * (dP - delta) * scale,
    dK = dS^T q,  dQ = dS k,    delta = sum(o * dO, -1)

`delta` is a plain reduction here, as it is plain JAX upstream.

Types: q, k, v (and o, dO, the gradients) are all fp32 or all bf16.  Sums,
`lse` and `delta` are fp32 either way.  The bf16 form rounds to bf16 where the
upstream kernels cast to an operand's type: `exp(s - m)` before `p v` (its row
sum is taken unrounded), `p` before `p^T dO`, `dS` before `dS^T q` and `dS k`,
and each result as it is stored.  The plain versions round at the same places
(the forward's against the row's final maximum, where the kernel rounds against
its running maximum).

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor launches
the kernel or raises.  `LAUNCHES` counts the launches by kernel: "fwd", "dkv"
and "dq" for the non-causal form, "causal_fwd", "causal_dkv" and "causal_dq"
for the causal one; `LAUNCHES.clear()` sets them all to 0.  `LAUNCHES_BF16`
counts the bf16 launches among them under the same keys.  The differentiable
entry point is `roar_tpu_torch.ops.flash_attention.flash_self_attention`.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional, Tuple

import torch

LAUNCHES: Counter = Counter()
LAUNCHES_BF16: Counter = Counter()
HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)


def segment_ids(key_mask: Optional[torch.Tensor], batch: int, length: int,
                device) -> torch.Tensor:
    """[B, T] int32 segment ids: 0 where key_mask is True (valid), 1 elsewhere."""
    if key_mask is None:
        return torch.zeros(batch, length, dtype=torch.int32, device=device)
    if key_mask.shape != (batch, length):
        raise ValueError(f"key_mask {tuple(key_mask.shape)} != {(batch, length)}")
    return (~key_mask.bool()).to(torch.int32)


def _wide(x: torch.Tensor) -> torch.Tensor:
    """bf16 widened to fp32, as the kernels stage it; anything else as it is."""
    return x.float() if x.dtype == torch.bfloat16 else x


def _masked_scores(q, k, key_mask, scale: float, causal: bool = False) -> torch.Tensor:
    """[B, H, Tq, Tk] scaled scores (fp32 for bf16 inputs), -inf where the key
    is not visible."""
    b, t = q.shape[:2]
    seg = segment_ids(key_mask, b, t, q.device)
    scores = torch.einsum("bqhd,bkhd->bhqk", _wide(q), _wide(k)) * scale
    visible = seg[:, None, :, None] == seg[:, None, None, :]
    if causal:
        visible = visible & torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    return scores.masked_fill(~visible, float("-inf"))


def flash_self_attention_plain(q, k, v, key_mask, scale: float, return_lse: bool = False,
                               causal: bool = False):
    """The forward kernel's plain PyTorch version: einsum, segment (and
    causal) mask, softmax, einsum, with fp32 sums and the kernel's roundings.
    q/k/v: [B, T, H, D]; key_mask: [B, T] bool, True = valid.  With
    `return_lse`, (o, lse [B, H, T] fp32)."""
    scores = _masked_scores(q, k, key_mask, scale, causal)
    top = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - top)
    total = p.sum(dim=-1, keepdim=True)  # [B, H, Tq, 1], of the unrounded p
    out = torch.einsum("bhqk,bkhd->bqhd", _wide(p.to(v.dtype)), _wide(v))
    out = (out / total.permute(0, 2, 1, 3)).to(q.dtype)
    if return_lse:
        return out, (top + torch.log(total)).squeeze(-1)
    return out


def flash_self_attention_bwd_plain(q, k, v, key_mask, scale: float, o, lse, do,
                                   causal: bool = False
                                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' plain PyTorch version, from the formulas above
    (the arithmetic of upstream's `mha_reference_bwd`), with fp32 sums and the
    kernels' roundings.  Returns (dq, dk, dv), each [B, T, H, D]."""
    dtype = q.dtype
    p = torch.exp(_masked_scores(q, k, key_mask, scale, causal) - lse[..., None])  # [B,H,Tq,Tk]
    do32 = _wide(do)
    dv = torch.einsum("bhqk,bqhd->bkhd", _wide(p.to(dtype)), do32)
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, _wide(v))
    delta = (_wide(o) * do32).sum(-1).permute(0, 2, 1)  # [B, H, Tq]
    ds = _wide((p * (dp - delta[..., None]) * scale).to(dtype))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, _wide(q))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, _wide(k))
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def _check_bthd(**tensors) -> Tuple[int, int, int, int]:
    """Raise on what the kernels do not take; returns (B, T, H, D)."""
    (first_name, first), *_ = tensors.items()
    if first.dim() != 4:
        raise ValueError(f"{first_name} must be [B, T, H, D], got {tuple(first.shape)}")
    b, t, h, d = first.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported (kernel takes {HEAD_DIMS})")
    if first.dtype not in DTYPES:
        raise TypeError(f"{first_name} must be float32 or bfloat16, got {first.dtype}")
    for name, x in tensors.items():
        if x.shape != first.shape:
            raise ValueError(f"{name} {tuple(x.shape)} != {first_name} {tuple(first.shape)}")
        if x.dtype != first.dtype:
            raise TypeError(f"{name} is {x.dtype}, {first_name} is {first.dtype}")
        if x.device != first.device:
            raise ValueError(f"{name} is on {x.device}, {first_name} on {first.device}")
    if first.device.type != "cuda":
        raise ValueError(f"flash_self_attention: no kernel for device {first.device}")
    for name, x in tensors.items():
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return b, t, h, d


def _count(name: str, dtype: torch.dtype) -> None:
    LAUNCHES[name] += 1
    if dtype == torch.bfloat16:
        LAUNCHES_BF16[name] += 1


def flash_self_attention(q, k, v, key_mask, scale: float, return_lse: bool = False,
                         causal: bool = False):
    """Segment-masked attention over [B, T, H, D] q/k/v, forward only: the
    contract of roar_tpu/models/transformer.py:72, and with `causal` that of
    roar_tpu/models/gpt.py:491.  Returns [B, T, H, D], or with `return_lse`
    also the log-sum-exp residual [B, H, T]."""
    if q.device.type == "cpu":
        return flash_self_attention_plain(q, k, v, key_mask, scale, return_lse, causal)
    b, t, h, d = _check_bthd(q=q, k=k, v=v)
    seg = segment_ids(key_mask, b, t, q.device).to(q.device).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty(b, h, t, dtype=torch.float32, device=q.device) if return_lse else None

    from roar_tpu_torch.kernels.library import check, load_library

    lib = load_library()
    err = lib.roar_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), out.data_ptr(),
        lse.data_ptr() if return_lse else None,
        b, t, h, d, float(scale), int(causal), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check(lib, err, "flash_attention_fwd launch")
    _count("causal_fwd" if causal else "fwd", q.dtype)
    return (out, lse) if return_lse else out


def flash_self_attention_bwd(q, k, v, key_mask, scale: float, o, lse, do,
                             need_dq: bool = True, need_dkv: bool = True, delta=None,
                             causal: bool = False):
    """(dq, dk, dv) of `flash_self_attention` for the cotangent `do`, from the
    forward's `o` and `lse`.  `need_dq` / `need_dkv` say which kernel to
    launch; what is not asked for comes back as None.  `delta` [B, H, T], when
    given, is taken as `sum(o * do, -1)` instead of being reduced here."""
    if q.device.type == "cpu":
        dq, dk, dv = flash_self_attention_bwd_plain(q, k, v, key_mask, scale, o, lse, do, causal)
        return (dq if need_dq else None, *((dk, dv) if need_dkv else (None, None)))
    b, t, h, d = _check_bthd(q=q, k=k, v=v, o=o, do=do)
    if lse.shape != (b, h, t) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous float32 {(b, h, t)}, got {tuple(lse.shape)}")
    seg = segment_ids(key_mask, b, t, q.device).to(q.device).contiguous()
    if delta is None:
        delta = (o.float() * do.float()).sum(-1).permute(0, 2, 1).contiguous()  # [B, H, T]
    elif delta.shape != (b, h, t) or delta.dtype != torch.float32 or not delta.is_contiguous():
        raise ValueError(f"delta must be contiguous float32 {(b, h, t)}")

    from roar_tpu_torch.kernels.library import check, load_library

    lib = load_library()
    shared = (q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), lse.data_ptr(),
              delta.data_ptr(), do.data_ptr())
    tail = (b, t, h, d, float(scale), int(causal), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    dq = dk = dv = None
    if need_dkv:
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        err = lib.roar_flash_attention_bwd_dkv(*shared, dk.data_ptr(), dv.data_ptr(), *tail)
        check(lib, err, "flash_attention_bwd_dkv launch")
        _count("causal_dkv" if causal else "dkv", q.dtype)
    if need_dq:
        dq = torch.empty_like(q)
        err = lib.roar_flash_attention_bwd_dq(*shared, dq.data_ptr(), *tail)
        check(lib, err, "flash_attention_bwd_dq launch")
        _count("causal_dq" if causal else "dq", q.dtype)
    return dq, dk, dv
