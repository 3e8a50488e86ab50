"""Differentiable segment-masked flash attention.

The `torch.autograd.Function` around the K5 kernels of
`roar_tpu_torch.kernels.flash_attention`, the port's counterpart of the
`jax.custom_vjp` that upstream's `flash_attention` carries and that
roar_tpu/models/transformer.py:110 reaches in training.  The forward saves
`(q, k, v, key_mask, o, lse)`; the backward launches the dK/dV kernel and the
dQ kernel (each only where `needs_input_grad` asks) and returns no gradient
for the mask and the scale.  With gradients off, or when no input needs one,
the forward is called as it is: nothing is saved and no `lse` is written.
"""

from __future__ import annotations

import torch

from roar_tpu_torch.kernels import flash_attention as fa


class FlashSelfAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_mask, scale):
        out, lse = fa.flash_self_attention(q, k, v, key_mask, scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.key_mask, ctx.scale = key_mask, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        need_q, need_k, need_v = ctx.needs_input_grad[:3]
        dq, dk, dv = fa.flash_self_attention_bwd(
            q, k, v, ctx.key_mask, ctx.scale, out, lse, do.contiguous(),
            need_dq=need_q, need_dkv=need_k or need_v)
        return (dq if need_q else None, dk if need_k else None, dv if need_v else None,
                None, None)


def flash_self_attention(q, k, v, key_mask, scale: float) -> torch.Tensor:
    """Segment-masked attention over [B, T, H, D] q/k/v with a gradient
    (contract of roar_tpu/models/transformer.py:72)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashSelfAttention.apply(q, k, v, key_mask, scale)
    return fa.flash_self_attention(q, k, v, key_mask, scale)
