"""Fused last-layer cross entropy: the lm_head projection and the log-softmax
NLL without the [tokens, vocab] logits ever being whole in device memory.

Port of roar_tpu/ops/fused_ce.py (a chunked `jax.custom_vjp`, no Pallas
kernel; its products are plain matrix products there and `torch.matmul` here).
The token axis is cut into chunks; the forward keeps only each token's
log-sum-exp, and the backward recomputes each [chunk, V] logits tile once to
form `softmax - onehot` on the fly, summing dW in an fp32 accumulator.  Peak
loss memory falls from O(tokens * V) to O(chunk * V) plus the dW accumulator.

Numerics: the math of

    logits = x @ w + b;  nll = logsumexp(logits) - logits[gold]

with the logits tile, the log-sum-exp and the softmax in fp32 whatever the
type of x and w; dx comes back in x's type (its product takes dlogits in x's
type), dW and db in w's and b's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _chunk_tokens(n: int, chunk: int) -> int:
    """Largest divisor of n that is <= chunk (every tile has the same shape)."""
    c = min(chunk, n)
    while n % c:
        c -= 1
    return c


def _tile_logits(x_c, w32, b32) -> torch.Tensor:
    """[C, V] fp32 logits of one tile from the fp32 forms of w and b.  A bf16
    product would round its fp32 sums to bf16; widening the operands first
    keeps them, as `preferred_element_type=float32` does in the JAX package."""
    logits = torch.matmul(x_c.float(), w32)
    return logits if b32 is None else logits + b32


class _FusedNLL(torch.autograd.Function):
    """(weighted NLL sum, weighted correct count), both fp32 scalars, of
    x [N, D] @ w [D, V] (+ b [V]) against targets [N] with weights [N]."""

    @staticmethod
    def forward(ctx, x, w, b, targets, weights, chunk: int):
        n = x.shape[0]
        c = _chunk_tokens(n, chunk)
        loss = torch.zeros((), dtype=torch.float32, device=x.device)
        correct = torch.zeros((), dtype=torch.float32, device=x.device)
        lses = torch.empty(n, dtype=torch.float32, device=x.device)
        w32, b32 = w.float(), None if b is None else b.float()
        for lo in range(0, n, c):
            tile = slice(lo, lo + c)
            logits = _tile_logits(x[tile], w32, b32)
            lse = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(1, targets[tile, None])[:, 0]
            hit = (logits.argmax(dim=-1) == targets[tile]).float()
            loss = loss + ((lse - gold) * weights[tile]).sum()
            correct = correct + (hit * weights[tile]).sum()
            lses[tile] = lse
        ctx.save_for_backward(x, w, b, targets, weights, lses)
        ctx.chunk = c
        ctx.mark_non_differentiable(correct)
        return loss, correct

    @staticmethod
    def backward(ctx, dloss, _dcorrect):
        x, w, b, targets, weights, lses = ctx.saved_tensors
        n, c = x.shape[0], ctx.chunk
        dx = torch.empty_like(x)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        db = None if b is None else torch.zeros(b.shape, dtype=torch.float32, device=b.device)
        w_t = w.t().to(x.dtype)
        w32, b32 = w.float(), None if b is None else b.float()
        for lo in range(0, n, c):
            tile = slice(lo, lo + c)
            x_c = x[tile]
            # the tile's logits again: what keeps [N, V] from ever existing
            p = torch.exp(_tile_logits(x_c, w32, b32) - lses[tile, None])  # softmax from the lse
            p[torch.arange(c, device=x.device), targets[tile]] -= 1.0
            dlogits = p * (weights[tile] * dloss)[:, None]
            dx[tile] = torch.matmul(dlogits.to(x.dtype), w_t)
            dw += torch.matmul(x_c.float().t(), dlogits)
            if db is not None:
                db += dlogits.sum(dim=0)
        return dx, dw.to(w.dtype), None if db is None else db.to(b.dtype), None, None, None


def fused_cross_entropy(hidden: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        loss_mask: Optional[torch.Tensor] = None,
                        chunk: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean next-token NLL of `hidden @ w (+ bias)` against `labels`.

    hidden: [..., D] hidden states before the lm_head, any float type; w:
    [D, V] (pass `lm_head.weight.t()` for an `nn.Linear`); labels: [...] int
    ids; bias: optional [V]; loss_mask: optional [...] 0/1 weights, the mean
    is over their sum; chunk: target tokens per tile (rounded down to a
    divisor of the token count).  Returns (loss, token_accuracy), fp32
    scalars equal to the unfused `logsumexp(logits) - logits[gold]` form."""
    x = hidden.reshape(-1, hidden.shape[-1])
    targets = labels.reshape(-1).long()
    if loss_mask is None:
        weights = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    else:
        weights = loss_mask.reshape(-1).float()
    denom = weights.sum().clamp(min=1.0)
    loss_sum, correct_sum = _FusedNLL.apply(x, w, bias, targets, weights, chunk)
    return loss_sum / denom, correct_sum / denom
