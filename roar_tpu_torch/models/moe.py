"""Mixture-of-experts MLP: top-k routing over SwiGLU experts, capacity dispatch.

Port of roar_tpu/models/moe.py.  `MoEMLP` keeps the flax names (`router`, a
bias-free linear layer, and `w_gate`, `w_up`, `w_down` with a leading expert
axis) and returns `(y, aux)` with `aux` = {"lb_loss", "z_loss",
"expert_load"}: the load-balancing loss of Switch Transformer eq. 4, the
router z-loss and the top-1 routing fraction of each expert.

Dispatch and combine are one-hot einsums over a [tokens, experts, capacity]
layout, as in the JAX package: no scatter, and a choice past its expert's
capacity `max(1, int(capacity_factor * N * k / E))` is dropped (the token
passes through the caller's residual unchanged, Switch's behaviour).  The
dispatch and combine tensors, the gate values and the expert products stay
in the activation type; the products are `torch.einsum` / `torch.matmul`,
as the JAX package's are XLA einsums.  No Pallas kernel is involved.

Two places differ from a literal transcription:
- ties among the router's probabilities: `jax.lax.top_k` picks the lower
  expert index first; `torch.topk` promises no order on ties, so the k
  largest come from a stable descending sort;
- each choice's slot in its expert's queue is counted in int64.  The JAX
  package counts it with a cumsum over one-hot choices in the activation
  type (moe.py:62-67); in bf16 that count is exact only up to 256, after
  which two choices can share a slot and be summed into one expert row.
  In fp32 the two agree at every size, in bf16 whenever no expert receives
  more than 256 choices.

Expert parallelism (`expert_axis`, `expert_shardings`) is not ported: the port
runs on one device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def _as(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Parameter `p` in the type of activation `x` (a differentiable cast)."""
    return p if p.dtype == x.dtype else p.to(x.dtype)


def capacity(n_tokens: int, n_experts: int, top_k: int, capacity_factor: float) -> int:
    """Slots per expert (moe.py:49)."""
    return max(1, int(capacity_factor * n_tokens * top_k / n_experts))


def top_k_stable(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, ties to the
    lower index, as `jax.lax.top_k` orders them."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def queue_slots(expert_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """expert_idx [N, k] -> each choice's position in its expert's queue
    [N, k] (int64), choices taken token by token, then choice by choice."""
    choice = F.one_hot(expert_idx.reshape(-1), n_experts)  # int64 [N*k, E]
    return ((choice.cumsum(0) * choice).amax(-1) - 1).reshape(expert_idx.shape)


class MoEMLP(nn.Module):
    """Top-k routed SwiGLU experts: [B, T, d] -> ([B, T, d], aux).

    `route_override` ([N, k] expert ids, N = B * T), when set, replaces the
    router's own top-k choice; the gate values are still the router's
    probabilities at those experts.  After each forward `last_choice` holds
    the router's own choice."""

    def __init__(self, n_embd: int, n_experts: int = 8, ff_dim: int = 256, top_k: int = 2,
                 capacity_factor: float = 1.25, expert_axis: Optional[str] = None):
        super().__init__()
        if expert_axis is not None:
            raise NotImplementedError("MoEMLP(expert_axis=...): expert parallelism is not "
                                      "ported; the port runs on one device")
        self.n_experts, self.ff_dim, self.top_k = n_experts, ff_dim, top_k
        self.capacity_factor = capacity_factor
        self.router = nn.Linear(n_embd, n_experts, bias=False)
        self.w_gate = nn.Parameter(torch.empty(n_experts, n_embd, ff_dim))
        self.w_up = nn.Parameter(torch.empty(n_experts, n_embd, ff_dim))
        self.w_down = nn.Parameter(torch.empty(n_experts, ff_dim, n_embd))
        self.route_override: Optional[torch.Tensor] = None
        self.last_choice: Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        b, t, d = x.shape
        n_tok, e, k = b * t, self.n_experts, self.top_k
        cap = capacity(n_tok, e, k, self.capacity_factor)

        tokens = x.reshape(n_tok, d)
        router_logits = F.linear(tokens, _as(self.router.weight, tokens))
        probs = torch.softmax(router_logits, dim=-1)  # [N, E]
        gate_vals, expert_idx = top_k_stable(probs, k)
        self.last_choice = expert_idx.detach()
        if self.route_override is not None:
            expert_idx = self.route_override.to(expert_idx.device)
            gate_vals = probs.gather(1, expert_idx)
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp(min=1e-9)

        slot = queue_slots(expert_idx, e)
        keep = slot < cap
        slot = slot.clamp(0, cap - 1)
        choice_1h = F.one_hot(expert_idx, e).to(x.dtype)  # [N, k, E]
        kept = choice_1h * keep[..., None].to(x.dtype)
        slot_1h = F.one_hot(slot, cap).to(x.dtype)  # [N, k, cap]
        dispatch = torch.einsum("nke,nkc->nec", kept, slot_1h)
        combine = torch.einsum("nke,nkc,nk->nec", kept, slot_1h, gate_vals)

        expert_in = torch.einsum("nec,nd->ecd", dispatch, tokens)  # [E, cap, d]
        h = torch.matmul(expert_in, _as(self.w_gate, x))
        u = torch.matmul(expert_in, _as(self.w_up, x))
        expert_out = torch.matmul(F.silu(h) * u, _as(self.w_down, x))  # [E, cap, d]
        out = torch.einsum("nec,ecd->nd", combine, expert_out).reshape(b, t, d)

        load = choice_1h[:, 0, :].mean(dim=0)  # fraction routed (top-1)
        importance = probs.mean(dim=0)
        aux = {"lb_loss": e * (load * importance).sum(),
               "z_loss": torch.logsumexp(router_logits, dim=-1).square().mean(),
               "expert_load": load}
        return out, aux


def expert_shardings(*args, **kwargs):
    """The JAX package's expert-parallel placement (moe.py:106-118)."""
    raise NotImplementedError("expert_shardings: expert parallelism is not ported; the port "
                              "runs on one device")
