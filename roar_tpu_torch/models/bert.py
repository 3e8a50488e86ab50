"""Bidirectional LLaMA-style BERT encoder, MLM and NSP heads, and the
pretraining task.

Port of roar_tpu/models/bert.py under the flax names: `BertEmbeddings`
(`word_embeddings`, `token_type_embeddings`, `LayerNorm`, dropout),
`BiLLaMaSelfAttention` (fused `attn` projection, RoPE on the first
`rope_n_elem` channels of q and k, the GQA repeat, the -1e9 padding mask,
dropout on the probabilities, `proj`), `BertBlock` (`norm_1`, `attn`,
`norm_2`, `mlp`), `BertPooler`, `BertEncoder` (`word_emb`, `layers_{i}`,
`ln_f`, `pooler`), `BertOnlyMLMHead` (`transform_dense`, tanh-approximated
gelu as flax's `nn.gelu`, `transform_ln`, a decoder tied to the word
embedding plus `bias`), `BertForMaskedLM`, `BertForPreTraining`
(`seq_relationship`) and `BertPretrainingModel`, the loss_fn-style task of
`training/trainer.py`: masked-LM cross entropy + `nsp_weight` x next-sentence
cross entropy.  LayerNorm epsilon is flax's 1e-6.

The attention is einsum, as in the JAX package: no kernel is involved.  The
task has no bf16 form (`Trainer(precision="bf16")` raises for it).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from roar_tpu_torch.models.gpt import LLaMAMLP, RMSNorm, init_parameters
from roar_tpu_torch.models.submodules import (
    Dropout,
    Embedding,
    LayerNorm,
    Linear,
    set_dropout_generator,
)
from roar_tpu_torch.ops.rope import apply_rope, build_rope_cache

FLAX_LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """BertEncoder hyperparameters (bert.py:64-127 constructor args)."""

    vocab_size: int = 30522
    n_layer: int = 6
    n_head: int = 8
    d_model: int = 512
    d_inner: int = 2048
    n_query_groups: Optional[int] = None  # None -> MHA
    rotary_percentage: float = 0.25
    rope_base: int = 10_000
    dropout: float = 0.1
    dropatt: float = 0.1
    norm_eps: float = 1e-5
    padding_idx: int = 0
    add_pooling_layer: bool = True
    max_len: int = 2048
    # >0 adds an additive segment (token-type) embedding for NSP sentence
    # pairs; 0 keeps the parameters of segment-free checkpoints unchanged
    type_vocab_size: int = 0

    @property
    def head_size(self) -> int:
        return self.d_model // self.n_head

    @property
    def groups(self) -> int:
        return self.n_query_groups or self.n_head

    @property
    def rope_n_elem(self) -> int:
        return int(self.rotary_percentage * self.head_size)


class BertEmbeddings(nn.Module):
    """Token (and segment) embedding + LayerNorm + dropout; positions come
    from RoPE inside attention."""

    def __init__(self, vocab_size: int, d_model: int, dropout: float = 0.0,
                 type_vocab_size: int = 0):
        super().__init__()
        self.word_embeddings = Embedding(vocab_size, d_model)
        if type_vocab_size > 0:
            self.token_type_embeddings = Embedding(type_vocab_size, d_model)
        self.LayerNorm = LayerNorm(d_model, eps=FLAX_LN_EPS)
        self.dropout = Dropout(dropout)

    def forward(self, tokens, token_type_ids=None):
        x = self.word_embeddings(tokens)
        if hasattr(self, "token_type_embeddings") and token_type_ids is not None:
            x = x + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.LayerNorm(x))


class BiLLaMaSelfAttention(nn.Module):
    """Bidirectional (no causal mask) RoPE / GQA attention with a padding mask."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        hs, nh, ng = cfg.head_size, cfg.n_head, cfg.groups
        self.attn = Linear(cfg.d_model, (nh + 2 * ng) * hs, bias=False)
        self.proj = Linear(nh * hs, cfg.d_model, bias=False)
        self.dropout = Dropout(cfg.dropatt)

    def forward(self, x, pad_mask, cos, sin):
        cfg = self.cfg
        b, t, _ = x.shape
        hs, nh, ng = cfg.head_size, cfg.n_head, cfg.groups
        q, k, v = self.attn(x).split([nh * hs, ng * hs, ng * hs], dim=-1)
        q, k, v = q.reshape(b, t, nh, hs), k.reshape(b, t, ng, hs), v.reshape(b, t, ng, hs)
        ne = cfg.rope_n_elem
        if ne > 0:
            q = torch.cat([apply_rope(q[..., :ne], cos, sin), q[..., ne:]], dim=-1)
            k = torch.cat([apply_rope(k[..., :ne], cos, sin), k[..., ne:]], dim=-1)
        rep = nh // ng
        k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hs)
        scores = torch.where(pad_mask[:, None, None, :], scores, -1e9)
        probs = self.dropout(torch.softmax(scores, dim=-1))
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, t, nh * hs)
        return self.proj(out)


class BertBlock(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.norm_1 = RMSNorm(cfg.d_model, cfg.norm_eps)
        self.attn = BiLLaMaSelfAttention(cfg)
        self.norm_2 = RMSNorm(cfg.d_model, cfg.norm_eps)
        self.mlp = LLaMAMLP(cfg.d_model, cfg.d_inner)
        self.dropout_1 = Dropout(cfg.dropout)
        self.dropout_2 = Dropout(cfg.dropout)

    def forward(self, x, pad_mask, cos, sin):
        x = x + self.dropout_1(self.attn(self.norm_1(x), pad_mask, cos, sin))
        return x + self.dropout_2(self.mlp(self.norm_2(x)))


class BertPooler(nn.Module):
    """First-token tanh projection."""

    def __init__(self, d_model: int):
        super().__init__()
        self.dense = Linear(d_model, d_model)

    def forward(self, hidden):
        return torch.tanh(self.dense(hidden[:, 0]))


class BertEncoder(nn.Module):
    """tokens [B, T] -> (sequence_output [B, T, D], pooled [B, D] | None).
    Padding positions (token == padding_idx) are masked out of attention."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.word_emb = BertEmbeddings(cfg.vocab_size, cfg.d_model, cfg.dropout,
                                       cfg.type_vocab_size)
        self.layers = nn.ModuleList(BertBlock(cfg) for _ in range(cfg.n_layer))
        self.ln_f = RMSNorm(cfg.d_model, cfg.norm_eps)
        if cfg.add_pooling_layer:
            self.pooler = BertPooler(cfg.d_model)
        cos, sin = build_rope_cache(cfg.max_len, cfg.rope_n_elem, base=cfg.rope_base)
        self.register_buffer("rope_cos", torch.from_numpy(cos), persistent=False)
        self.register_buffer("rope_sin", torch.from_numpy(sin), persistent=False)

    def forward(self, tokens, token_type_ids=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        t = tokens.shape[1]
        pad_mask = tokens != self.cfg.padding_idx
        cos, sin = self.rope_cos[:t], self.rope_sin[:t]
        x = self.word_emb(tokens, token_type_ids)
        for layer in self.layers:
            x = layer(x, pad_mask, cos, sin)
        x = self.ln_f(x)
        return x, (self.pooler(x) if self.cfg.add_pooling_layer else None)


class BertOnlyMLMHead(nn.Module):
    """dense -> gelu (tanh) -> LayerNorm -> tied embedding^T + bias."""

    def __init__(self, d_model: int, vocab_size: int):
        super().__init__()
        self.transform_dense = Linear(d_model, d_model)
        self.transform_ln = LayerNorm(d_model, eps=FLAX_LN_EPS)
        self.bias = nn.Parameter(torch.zeros(vocab_size))

    def forward(self, hidden, embedding: torch.Tensor):
        h = self.transform_ln(F.gelu(self.transform_dense(hidden), approximate="tanh"))
        return h @ embedding.t() + self.bias


class BertForMaskedLM(nn.Module):
    """Encoder + tied MLM head; returns logits [B, T, vocab]."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.bert = BertEncoder(cfg)
        self.mlm = BertOnlyMLMHead(cfg.d_model, cfg.vocab_size)

    def forward(self, tokens, token_type_ids=None):
        seq, _ = self.bert(tokens, token_type_ids)
        return self.mlm(seq, self.bert.word_emb.word_embeddings.weight)


class BertForPreTraining(BertForMaskedLM):
    """Encoder + tied MLM head + NSP head: (MLM logits [B, T, vocab], NSP
    logits [B, 2] from the pooled first token)."""

    def __init__(self, cfg: BertConfig):
        super().__init__(cfg)
        self.seq_relationship = Linear(cfg.d_model, 2)

    def forward(self, tokens, token_type_ids=None):
        seq, pooled = self.bert(tokens, token_type_ids)
        mlm = self.mlm(seq, self.bert.word_emb.word_embeddings.weight)
        return mlm, self.seq_relationship(pooled)


def masked_mlm_loss(logits, labels, loss_mask):
    """Masked-LM cross entropy over the positions where `loss_mask` is true."""
    logits = logits.float()
    nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, labels[..., None].long())[..., 0]
    mask = loss_mask.float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


class BertPretrainingModel:
    """MLM + NSP pretraining task for `run.py::train_supervised`: loss =
    masked-LM cross entropy + `nsp_weight` x next-sentence cross entropy;
    metrics `loss`, `mlm_loss`, `nsp_loss`, `nsp_acc`.  Config keys: the
    `BertConfig` fields (`type_vocab_size` defaults to 2) and `nsp_weight`.
    With a `generator` the parameters are drawn from it as the flax
    initialisers would draw them."""

    def __init__(self, cfg: Optional[Dict[str, Any]] = None,
                 generator: Optional[torch.Generator] = None):
        cfg = dict(cfg or {})
        fields = {f.name for f in dataclasses.fields(BertConfig)}
        mcfg = {k: v for k, v in cfg.items() if k in fields}
        mcfg.setdefault("type_vocab_size", 2)
        self.config = BertConfig(**mcfg)
        self.module = BertForPreTraining(self.config)
        self.nsp_weight = float(cfg.get("nsp_weight", 1.0))
        if generator is not None:
            self.init_parameters(generator)

    def parameters(self):
        return list(self.module.parameters())

    def init_parameters(self, generator: torch.Generator) -> None:
        """Draw the parameters from `generator`, which lives on their device."""
        init_parameters(self.module, generator)

    def set_dropout_generator(self, generator: Optional[torch.Generator]) -> None:
        set_dropout_generator(self.module, generator)

    def to_jax_tree(self) -> Dict[str, Any]:
        from roar_tpu_torch.training import convert

        return convert.bert_to_jax_tree(self.module)

    def loss_fn(self, batch: Dict[str, torch.Tensor], epoch: int = 0,
                mark=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        mlm_logits, nsp_logits = self.module(batch["input_ids"].long(),
                                             batch["input_type_ids"].long())
        mlm = masked_mlm_loss(mlm_logits, batch["output_ids"], batch["output_mask"] > 0)
        nsp_logits = nsp_logits.float()
        labels = batch["is_next"].long()
        nsp = (torch.logsumexp(nsp_logits, dim=-1)
               - nsp_logits.gather(-1, labels[:, None])[:, 0]).mean()
        loss = mlm + self.nsp_weight * nsp
        nsp_acc = (nsp_logits.argmax(dim=-1) == labels).float().mean()
        return loss, {"loss": loss.detach(), "mlm_loss": mlm.detach(),
                      "nsp_loss": nsp.detach(), "nsp_acc": nsp_acc}
