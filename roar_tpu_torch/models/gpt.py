"""Decoder-only GPT with GQA, RoPE, RMSNorm and a KV cache.

Port of roar_tpu/models/gpt.py: `GPTConfig` with every field, the whole
registry `GPT_CONFIGS` and `config_from_name` (copied data), `RMSNorm`, the
three MLPs, `CausalSelfAttention`, `Block`, `GPT`, `init_kv_caches` and
`generate`.  `mlp_class="LLaMAMoE"` builds `models/moe.py::MoEMLP`; each
block keeps its newest aux losses, detached, as `moe_aux`, which no loss reads
(the JAX `Block` sows them, gpt.py:626-631, and no loss adds them).  The pipelined
forward is not ported.

Attention takes one of two routes, as in the JAX package (gpt.py:579-616):
with `use_flash`, no KV cache and `pos_offset == 0`, K and V are repeated to
the query heads and go through the causal flash-attention kernels of
`ops/flash_attention.py` (on a CUDA tensor the kernels or an error, never a
probe that falls back; on a CPU tensor their plain versions); otherwise the
grouped einsum with `-1e9` masking.

Compute type: the parameters stay in the type they were made in (fp32 masters).
With `GPT.compute_dtype = torch.bfloat16` every layer casts its parameters to
bf16 where it uses them, so activations, matrix products and the attention
kernels run in bf16 and autograd hands each master its gradient in fp32: what
`precision="bf16"` of roar_tpu/training/trainer.py:152-174 does with
`cast_floating`.

The KV cache is updated in place (the JAX package returns new arrays).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from roar_tpu_torch.models.moe import MoEMLP
from roar_tpu_torch.models.submodules import trunc_normal_
from roar_tpu_torch.ops.flash_attention import flash_self_attention
from roar_tpu_torch.ops.rope import apply_rope, build_rope_cache


def find_multiple(n: int, k: int) -> int:
    """Smallest multiple of k that is >= n (vocabulary padding)."""
    return n if n % k == 0 else n + k - (n % k)


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """Architecture config (nlp/modules/gpt/config.py registry analogue).

    Field parity with the reference Config dataclass (config.py:17-66):
    head_dim <-> head_size override, padded_vocab_size/padding_multiple,
    scale_embeddings (Gemma), bias/lm_head_bias, shared_attention_norm
    (falcon-7b, phi), norm_class Layer/RMS, gelu_approximate (phi, Gemma),
    rope_base/rope_condense_ratio (CodeLlama, 16k-context chat tunes),
    n_expert/n_expert_per_token (Mixtral LLaMAMoE).  padding_multiple
    defaults 1 (not the reference's 512) so ad-hoc configs keep their exact
    vocab; registry entries carry explicit padding."""

    vocab_size: int = 32000
    block_size: int = 2048
    n_layer: int = 22
    n_head: int = 32
    n_embd: int = 2048
    head_dim: Optional[int] = None  # head_size override (Gemma-7b: 256)
    n_query_groups: Optional[int] = 4  # GQA; None -> MHA
    intermediate_size: Optional[int] = 5632
    rotary_percentage: float = 1.0
    norm_eps: float = 1e-5
    norm_class: str = "RMSNorm"  # or "LayerNorm"
    mlp_class: str = "LLaMAMLP"  # or GptNeoxMLP | GemmaMLP | LLaMAMoE
    gelu_approximate: str = "none"  # 'tanh' for phi / Gemma
    parallel_residual: bool = False
    shared_attention_norm: bool = False  # falcon-7b / phi style
    bias: bool = False  # linear-layer biases (GPT-NeoX lineage: True)
    lm_head_bias: bool = False  # phi
    scale_embeddings: bool = False  # Gemma: x *= sqrt(n_embd)
    padded_vocab_size: Optional[int] = None
    padding_multiple: int = 1
    rope_base: float = 10000.0
    rope_condense_ratio: float = 1.0
    n_expert: int = 0  # Mixtral MoE
    n_expert_per_token: int = 0
    # The hand-written causal flash-attention kernels on the TRAINING path.
    # KV-cache decode (generate()'s prefill call included) and a nonzero
    # pos_offset always take the einsum path.
    use_flash: bool = False
    # `scan_layers` is a layout flag here: eager PyTorch keeps one Block per
    # layer either way, and the converter reads and writes the stacked
    # `h_scan` parameter layout when it is set.  KV-cache decode refuses it,
    # as the JAX package does.  `remat` recomputes each Block's activations
    # in the backward instead of storing them.
    scan_layers: bool = False
    remat: bool = False
    # "nothing": store nothing, recompute the whole block, the attention
    # forward kernel included; "flash": keep the attention's q, k, v, o and
    # lse, so the backward launches no forward kernel.
    remat_policy: str = "nothing"

    @property
    def head_size(self) -> int:
        return self.head_dim or self.n_embd // self.n_head

    @property
    def groups(self) -> int:
        return self.n_query_groups or self.n_head

    @property
    def rope_n_elem(self) -> int:
        return int(self.rotary_percentage * self.head_size)

    @property
    def padded_vocab(self) -> int:
        return self.padded_vocab_size or find_multiple(
            self.vocab_size, self.padding_multiple
        )


# ---------------------------------------------------------------------------
# Named-architecture registry (nlp/modules/gpt/config.py:17 `Config.from_name`
# analogue).  Hyperparameters are the public HF model-card values; families:
# Pythia/Dolly/RedPajama (GPT-NeoX lineage), Falcon, Llama-2 + derivatives
# (vicuna, longchat, Nous-Hermes, Platypus, FreeWilly2, function-calling,
# 32K rope-condensed), open_llama, CodeLlama, TinyLlama, StableLM/StableCode,
# phi, Gemma, Mistral/Mixtral (MoE).  Family traits are encoded once in the
# helper functions below; per-model rows carry only what differs.
# ---------------------------------------------------------------------------


def _neox(n_layer, n_head, n_embd, *, rotary=0.25, parallel=True, **kw):
    """GPT-NeoX lineage (Pythia/Dolly/RedPajama/StableLM-alpha): LayerNorm,
    biased linears, GptNeoxMLP, 0.25 rotary unless overridden."""
    kw.setdefault("vocab_size", 50254)
    kw.setdefault("padding_multiple", 128)
    kw.setdefault("block_size", 2048)
    kw.setdefault("intermediate_size", 4 * n_embd)
    return GPTConfig(
        n_layer=n_layer, n_head=n_head, n_embd=n_embd, n_query_groups=None,
        rotary_percentage=rotary, parallel_residual=parallel, bias=True,
        norm_class="LayerNorm", mlp_class="GptNeoxMLP", **kw,
    )


def _llama(n_layer, n_head, n_embd, intermediate, *, groups=None, **kw):
    """Llama lineage: RMSNorm, SwiGLU, full rotary, no biases."""
    kw.setdefault("vocab_size", 32000)
    kw.setdefault("padding_multiple", 64)
    kw.setdefault("block_size", 4096)
    return GPTConfig(
        n_layer=n_layer, n_head=n_head, n_embd=n_embd,
        intermediate_size=intermediate, n_query_groups=groups,
        rotary_percentage=1.0, parallel_residual=False, bias=False,
        norm_class="RMSNorm", mlp_class="LLaMAMLP", **kw,
    )


def _falcon(n_layer, n_head, n_embd, *, groups, **kw):
    return GPTConfig(
        vocab_size=65024, padded_vocab_size=65024, block_size=2048,
        n_layer=n_layer, n_head=n_head, n_embd=n_embd, head_dim=64,
        n_query_groups=groups, intermediate_size=4 * n_embd,
        rotary_percentage=1.0, parallel_residual=True, bias=False,
        norm_class="LayerNorm", mlp_class="GptNeoxMLP", **kw,
    )


def _phi(n_layer, n_embd, rotary):
    return GPTConfig(
        vocab_size=50257, padded_vocab_size=51200, block_size=2048,
        n_layer=n_layer, n_head=32, n_embd=n_embd, n_query_groups=None,
        intermediate_size=4 * n_embd, rotary_percentage=rotary,
        parallel_residual=True, shared_attention_norm=True, bias=True,
        lm_head_bias=True, norm_class="LayerNorm", mlp_class="GptNeoxMLP",
        gelu_approximate="tanh",
    )


def _gemma(n_layer, n_head, n_embd, intermediate, *, groups=None, head_dim=None):
    return GPTConfig(
        vocab_size=256000, padding_multiple=64, block_size=8192,
        n_layer=n_layer, n_head=n_head, n_embd=n_embd, head_dim=head_dim,
        n_query_groups=groups, intermediate_size=intermediate,
        rotary_percentage=1.0, parallel_residual=False, bias=False,
        norm_class="RMSNorm", mlp_class="GemmaMLP", gelu_approximate="tanh",
        scale_embeddings=True,
    )


def _mistral(*, block_size, mlp="LLaMAMLP", **kw):
    return GPTConfig(
        vocab_size=32000, padded_vocab_size=32000, block_size=block_size,
        n_layer=32, n_head=32, n_embd=4096, n_query_groups=8,
        intermediate_size=14336, rotary_percentage=1.0,
        parallel_residual=False, bias=False, norm_class="RMSNorm",
        mlp_class=mlp, **kw,
    )


def _stablelm_4e1t(**kw):
    """stablelm-3b-4e1t generation: SwiGLU + LayerNorm + 0.25 rotary."""
    kw.setdefault("block_size", 4096)
    return GPTConfig(
        vocab_size=50254, padded_vocab_size=50304, n_layer=32, n_head=32,
        n_embd=2560, n_query_groups=None, intermediate_size=6912,
        rotary_percentage=0.25, parallel_residual=False, bias=False,
        norm_class="LayerNorm", mlp_class="LLaMAMLP", **kw,
    )


def _expand(table: Dict[str, tuple]) -> Dict[str, GPTConfig]:
    """Expand '{}'-template names (reference config.py style): the tuple is
    (config, [suffixes]); 'falcon-7b{}' + ['', '-instruct'] -> two entries."""
    out: Dict[str, GPTConfig] = {}
    for name, (cfg, suffixes) in table.items():
        for s in suffixes:
            out[name.format(s)] = cfg
    return out


_LLAMA2_7B = _llama(32, 32, 4096, 11008)
_LLAMA2_13B = _llama(40, 40, 5120, 13824)
_LLAMA2_70B = _llama(80, 64, 8192, 28672, groups=8)
_CODELLAMA = dict(block_size=16384, rope_base=1000000.0, norm_eps=1e-5)

GPT_CONFIGS: Dict[str, GPTConfig] = {
    # --- Pythia (EleutherAI suite, 14m..12b) + Dolly-v2 / RedPajama tunes ---
    "pythia-14m": _neox(6, 4, 128, block_size=512),
    "pythia-31m": _neox(6, 8, 256, block_size=1024),
    "pythia-70m": _neox(6, 8, 512),
    "pythia-160m": _neox(12, 12, 768),
    "pythia-410m": _neox(24, 16, 1024),
    "pythia-1b": _neox(16, 8, 2048),
    "pythia-1.4b": _neox(24, 16, 2048),
    "pythia-2.8b": _neox(32, 32, 2560),
    "pythia-6.9b": _neox(32, 32, 4096, padding_multiple=256),
    "pythia-12b": _neox(36, 40, 5120),
    "dolly-v2-3b": _neox(32, 32, 2560, padded_vocab_size=50280),
    "dolly-v2-7b": _neox(32, 32, 4096, padded_vocab_size=50280),
    "dolly-v2-12b": _neox(36, 40, 5120, padded_vocab_size=50280),
    # --- open_llama ---
    "open_llama_3b": _llama(26, 32, 3200, 8640, block_size=2048, norm_eps=1e-6),
    "open_llama_7b": _llama(32, 32, 4096, 11008, block_size=2048, norm_eps=1e-6),
    "open_llama_13b": _llama(40, 40, 5120, 13824, block_size=2048, norm_eps=1e-6),
    # --- vicuna / longchat (llama chat tunes; v1.5-16k condenses rope 4x) ---
    "vicuna-7b-v1.3": _llama(32, 32, 4096, 11008, block_size=2048, norm_eps=1e-6),
    "vicuna-13b-v1.3": _llama(40, 40, 5120, 13824, block_size=2048, norm_eps=1e-6),
    "vicuna-33b-v1.3": _llama(60, 52, 6656, 17920, block_size=2048, norm_eps=1e-6),
    "vicuna-7b-v1.5": _llama(32, 32, 4096, 11008),
    "vicuna-7b-v1.5-16k": _llama(
        32, 32, 4096, 11008, block_size=16384, rope_condense_ratio=4.0
    ),
    "vicuna-13b-v1.5": _llama(40, 40, 5120, 13824),
    "vicuna-13b-v1.5-16k": _llama(
        40, 40, 5120, 13824, block_size=16384, rope_condense_ratio=4.0
    ),
    "longchat-7b-16k": _llama(
        32, 32, 4096, 11008, block_size=16384, norm_eps=1e-6,
        rope_condense_ratio=8.0,
    ),
    "longchat-13b-16k": _llama(
        40, 40, 5120, 13824, block_size=16384, norm_eps=1e-6,
        rope_condense_ratio=8.0,
    ),
    # --- Nous-Hermes / Platypus / FreeWilly2 (llama fine-tune shapes) ---
    "Nous-Hermes-llama-2-7b": _llama(32, 32, 4096, 11008, padded_vocab_size=32000),
    "Nous-Hermes-13b": _llama(
        40, 40, 5120, 13824, block_size=2048, norm_eps=1e-6,
        padded_vocab_size=32001,
    ),
    "Nous-Hermes-Llama2-13b": _llama(40, 40, 5120, 13824, padded_vocab_size=32032),
    "Platypus-30B": _llama(
        60, 52, 6656, 17920, block_size=2048, norm_eps=1e-6,
        padded_vocab_size=32000,
    ),
    "Platypus2-7B": _llama(32, 32, 4096, 11008, padded_vocab_size=32000),
    "Platypus2-13B": _llama(40, 40, 5120, 13824, padded_vocab_size=32000),
    "Platypus2-70B": _llama(80, 64, 8192, 28672, padded_vocab_size=32000),
    "Platypus2-70B-instruct": _llama(
        80, 64, 8192, 28672, groups=8, padded_vocab_size=32000
    ),
    "Camel-Platypus2-13B": _llama(40, 40, 5120, 13824, padded_vocab_size=32000),
    "Camel-Platypus2-70B": _llama(
        80, 64, 8192, 28672, groups=8, padded_vocab_size=32000
    ),
    "Stable-Platypus2-13B": _llama(40, 40, 5120, 13824, padded_vocab_size=32000),
    "FreeWilly2": _llama(80, 64, 8192, 28672, groups=8, padded_vocab_size=32000),
    "LLaMA-2-7B-32K": _llama(32, 32, 4096, 11008, rope_condense_ratio=8.0),
    "Llama-2-7b-chat-hf-function-calling-v2": _llama(
        32, 32, 4096, 11008, norm_eps=1e-6
    ),
    # --- phi / Gemma ---
    "phi-1_5": _phi(24, 2048, 0.5),
    "phi-2": _phi(32, 2560, 0.4),
    "gemma-2b": _gemma(18, 8, 2048, 16384, groups=1),
    "gemma-7b": _gemma(28, 16, 3072, 24576, head_dim=256),
    # --- Mistral / Mixtral ---
    "Mistral-7B-v0.2": _mistral(block_size=32768),
    "Mistral-7B-Instruct-v0.2": _mistral(block_size=32768),
    # --- StableLM / StableCode ---
    "stablelm-base-alpha-3b": _neox(
        16, 32, 4096, block_size=4096, padding_multiple=512
    ),
    "stablelm-base-alpha-7b": _neox(
        16, 48, 6144, block_size=4096, padding_multiple=256
    ),
    "stablelm-tuned-alpha-3b": _neox(
        16, 32, 4096, block_size=4096, padding_multiple=512
    ),
    "stablelm-tuned-alpha-7b": _neox(
        16, 48, 6144, block_size=4096, padding_multiple=256
    ),
    "stablelm-3b-4e1t": _stablelm_4e1t(),
    "stablelm-zephyr-3b": _stablelm_4e1t(),
    "stable-code-3b": _stablelm_4e1t(block_size=16384),
    "stablecode-completion-alpha-3b": _neox(
        32, 32, 2560, vocab_size=49152, block_size=16384
    ),
    "stablecode-completion-alpha-3b-4k": _neox(
        32, 32, 2560, vocab_size=49152, block_size=4096
    ),
    "stablecode-instruct-alpha-3b": _neox(
        32, 32, 2560, vocab_size=49152, block_size=4096
    ),
    # legacy aliases kept from earlier rounds
    "tiny-llama-1.1b": _llama(22, 32, 2048, 5632, groups=4, block_size=2048),
    "llama-2-7b": _LLAMA2_7B,
    "llama-2-13b": _LLAMA2_13B,
    "llama-2-70b": _LLAMA2_70B,
    "open-llama-3b": _llama(26, 32, 3200, 8640, block_size=2048, norm_eps=1e-6),
    **_expand({
        "falcon-7b{}": (
            _falcon(32, 71, 4544, groups=1, shared_attention_norm=True),
            ["", "-instruct"],
        ),
        "falcon-40b{}": (_falcon(60, 128, 8192, groups=8), ["", "-instruct"]),
        "falcon-180B{}": (_falcon(80, 232, 14848, groups=8), ["", "-chat"]),
        "Llama-2-7b{}-hf": (_LLAMA2_7B, ["", "-chat"]),
        "Llama-2-13b{}-hf": (_LLAMA2_13B, ["", "-chat"]),
        "Llama-2-70b{}-hf": (_LLAMA2_70B, ["", "-chat"]),
        "TinyLlama-1.1B{}": (
            _llama(22, 32, 2048, 5632, groups=4, block_size=2048),
            ["-intermediate-step-1431k-3T", "-Chat-v1.0"],
        ),
        "RedPajama-INCITE-{}-3B-v1": (
            _neox(32, 32, 2560, rotary=1.0, parallel=False,
                  padding_multiple=256),
            ["Base", "Chat", "Instruct"],
        ),
        "RedPajama-INCITE-7B-{}": (
            _neox(32, 32, 4096, rotary=1.0, parallel=False,
                  padding_multiple=256),
            ["Base", "Chat", "Instruct"],
        ),
        "RedPajama-INCITE-{}-7B-v0.1": (
            _neox(32, 32, 4096, rotary=1.0, parallel=False,
                  padding_multiple=256),
            ["Base", "Chat", "Instruct"],
        ),
        "CodeLlama-7b{}-hf": (
            _llama(32, 32, 4096, 11008, vocab_size=32016,
                   padding_multiple=16, **_CODELLAMA),
            ["", "-Python", "-Instruct"],
        ),
        "CodeLlama-13b{}-hf": (
            _llama(40, 40, 5120, 13824, vocab_size=32016,
                   padding_multiple=16, **_CODELLAMA),
            ["", "-Python", "-Instruct"],
        ),
        "CodeLlama-34b{}-hf": (
            _llama(48, 64, 8192, 22016, groups=8,
                   padded_vocab_size=32000, **_CODELLAMA),
            ["", "-Python", "-Instruct"],
        ),
        "CodeLlama-70b{}-hf": (
            _llama(80, 64, 8192, 28672, groups=8, vocab_size=32016,
                   padding_multiple=16, **_CODELLAMA),
            ["", "-Python", "-Instruct"],
        ),
        "Mistral-7B-{}v0.1": (_mistral(block_size=4096), ["", "Instruct-"]),
        "Mixtral-8x7B-{}v0.1": (
            _mistral(block_size=32768, mlp="LLaMAMoE", rope_base=1000000.0,
                     n_expert=8, n_expert_per_token=2),
            ["", "Instruct-"],
        ),
    }),
}


def config_from_name(name: str, **overrides) -> GPTConfig:
    """Resolve a config by exact name or shell-style pattern
    (`Config.from_name` semantics: 'pythia-1*' matches the first entry;
    kwargs override fields, config.py:101-115)."""
    cfg = GPT_CONFIGS.get(name)
    if cfg is None:
        # case-insensitive exact match (the reference resolves e.g. both
        # "Gemma-2b" and "gemma-2b", config.py name= vs hf_config name)
        lowered = {k.lower(): v for k, v in GPT_CONFIGS.items()}
        cfg = lowered.get(name.lower())
    if cfg is None:
        import fnmatch

        for key in GPT_CONFIGS:
            if fnmatch.fnmatch(key, name) or fnmatch.fnmatch(
                key.lower(), name.lower()
            ):
                cfg = GPT_CONFIGS[key]
                break
        else:
            raise ValueError(
                f"unknown GPT config {name!r}; known: {sorted(GPT_CONFIGS)}"
            )
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def _as(p: Optional[torch.Tensor], x: torch.Tensor) -> Optional[torch.Tensor]:
    """Parameter `p` in the type of activation `x` (a differentiable cast)."""
    return p if p is None or p.dtype == x.dtype else p.to(x.dtype)


class Linear(nn.Linear):
    """`nn.Linear` that computes in its input's type."""

    def forward(self, x):
        return F.linear(x, _as(self.weight, x), _as(self.bias, x))


class LayerNorm(nn.LayerNorm):
    """`nn.LayerNorm` that computes in its input's type."""

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, _as(self.weight, x), _as(self.bias, x),
                            self.eps)


class RMSNorm(nn.Module):
    """Root-mean-square norm; the variance is taken in fp32."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        var = x.float().square().mean(dim=-1, keepdim=True)
        return (x * torch.rsqrt(var + self.eps)).to(x.dtype) * _as(self.weight, x)


class LLaMAMLP(nn.Module):
    """SwiGLU MLP: silu(x W1) * (x W3) W2."""

    def __init__(self, n_embd: int, intermediate_size: int, bias: bool = False):
        super().__init__()
        self.fc_1 = Linear(n_embd, intermediate_size, bias=bias)
        self.fc_2 = Linear(n_embd, intermediate_size, bias=bias)
        self.proj = Linear(intermediate_size, n_embd, bias=bias)

    def forward(self, x):
        return self.proj(F.silu(self.fc_1(x)) * self.fc_2(x))


class GemmaMLP(LLaMAMLP):
    """Gemma's GeGLU: gelu_tanh(x W1) * (x W3) W2."""

    def forward(self, x):
        return self.proj(F.gelu(self.fc_1(x), approximate="tanh") * self.fc_2(x))


class GptNeoxMLP(nn.Module):
    def __init__(self, n_embd: int, intermediate_size: int, bias: bool = True,
                 gelu_approximate: str = "none"):
        super().__init__()
        self.fc = Linear(n_embd, intermediate_size, bias=bias)
        self.proj = Linear(intermediate_size, n_embd, bias=bias)
        self.gelu_approximate = "tanh" if gelu_approximate == "tanh" else "none"

    def forward(self, x):
        return self.proj(F.gelu(self.fc(x), approximate=self.gelu_approximate))


def _make_mlp(cfg: GPTConfig) -> nn.Module:
    inter = cfg.intermediate_size or 4 * cfg.n_embd
    if cfg.mlp_class == "LLaMAMLP":
        return LLaMAMLP(cfg.n_embd, inter, bias=cfg.bias)
    if cfg.mlp_class == "GemmaMLP":
        return GemmaMLP(cfg.n_embd, inter, bias=cfg.bias)
    if cfg.mlp_class == "GptNeoxMLP":
        return GptNeoxMLP(cfg.n_embd, inter, bias=cfg.bias,
                          gelu_approximate=cfg.gelu_approximate)
    if cfg.mlp_class == "LLaMAMoE":
        return MoEMLP(cfg.n_embd, n_experts=cfg.n_expert, ff_dim=inter,
                      top_k=cfg.n_expert_per_token)
    raise ValueError(f"unknown mlp_class {cfg.mlp_class!r}")


def _make_norm(cfg: GPTConfig) -> nn.Module:
    if cfg.norm_class == "RMSNorm":
        return RMSNorm(cfg.n_embd, cfg.norm_eps)
    return LayerNorm(cfg.n_embd, eps=cfg.norm_eps)


KVCache = Tuple[torch.Tensor, torch.Tensor]


class CausalSelfAttention(nn.Module):
    """GQA causal attention with RoPE and optional KV-cache decode."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.config = cfg
        hs, nh, ng = cfg.head_size, cfg.n_head, cfg.groups
        self.attn = Linear(cfg.n_embd, (nh + 2 * ng) * hs, bias=cfg.bias)
        self.proj = Linear(nh * hs, cfg.n_embd, bias=cfg.bias)
        self.scale = 1.0 / math.sqrt(hs)

    def takes_flash(self, pos_offset: int, kv_cache) -> bool:
        """Flash only on the from-scratch path: a nonzero pos_offset shifts
        the causal diagonal, which the kernels' position-aligned mask cannot
        express."""
        return self.config.use_flash and kv_cache is None and pos_offset == 0

    def qkv(self, x, cos, sin):
        """x [B, T, n_embd] -> q [B, T, nh, hs], k and v [B, T, ng, hs], q and
        k rotated on their first `rope_n_elem` channels."""
        cfg = self.config
        b, t, _ = x.shape
        hs, nh, ng = cfg.head_size, cfg.n_head, cfg.groups
        q, k, v = self.attn(x).split([nh * hs, ng * hs, ng * hs], dim=-1)
        q, k, v = q.reshape(b, t, nh, hs), k.reshape(b, t, ng, hs), v.reshape(b, t, ng, hs)
        ne = cfg.rope_n_elem
        q = torch.cat([apply_rope(q[..., :ne], cos, sin), q[..., ne:]], dim=-1)
        k = torch.cat([apply_rope(k[..., :ne], cos, sin), k[..., ne:]], dim=-1)
        return q, k, v

    def expand_groups(self, k, v):
        """K and V repeated to the query heads, as the kernels want them (the
        sum over the copies in the backward is autograd's)."""
        rep = self.config.n_head // self.config.groups
        if rep == 1:
            return k.contiguous(), v.contiguous()
        return k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)

    def einsum_attention(self, q, k, v, pos_offset: int, mask):
        """GQA without materialising per-head K/V: the group is folded into
        the contraction.  Head h = g * rep + r is q5[..., g, r, :]."""
        cfg = self.config
        b, t, nh, hs = q.shape
        ng = cfg.groups
        t_k = k.shape[1]
        q5 = q.reshape(b, t, ng, nh // ng, hs)
        scores = torch.einsum("bqgrd,bkgd->bgrqk", q5, k) * self.scale
        q_pos = pos_offset + torch.arange(t, device=q.device)[:, None]
        k_pos = torch.arange(t_k, device=q.device)[None, :]
        scores = torch.where(k_pos <= q_pos, scores, -1e9)
        if mask is not None:
            scores = torch.where(mask[:, None, None, None, :t_k], scores, -1e9)
        probs = torch.softmax(scores, dim=-1)
        return torch.einsum("bgrqk,bkgd->bqgrd", probs, v).reshape(b, t, nh * hs)

    def forward(self, x, cos, sin, pos_offset: int = 0, kv_cache: Optional[KVCache] = None,
                mask=None):
        b, t, _ = x.shape
        q, k, v = self.qkv(x, cos, sin)
        new_cache = None
        if kv_cache is not None:
            ck, cv = kv_cache  # [B, block, G, hs], written in place
            ck[:, pos_offset:pos_offset + t] = k
            cv[:, pos_offset:pos_offset + t] = v
            k, v = ck, cv
            new_cache = (ck, cv)
        if self.takes_flash(pos_offset, kv_cache):
            out = flash_self_attention(q.contiguous(), *self.expand_groups(k, v), mask,
                                       self.scale, causal=True).reshape(b, t, -1)
        else:
            out = self.einsum_attention(q, k, v, pos_offset, mask)
        return self.proj(out), new_cache


class Block(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.config = cfg
        self.norm_1 = _make_norm(cfg)
        self.attn = CausalSelfAttention(cfg)
        if not (cfg.parallel_residual and cfg.shared_attention_norm):
            self.norm_2 = _make_norm(cfg)
        self.mlp = _make_mlp(cfg)
        self.moe_aux: Optional[Dict[str, torch.Tensor]] = None

    def _mlp(self, x):
        out = self.mlp(x)
        if isinstance(self.mlp, MoEMLP):  # (y, aux losses)
            out, aux = out
            self.moe_aux = {k: v.detach() for k, v in aux.items()}
        return out

    def _finish(self, x, x_norm, h):
        """Residuals and MLP, from the block's input, its first norm and the
        attention branch's output."""
        cfg = self.config
        if cfg.parallel_residual:
            # falcon-7b / phi share norm_1 between the attention and MLP branches
            m_in = x_norm if cfg.shared_attention_norm else self.norm_2(x)
            return x + h + self._mlp(m_in)
        x = x + h
        return x + self._mlp(self.norm_2(x))

    def forward(self, x, cos, sin, pos_offset: int = 0, kv_cache: Optional[KVCache] = None,
                mask=None):
        x_norm = self.norm_1(x)
        h, new_cache = self.attn(x_norm, cos, sin, pos_offset, kv_cache, mask)
        return self._finish(x, x_norm, h), new_cache

    # `remat_policy="flash"`: the block in three parts, so that the part
    # before the attention call and the part after it can be recomputed in the
    # backward while the attention's autograd Function, which stands outside
    # both, keeps its q, k, v, o and lse.

    def _before_attention(self, x, cos, sin):
        x_norm = self.norm_1(x)
        q, k, v = self.attn.qkv(x_norm, cos, sin)
        shared = self.config.parallel_residual and self.config.shared_attention_norm
        return (q.contiguous(), *self.attn.expand_groups(k, v), x_norm if shared else None)

    def _after_attention(self, x, x_norm, out):
        return self._finish(x, x_norm, self.attn.proj(out))

    def forward_keeping_attention(self, x, cos, sin, mask):
        q, k, v, x_norm = _checkpoint(self._before_attention, x, cos, sin)
        out = flash_self_attention(q, k, v, mask, self.attn.scale, causal=True)
        return _checkpoint(self._after_attention, x, x_norm, out.reshape(*x.shape[:2], -1))


def _checkpoint(fn, *args):
    # no dropout anywhere in the model: nothing random to replay
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


class GPT(nn.Module):
    """Token ids -> logits; full-sequence and cached decode."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.config = cfg
        self.compute_dtype: Optional[torch.dtype] = None  # None: the parameters' own type
        self.wte = nn.Embedding(cfg.padded_vocab, cfg.n_embd)
        self.h = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layer))
        self.ln_f = _make_norm(cfg)
        self.lm_head = Linear(cfg.n_embd, cfg.padded_vocab, bias=cfg.lm_head_bias)
        cos, sin = build_rope_cache(cfg.block_size, cfg.rope_n_elem, base=cfg.rope_base,
                                    condense_ratio=cfg.rope_condense_ratio)
        self.register_buffer("rope_cos", torch.from_numpy(cos), persistent=False)
        self.register_buffer("rope_sin", torch.from_numpy(sin), persistent=False)

    def forward(self, tokens, pos_offset: int = 0, kv_caches: Optional[List[KVCache]] = None,
                mask=None, return_hidden: bool = False, mark=None):
        """`return_hidden=True` skips the lm_head projection and returns the
        post-ln_f hiddens [B, T, D]: the input the fused cross-entropy loss
        (ops/fused_ce.py) projects tile by tile.  With `kv_caches`, returns
        (result, caches).  `mark(name)` is a profiling hook and nothing else:
        when given, it is called as each part has been enqueued ("embedding",
        "blocks_forward")."""
        cfg = self.config
        t = tokens.shape[1]
        if pos_offset + t > cfg.block_size:
            raise ValueError(f"positions {pos_offset}..{pos_offset + t} exceed block_size "
                             f"{cfg.block_size}")
        if cfg.scan_layers and kv_caches is not None:
            raise ValueError("scan_layers is a training-path option; for KV-cache decode use "
                             "scan_layers=False")
        dtype = self.compute_dtype or self.wte.weight.dtype
        table = self.wte.weight
        x = F.embedding(tokens, table if table.dtype == dtype else table.to(dtype))
        if cfg.scale_embeddings:  # Gemma
            x = x * torch.tensor(math.sqrt(cfg.n_embd), dtype=x.dtype, device=x.device)
        if mark is not None:
            mark("embedding")
        cos = self.rope_cos[pos_offset:pos_offset + t]
        sin = self.rope_sin[pos_offset:pos_offset + t]
        remat = cfg.remat and kv_caches is None and torch.is_grad_enabled()
        new_caches = []
        for i, block in enumerate(self.h):
            if remat and cfg.remat_policy == "flash" and block.attn.takes_flash(pos_offset, None):
                x = block.forward_keeping_attention(x, cos, sin, mask)
            elif remat:
                x = _checkpoint(lambda x_, b=block: b(x_, cos, sin, pos_offset, None, mask)[0], x)
            else:
                x, cache = block(x, cos, sin, pos_offset,
                                 kv_caches[i] if kv_caches is not None else None, mask)
                new_caches.append(cache)
        if mark is not None:
            mark("blocks_forward")
        x = self.ln_f(x)
        out = x if return_hidden else self.lm_head(x)
        return out if kv_caches is None else (out, new_caches)


@torch.no_grad()
def init_parameters(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Draw every parameter under `module` from the distribution the flax
    module's initialisers use: lecun-normal kernels and zero biases for the
    linear layers, fan-in normal embeddings, norms at (1, 0), and the MoE
    experts' [E, in, out] weights lecun-normal over a fan-in of E * in (flax
    counts the leading axis as receptive field).  The numbers are drawn on the
    generator's device: give one on the parameters' device to draw a large
    model there."""
    for m in module.modules():
        if isinstance(m, MoEMLP):
            for w in (m.w_gate, m.w_up, m.w_down):
                trunc_normal_(w, (w.shape[0] * w.shape[1]) ** -0.5, generator)
        if isinstance(m, nn.Linear):
            trunc_normal_(m.weight, m.weight.shape[1] ** -0.5, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(
                m.weight.shape, generator=generator,
                device=None if generator is None else generator.device) * m.weight.shape[1] ** -0.5)
        elif isinstance(m, (nn.LayerNorm, RMSNorm)):
            m.weight.fill_(1.0)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()


def init_kv_caches(cfg: GPTConfig, batch: int, dtype=torch.float32, device=None
                   ) -> List[KVCache]:
    """Pre-allocated [B, block_size, groups, head_size] caches per layer."""
    shape = (batch, cfg.block_size, cfg.groups, cfg.head_size)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device)) for _ in range(cfg.n_layer)]


@torch.no_grad()
def generate(model: GPT, prompt: torch.Tensor, max_new_tokens: int, temperature: float = 1.0,
             top_k: Optional[int] = None, generator: Optional[torch.Generator] = None
             ) -> torch.Tensor:
    """Greedy (`temperature=0`) or top-k sampling with a KV cache: prompt
    [B, T0] -> [B, T0 + max_new_tokens].  Samples are drawn from `generator`
    (on the prompt's device; seeded with 0 when none is given)."""
    cfg = model.config
    b, t0 = prompt.shape
    if t0 + max_new_tokens > cfg.block_size:
        raise ValueError(f"prompt {t0} + {max_new_tokens} new tokens exceed block_size "
                         f"{cfg.block_size}")
    if generator is None:
        generator = torch.Generator(device=prompt.device).manual_seed(0)
    dtype = model.compute_dtype or model.wte.weight.dtype
    caches = init_kv_caches(cfg, b, dtype=dtype, device=prompt.device)
    logits, caches = model(prompt, 0, caches)  # prefill
    last_logits = logits[:, -1]

    def sample(logits):
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1).to(prompt.dtype)
        logits = logits.float() / max(temperature, 1e-6)
        if top_k is not None:
            kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
            logits = torch.where(logits < kth, -1e9, logits)
        probs = torch.softmax(logits, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(prompt.dtype)

    tokens = [prompt]
    for i in range(max_new_tokens):
        tok = sample(last_logits)
        tokens.append(tok[:, None])
        if i + 1 < max_new_tokens:
            logits, caches = model(tok[:, None], t0 + i, caches)
            last_logits = logits[:, 0]
    return torch.cat(tokens, dim=1)
