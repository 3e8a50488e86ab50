"""Text generation: the sampling transforms and the TextGeneration API.

Port of roar_tpu/models/text_generation.py over the port's `GPT` and its
in-place KV caches (`models/gpt.py::init_kv_caches`).  The semantics are the
JAX package's:
- `apply_top_k` keeps every logit tied with the k-th largest;
- `apply_top_p` keeps the tokens before the one whose cumulative probability
  crosses p, that one, and every logit equal to the smallest kept;
- `sample_logits` applies the repetition penalty, then the temperature, then
  top-k, then top-p, and is greedy when `use_greedy` or `temperature == 0`;
- `generate_tokens` decodes with a KV cache; before `min_length` new tokens
  the end token is suppressed, and a finished row repeats `end_id`; `logprob`
  is the log-softmax of the raw logits the token was drawn from, before any
  transform.  The penalty's "seen" set is built from the prompt and the
  tokens so far, padded with zeros for the positions still to come, so token
  id 0 always counts as seen (the JAX package's behaviour, kept).

Random draws come from an explicit `torch.Generator`.  `jax.random` and
`torch.multinomial` draw different streams, so sampled tokens agree with the
JAX package's only in distribution, not token by token.
"""

from __future__ import annotations

from typing import List, Optional, TypedDict

import numpy as np
import torch

from roar_tpu_torch.models.gpt import init_kv_caches


class LengthParam(TypedDict):
    max_length: int
    min_length: int


class SamplingParam(TypedDict, total=False):
    use_greedy: bool
    temperature: float
    top_k: int
    top_p: float
    repetition_penalty: float
    add_BOS: bool
    all_probs: bool
    compute_logprob: bool
    end_strings: List[str]


class OutputType(TypedDict, total=False):
    sentences: List[str]
    tokens: List[List[str]]
    logprob: List[List[float]]
    full_logprob: List[List[float]]
    token_ids: List[List[int]]
    offsets: List[List[int]]


# ---- logits transforms ---------------------------------------------------


def apply_temperature(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    return logits / max(temperature, 1e-6)


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k highest logits and every logit tied with the k-th; the
    rest get -inf."""
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, -torch.inf, logits)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest set of tokens whose cumulative
    probability reaches p (the token that crosses p is kept)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = cum - probs < p
    thresh = torch.where(keep_sorted, sorted_logits, torch.inf).amin(dim=-1, keepdim=True)
    return torch.where(logits < thresh, -torch.inf, logits)


def apply_repetition_penalty(logits: torch.Tensor, prev_tokens: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """CTRL-style penalty: the logits of tokens in `prev_tokens` [B, T_prev]
    are divided by `penalty` where positive and multiplied where negative."""
    seen = torch.zeros(logits.shape, dtype=torch.bool, device=logits.device)
    seen.scatter_(1, prev_tokens.long(), True)
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def sample_logits(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
                  use_greedy: bool = False, temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 0.0, repetition_penalty: float = 1.0,
                  prev_tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One sampling step [B, vocab] -> [B] (int64)."""
    if repetition_penalty != 1.0 and prev_tokens is not None:
        logits = apply_repetition_penalty(logits, prev_tokens, repetition_penalty)
    if use_greedy or temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = apply_temperature(logits, temperature)
    if top_k and top_k > 0:
        logits = apply_top_k(logits, top_k)
    if top_p and 0.0 < top_p < 1.0:
        logits = apply_top_p(logits, top_p)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


# ---- the decoding loop ---------------------------------------------------


@torch.no_grad()
def generate_tokens(model, prompt: torch.Tensor, length_params: Optional[LengthParam] = None,
                    sampling_params: Optional[SamplingParam] = None,
                    end_id: Optional[int] = None, generator: Optional[torch.Generator] = None,
                    return_logits: bool = False):
    """KV-cached decode of the port's `GPT` with the full SamplingParam surface.

    prompt [B, T0] (on the model's device) -> (token_ids [B, T0 + max_length],
    logprob [B, max_length]); with `return_logits`, also the raw logits each
    new token was drawn from, [B, max_length, vocab].  Samples come from
    `generator` (on the prompt's device; seeded with 0 when none is given)."""
    lp = {"max_length": 30, "min_length": 0, **(length_params or {})}
    sp = {"use_greedy": True, "temperature": 1.0, "top_k": 0, "top_p": 0.0,
          "repetition_penalty": 1.0, **(sampling_params or {})}
    cfg = model.config
    b, t0 = prompt.shape
    max_new = int(lp["max_length"])
    min_len = int(lp.get("min_length") or 0)
    if t0 + max_new > cfg.block_size:
        raise ValueError(f"prompt {t0} + {max_new} new tokens exceed block_size "
                         f"{cfg.block_size}")
    if generator is None:
        generator = torch.Generator(device=prompt.device).manual_seed(0)
    dtype = model.compute_dtype or model.wte.weight.dtype
    caches = init_kv_caches(cfg, b, dtype=dtype, device=prompt.device)
    logits, caches = model(prompt, 0, caches)  # prefill
    last_logits = logits[:, -1]

    prev = torch.cat([prompt, torch.zeros((b, max_new), dtype=prompt.dtype,
                                          device=prompt.device)], dim=1)
    finished = torch.zeros(b, dtype=torch.bool, device=prompt.device)
    is_end = None
    if end_id is not None:
        is_end = torch.arange(last_logits.shape[-1], device=prompt.device) == end_id
    toks, logps, kept = [], [], []
    for i in range(max_new):
        logits = last_logits
        if end_id is not None and i < min_len:  # suppress the end token before min_length
            logits = torch.where(is_end, -torch.inf, logits)
        tok = sample_logits(logits, generator, use_greedy=bool(sp["use_greedy"]),
                            temperature=float(sp["temperature"]), top_k=int(sp["top_k"]),
                            top_p=float(sp["top_p"]),
                            repetition_penalty=float(sp["repetition_penalty"]),
                            prev_tokens=prev).to(prompt.dtype)
        if end_id is not None:
            tok = torch.where(finished, torch.full_like(tok, end_id), tok)
            finished = finished | (tok == end_id)
        logp = torch.log_softmax(last_logits.float(), dim=-1)
        logps.append(logp.gather(1, tok[:, None].long())[:, 0])
        toks.append(tok)
        if return_logits:
            kept.append(last_logits.float())
        prev[:, t0 + i] = tok
        if i + 1 < max_new:  # the JAX loop's last model call feeds nothing back
            new_logits, caches = model(tok[:, None], t0 + i, caches)
            last_logits = new_logits[:, 0]
    token_ids = torch.cat([prompt, torch.stack(toks, dim=1)], dim=1)
    out = (token_ids, torch.stack(logps, dim=1))
    return out + (torch.stack(kept, dim=1),) if return_logits else out


class TextGeneration:
    """The reference TextGeneration interface over the port's GPT and a
    tokenizer: strings in, OutputType dict out.  The model runs on the
    device its parameters are on."""

    def __init__(self, model, tokenizer, end_id: Optional[int] = None):
        self.model = model
        self.tokenizer = tokenizer
        self.end_id = end_id

    @property
    def device(self) -> torch.device:
        return self.model.wte.weight.device

    def parse(self, str_input: str) -> torch.Tensor:
        ids = self.tokenizer(str_input)
        return torch.as_tensor(np.asarray(ids, np.int64), device=self.device)[None]

    def generate(self, inputs, length_params: Optional[LengthParam] = None,
                 sampling_params: Optional[SamplingParam] = None,
                 generator: Optional[torch.Generator] = None) -> OutputType:
        """`inputs`: a list of strings (right-padded with 0 to the longest),
        or `(prompt [B, T0], lengths)`."""
        if isinstance(inputs, (list, tuple)) and inputs and isinstance(inputs[0], str):
            rows = [np.asarray(self.tokenizer(s), np.int64) for s in inputs]
            prompt = np.zeros((len(rows), max(len(r) for r in rows)), np.int64)
            for i, r in enumerate(rows):
                prompt[i, :len(r)] = r
        else:
            prompt, _lens = inputs
        prompt = torch.as_tensor(np.asarray(prompt), device=self.device).long()
        token_ids, logps = generate_tokens(self.model, prompt, length_params, sampling_params,
                                           end_id=self.end_id, generator=generator)
        ids = token_ids.cpu().numpy()
        out: OutputType = {"token_ids": [list(map(int, row)) for row in ids],
                           "logprob": [list(map(float, row)) for row in logps.cpu().numpy()]}
        decode = getattr(self.tokenizer, "decode", None)
        if decode is not None:
            out["sentences"] = [decode(list(map(int, row))) for row in ids]
        return out
