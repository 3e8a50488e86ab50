"""GPTLMModel: the causal-LM pretraining task for the supervised engine.

Port of roar_tpu/models/gpt_model.py: `models/gpt.py`'s GPT wrapped in the
task protocol of `training/trainer.py` (`module`, `loss_fn(batch, epoch,
mark=None)`, `set_dropout_generator`, `to_jax_tree`): packed next-token cross
entropy with metrics `loss`, `ppl` and `token_acc`.

Config precedence, carried over as the JAX package has it: every `GPTConfig`
field present in the config overrides the registry entry named by
`config_name` (`dataclasses.replace`), so a config that names
`tiny-llama-1.1b` and also sets `n_layer: 6` builds six layers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from roar_tpu_torch.models.gpt import GPT, GPTConfig, config_from_name, init_parameters
from roar_tpu_torch.ops.fused_ce import fused_cross_entropy


class GPTLMModel:
    """Config keys: either `config_name` (a registry entry of
    `models/gpt.py::GPT_CONFIGS`, fnmatch patterns allowed) or explicit
    `GPTConfig` fields; both accept field overrides (`vocab_size` is normally
    set from the tokenizer by the CLI).  `fused_ce` (default true) takes the
    chunked loss of `ops/fused_ce.py`; false keeps the unfused form.  With a
    `generator` the parameters are drawn from it as the flax initialisers
    would draw them."""

    def __init__(self, cfg: Optional[Dict[str, Any]] = None,
                 generator: Optional[torch.Generator] = None):
        cfg = dict(cfg or {})
        field_names = {f.name for f in dataclasses.fields(GPTConfig)}
        overrides = {k: v for k, v in cfg.items() if k in field_names}
        name = cfg.get("config_name")
        self.config = config_from_name(name, **overrides) if name else GPTConfig(**overrides)
        self.module = GPT(self.config)
        if generator is not None:
            self.init_parameters(generator)
        self.fused_ce = bool(cfg.get("fused_ce", True))

    def parameters(self):
        return list(self.module.parameters())

    def init_parameters(self, generator: torch.Generator) -> None:
        """Draw the parameters from `generator`, which lives on their device."""
        init_parameters(self.module, generator)

    def set_compute_dtype(self, dtype: Optional[torch.dtype]) -> None:
        """The bf16 form of the task: forward and backward in `dtype` from
        casts of the fp32 master parameters (None: in the masters' own type)."""
        self.module.compute_dtype = dtype

    def set_dropout_generator(self, generator: Optional[torch.Generator]) -> None:
        """The model has no dropout; the trainer's protocol asks for the hook."""

    def to_jax_tree(self) -> Dict[str, Any]:
        """The parameters as the flax tree the JAX package's task holds (what
        a `.roar` bundle stores): `h_scan` stacked when `scan_layers`."""
        from roar_tpu_torch.training import convert

        return convert.gpt_to_jax_tree(self.module)

    def loss_fn(self, batch: Dict[str, torch.Tensor], epoch: int = 0,
                mark=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Packed causal cross entropy.  `labels` are the next-token ids
        (`CausalLMDataset`); an optional `loss_mask` (0/1) supports padded or
        instruction-masked batches.  `mark(name)`, when given, is called as
        each part has been enqueued (the module's "embedding" and
        "blocks_forward", then "model_forward" and "loss")."""
        tokens, labels = batch["input_ids"].long(), batch["labels"].long()
        mask = batch.get("loss_mask")
        module_mark, mark = mark, mark or (lambda name: None)
        if self.fused_ce:
            hidden = self.module(tokens, return_hidden=True, mark=module_mark)
            mark("model_forward")
            head = self.module.lm_head
            weight = head.weight if head.weight.dtype == hidden.dtype \
                else head.weight.to(hidden.dtype)
            bias = head.bias if head.bias is None or head.bias.dtype == hidden.dtype \
                else head.bias.to(hidden.dtype)
            loss, acc = fused_cross_entropy(hidden, weight.t(), labels, bias=bias, loss_mask=mask)
        else:
            logits = self.module(tokens, mark=module_mark).float()
            mark("model_forward")
            nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, labels[..., None])[..., 0]
            hit = (logits.argmax(dim=-1) == labels).float()
            if mask is not None:
                m = mask.float()
                denom = m.sum().clamp(min=1.0)
                loss, acc = (nll * m).sum() / denom, (hit * m).sum() / denom
            else:
                loss, acc = nll.mean(), hit.mean()
        mark("loss")
        detached = loss.detach()
        return loss, {"loss": detached, "ppl": torch.exp(detached.clamp(max=20.0)),
                      "token_acc": acc.detach()}
