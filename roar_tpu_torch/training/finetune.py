"""Parameter-efficient fine-tuning: trainable labels and the masked optimizer.

Port of roar_tpu/training/finetune.py.  The JAX package labels each leaf of
the parameter tree 'trainable' when its '/'-joined path matches one of the
regexes (`r"adapter"`, `r"speaker_table"`), and `optax.multi_transform` gives
the frozen leaves `set_to_zero`.  Here each parameter is labelled by its flax
path (the task's `flax_paths()`: FastPitch's through the converter's site
map), so the trainable set is the JAX package's leaf for leaf, and the
optimizer is built over the trainable parameters only: the frozen ones never
move and hold no optimizer state.  The trainer still computes their gradients
and counts them in `grad_norm`, as the JAX step does.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Sequence, Tuple

from roar_tpu_torch.training.optim import ScheduledOptimizer, build_optimizer


def param_labels(model, trainable_patterns: Sequence[str]) -> Dict[str, str]:
    """{flax path: 'trainable' | 'frozen'} of every parameter of `model` (a
    task with `flax_paths()`): 'trainable' when any regex of
    `trainable_patterns` is found in the path."""
    regexes = [re.compile(p) for p in trainable_patterns]
    return {path: "trainable" if any(r.search(path) for r in regexes) else "frozen"
            for path in model.flax_paths().values()}


def trainable_parameters(model, trainable_patterns: Sequence[str]) -> List[Any]:
    """The parameters of `model.module` whose flax path is 'trainable'."""
    labels = param_labels(model, trainable_patterns)
    paths = model.flax_paths()
    return [p for name, p in model.module.named_parameters()
            if labels[paths[name]] == "trainable"]


def masked_optimizer(optim_cfg: Dict[str, Any], model, trainable_patterns: Sequence[str],
                     **build_kwargs) -> ScheduledOptimizer:
    """`build_optimizer(optim_cfg, ...)` over the parameters matching
    `trainable_patterns` only; every other parameter is frozen."""
    params = trainable_parameters(model, trainable_patterns)
    if not params:
        raise ValueError(f"no parameter path matches {list(trainable_patterns)}")
    return build_optimizer(params, optim_cfg, **build_kwargs)


def count_trainable(model, trainable_patterns: Sequence[str]) -> Tuple[int, int]:
    """(n_trainable, n_total) parameter counts."""
    trainable = {id(p) for p in trainable_parameters(model, trainable_patterns)}
    params = list(model.module.parameters())
    return sum(p.numel() for p in params if id(p) in trainable), sum(p.numel() for p in params)
