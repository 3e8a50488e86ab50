"""Two-optimizer GAN training: the alternating D+G step.

Port of roar_tpu/training/gan.py `make_shared_forward_gan_step` to eager
PyTorch.  One step:

1. the generator forward runs once;
2. the discriminators' loss on the detached generator output (the spectral
   norm stores its new u and sigma here), its gradient, the D update;
3. the generator's loss through the UPDATED discriminators, its gradient
   taken with respect to the generator's parameters only (the
   discriminators' weights need none, so no weight gradient is computed
   for them), the G update.

The task is HiFi-GAN's (`HifiGanModel`: the generator is the vocoder) or
JETS's (`JETSModel`: the generator is the whole text->wav graph, whose bin
loss follows the epoch).  No EMA of the generator and no
rematerialisation.  fp32 only: the bf16 form of the JAX step is not ported
yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from roar_tpu_torch.training.optim import ScheduledOptimizer


@dataclasses.dataclass
class GANTrainState:
    """What a GAN run carries from step to step.  `model` is a task with
    `forward_split`, `d_loss_from_out`, `g_loss_from_out` and
    `state_modules()`, the modules a checkpoint holds by name
    (models/hifigan_model.py `HifiGanModel`, models/jets_model.py
    `JETSModel`); `generator`, where the task draws random numbers (segment
    starts, dropout masks), is saved with it."""

    model: Any
    g_opt: ScheduledOptimizer
    d_opt: ScheduledOptimizer
    step: int = 0
    generator: Optional[torch.Generator] = None

    def state_dict(self) -> Dict[str, Any]:
        state = {"step": self.step,
                 **{name: m.state_dict() for name, m in self.model.state_modules().items()},
                 "g_opt": self.g_opt.state_dict(), "d_opt": self.d_opt.state_dict()}
        if self.generator is not None:
            state["rng"] = self.generator.get_state()
        return state

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.step = int(state["step"])
        for name, m in self.model.state_modules().items():
            m.load_state_dict(state[name])
        self.g_opt.load_state_dict(state["g_opt"])
        self.d_opt.load_state_dict(state["d_opt"])
        if self.generator is not None and "rng" in state:
            self.generator.set_state(state["rng"].cpu())


def gan_train_step(state: GANTrainState, batch: Dict[str, torch.Tensor],
                   mark: Optional[Callable[[str], None]] = None, epoch: int = 0
                   ) -> Tuple[GANTrainState, Dict[str, torch.Tensor]]:
    """One D update then one G update on `batch` in epoch `epoch`; returns
    the state and the step's metrics as tensors on the batch's device
    (nothing is synchronised).  `mark(name)`, when given, is called as each
    part of the step has been enqueued ("generator_forward", "d_pass",
    "d_optimizer", "g_pass", "g_optimizer"), so that a caller can record
    device events there."""
    model = state.model
    d_params = state.d_opt.params
    mark = mark or (lambda name: None)

    out = model.forward_split(batch, epoch)
    mark("generator_forward")

    # ---- discriminator update (detached generator output) ----
    for p in d_params:
        p.requires_grad_(True)
    sg_out = {k: v.detach() for k, v in out.items()}
    d_loss, d_metrics = model.d_loss_from_out(sg_out, batch)
    state.d_opt.zero_grad()
    d_loss.backward()
    mark("d_pass")
    state.d_opt.step()
    mark("d_optimizer")

    # ---- generator update (against the updated discriminators) ----
    for p in d_params:
        p.requires_grad_(False)
    try:
        g_loss, g_metrics = model.g_loss_from_out(out, batch, epoch)
        state.g_opt.zero_grad()
        g_loss.backward()
    finally:
        for p in d_params:
            p.requires_grad_(True)
    mark("g_pass")
    state.g_opt.step()
    mark("g_optimizer")

    state.step += 1
    metrics = {"d_loss": d_loss.detach(), "g_loss": g_loss.detach()}
    metrics.update({k: v.detach() for k, v in {**d_metrics, **g_metrics}.items()})
    return state, metrics
