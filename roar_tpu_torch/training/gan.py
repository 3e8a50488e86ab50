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

No EMA of the generator and no rematerialisation.  fp32 only: the bf16 form
of the JAX step is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from roar_tpu_torch.training.optim import ScheduledOptimizer


@dataclasses.dataclass
class GANTrainState:
    """What a GAN run carries from step to step.  `model` is a task with
    `forward_split`, `d_loss_from_out`, `g_loss_from_out`, `generator`,
    `mpd`, `msd` (models/hifigan_model.py `HifiGanModel`)."""

    model: Any
    g_opt: ScheduledOptimizer
    d_opt: ScheduledOptimizer
    step: int = 0

    def state_dict(self) -> Dict[str, Any]:
        return {
            "step": self.step,
            "generator": self.model.generator.state_dict(),
            "mpd": self.model.mpd.state_dict(),
            "msd": self.model.msd.state_dict(),
            "g_opt": self.g_opt.state_dict(),
            "d_opt": self.d_opt.state_dict(),
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.step = int(state["step"])
        self.model.generator.load_state_dict(state["generator"])
        self.model.mpd.load_state_dict(state["mpd"])
        self.model.msd.load_state_dict(state["msd"])
        self.g_opt.load_state_dict(state["g_opt"])
        self.d_opt.load_state_dict(state["d_opt"])


def gan_train_step(state: GANTrainState, batch: Dict[str, torch.Tensor],
                   mark: Optional[Callable[[str], None]] = None
                   ) -> Tuple[GANTrainState, Dict[str, torch.Tensor]]:
    """One D update then one G update on `batch`; returns the state and the
    step's metrics as tensors on the batch's device (nothing is synchronised).
    `mark(name)`, when given, is called as each part of the step has been
    enqueued ("generator_forward", "d_pass", "d_optimizer", "g_pass",
    "g_optimizer"), so that a caller can record device events there."""
    model = state.model
    d_params = state.d_opt.params
    mark = mark or (lambda name: None)

    diff_out = model.forward_split(batch)
    mark("generator_forward")

    # ---- discriminator update (detached generator output) ----
    for p in d_params:
        p.requires_grad_(True)
    sg_out = {k: v.detach() for k, v in diff_out.items()}
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
        g_loss, g_metrics = model.g_loss_from_out(diff_out, batch)
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
