"""Training engine for loss_fn-style tasks: the supervised step and epoch loop.

Port of roar_tpu/training/trainer.py:128-393 to eager PyTorch on one device.
A task is an object with `module` (an `nn.Module` holding every parameter),
`loss_fn(batch, epoch, mark=None) -> (loss, metrics)` and
`set_dropout_generator(generator)` (every random draw of a training-mode
forward); `models/fastpitch_model.py::FastPitchModel`
and `models/gpt_model.py::GPTLMModel` are two.  One step: forward in training
mode, backward, `grad_norm` of this batch's gradients, then (every
`accumulate_grad_batches` steps, on the mean of the gradients since the last
update, as `optax.MultiSteps` does) the global-norm clip and the optimizer
update of `optim.ScheduledOptimizer`.  Metrics stay tensors on the device: the
host waits for the device only where it logs.

`precision="bf16"` is what roar_tpu/training/trainer.py:152-174 does: the
parameters and the optimizer state stay fp32, forward and backward run on a
bf16 cast of the parameters and of the batch's floating tensors, and the
gradients come back in fp32.  A task takes it by declaring
`set_compute_dtype(dtype)` (`GPTLMModel` and `FastPitchModel` do); for any
other task it raises `NotImplementedError`.

Not ported: `freeze_updates` (dynamic freezing), tensor-parallel rules and the
device mesh; each raises `NotImplementedError`.  There is no EMA of the
parameters.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from roar_tpu_torch.training.optim import ScheduledOptimizer, global_norm


def to_device(batch: Dict[str, Any], device: torch.device,
              float_dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """A collated numpy batch as tensors on `device`; with `float_dtype`, its
    floating tensors in that type."""
    out = {k: torch.from_numpy(np.asarray(v)).to(device, non_blocking=True)
           for k, v in batch.items() if not isinstance(v, (str, list, tuple))}
    if float_dtype is not None:
        out = {k: v.to(float_dtype) if v.is_floating_point() else v for k, v in out.items()}
    return out


@dataclasses.dataclass
class TrainState:
    """What a supervised run carries from step to step.  `step` counts
    batches (micro-batches under gradient accumulation), as the JAX
    package's TrainState does; `dropout_generator` draws the dropout masks."""

    model: Any
    opt: ScheduledOptimizer
    step: int = 0
    dropout_generator: Optional[torch.Generator] = None

    def state_dict(self) -> Dict[str, Any]:
        state = {"step": self.step, "module": self.model.module.state_dict(),
                 "opt": self.opt.state_dict()}
        if self.dropout_generator is not None:
            state["dropout_rng"] = self.dropout_generator.get_state()
        return state

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.step = int(state["step"])
        self.model.module.load_state_dict(state["module"])
        self.opt.load_state_dict(state["opt"])
        if self.dropout_generator is not None and "dropout_rng" in state:
            self.dropout_generator.set_state(state["dropout_rng"].cpu())


def train_step(state: TrainState, batch: Dict[str, torch.Tensor], epoch: int = 0,
               accumulate_grad_batches: int = 1,
               mark: Optional[Callable[[str], None]] = None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One supervised step on `batch` (tensors on the module's device);
    returns the state and the step's metrics as tensors (nothing is
    synchronised).  `mark(name)` is a profiling hook and nothing else: when
    given, it is called as each part has been enqueued (the task's own marks,
    then "backward" and "optimizer"), so a timer can record an event there."""
    model, opt = state.model, state.opt
    mark = mark or (lambda name: None)
    model.module.train()
    loss, metrics = model.loss_fn(batch, epoch, mark=mark)
    params = opt.params
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    # a parameter the loss does not reach has a zero gradient, as in JAX
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    mark("backward")
    metrics["grad_norm"] = global_norm(grads)

    k = max(int(accumulate_grad_batches), 1)
    first_of_group = state.step % k == 0
    for p, g in zip(params, grads):
        if k > 1:
            g = g / k
        p.grad = g if first_of_group else p.grad + g
    state.step += 1
    if state.step % k == 0:
        # without accumulation the `.grad`s are this batch's gradients: the
        # clip reuses their norm
        opt.step(grad_norm=metrics["grad_norm"] if k == 1 else None)
    mark("optimizer")
    return state, metrics


@dataclasses.dataclass
class Trainer:
    """Epoch and step loop over numpy batches for one task on one device."""

    model: Any
    optimizer: ScheduledOptimizer
    device: Any = "cuda"
    seed: int = 0
    log_every: int = 50
    precision: Optional[str] = None
    accumulate_grad_batches: int = 1
    # training halts once the step count reaches it, even mid-epoch; counted
    # on the host
    max_steps: Optional[int] = None
    freeze_updates: Optional[Dict[str, Any]] = None
    tp_rules: Optional[Any] = None
    mesh: Optional[Any] = None

    def __post_init__(self):
        self.compute_dtype = None
        if self.precision in ("bf16", "bfloat16", "bf16-mixed"):
            if not hasattr(self.model, "set_compute_dtype"):
                raise NotImplementedError(
                    f"precision=bf16 (bf16 compute with fp32 master weights) is not ported for "
                    f"{type(self.model).__name__}; train in fp32")
            self.compute_dtype = torch.bfloat16
        if self.freeze_updates and self.freeze_updates.get("enabled", False):
            raise NotImplementedError("freeze_updates (dynamic freezing) is not ported yet")
        if self.tp_rules is not None or self.mesh is not None:
            raise NotImplementedError("tensor-parallel rules and device meshes are not ported: "
                                      "the port trains on one device")
        self.device = torch.device(self.device)
        self.reached_max_steps = False

    def init_state(self) -> TrainState:
        """Move the task to the device and start the dropout generator there."""
        self.model.module.to(self.device)
        if self.compute_dtype is not None:
            self.model.set_compute_dtype(self.compute_dtype)
        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self.model.set_dropout_generator(generator)
        return TrainState(model=self.model, opt=self.optimizer, dropout_generator=generator)

    def run_epoch(self, state: TrainState, batches: Iterable[Dict[str, np.ndarray]],
                  epoch: int = 0, logger=None) -> Tuple[TrainState, Dict[str, float]]:
        last_metrics: Dict[str, torch.Tensor] = {}
        t0 = time.perf_counter()
        for i, batch in enumerate(batches):
            lr = state.opt.current_lr()
            state, metrics = train_step(
                state, to_device(batch, self.device, self.compute_dtype), epoch,
                self.accumulate_grad_batches)
            if logger is not None and i % self.log_every == 0:
                host = {k: float(v) for k, v in metrics.items()}  # the one sync
                host["lr"] = lr
                host["train_step_timing"] = (time.perf_counter() - t0) / (i + 1)
                logger.log_metrics(host, step=state.step)
            last_metrics = metrics
            if self.max_steps is not None and state.step >= self.max_steps:
                self.reached_max_steps = True
                break
        return state, {k: float(v) for k, v in last_metrics.items()}

    @torch.no_grad()
    def evaluate(self, state: TrainState, batches: Iterable[Dict[str, np.ndarray]],
                 epoch: int = 0) -> Dict[str, float]:
        """The task's metrics averaged over `batches`, in eval mode and
        without gradients; one sync at the end.  Under bf16 the forward runs
        in fp32 from the masters on the uncast batch, as the JAX trainer
        validates; the compute dtype is restored after."""
        module = state.model.module
        was_training = module.training
        module.eval()
        if self.compute_dtype is not None:
            state.model.set_compute_dtype(None)
        totals: Dict[str, torch.Tensor] = {}
        n = 0
        try:
            for batch in batches:
                _, metrics = state.model.loss_fn(to_device(batch, self.device), epoch)
                for k, v in metrics.items():
                    totals[k] = totals[k] + v if k in totals else v
                n += 1
        finally:
            module.train(was_training)
            if self.compute_dtype is not None:
                state.model.set_compute_dtype(self.compute_dtype)
        return {k: float(v) / max(n, 1) for k, v in totals.items()}
