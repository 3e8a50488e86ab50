"""Config-driven training runner.

Port of roar_tpu/training/run.py: dataset constructors, the validation-set
naming, the threaded batch iterator, `train_supervised` (loss_fn-style tasks:
FastPitch, and GPT on a `CausalLMDataset`) and `train_gan` (HiFi-GAN, JETS).  One card, one process: there is no
mesh, and batches go to `device` as they are read.  `run_test`, the profiler
window, validation artifacts and early stopping are not ported yet.
"""

from __future__ import annotations

import collections
import os
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from roar_tpu_torch.data.dataset import BucketSpec, TTSDataset, VocoderDataset
from roar_tpu_torch.data.sampling import LengthBucketBatchSampler
from roar_tpu_torch.training.exp_manager import ExpManager
from roar_tpu_torch.training.gan import GANTrainState, gan_train_step
from roar_tpu_torch.training.optim import build_optimizer
from roar_tpu_torch.training.trainer import Trainer, TrainState, to_device


def build_tts_dataset(ds_cfg: Dict[str, Any], tokenizer, device="cuda") -> TTSDataset:
    """A TTSDataset from a `train_ds.dataset` block (its `_target_` names the
    JAX package's class; the port builds its own).  `device` is where a
    missing sup-data cache entry is extracted."""
    kwargs = {k: v for k, v in ds_cfg.items() if k != "_target_"}
    kwargs["text_tokenizer"] = tokenizer
    return TTSDataset(**kwargs, device=device)


def build_vocoder_dataset(ds_cfg: Dict[str, Any]) -> VocoderDataset:
    """A VocoderDataset from a `train_ds.dataset` block.  The block's
    `_target_` names the JAX package's class; the port builds its own class
    for that role.  The `dataset_meta` family is not ported."""
    kwargs = {k: v for k, v in ds_cfg.items() if k != "_target_"}
    if "dataset_meta" in kwargs or "vocoder_dataset" in ds_cfg.get("_target_", ""):
        raise NotImplementedError(
            "the dataset_meta vocoder dataset (roar_tpu/data/vocoder_dataset.py) is not "
            "ported yet; use a manifest_filepath VocoderDataset")
    return VocoderDataset(**kwargs)


def parse_dataset_as_name(name) -> str:
    """Metric-prefix name of a validation manifest: file stem, dashes to
    underscores, 'manifest' and 'dataset' stripped, trailing '_'."""
    s = str(name)
    if os.path.exists(s):
        s = Path(s).stem
    s = s.replace("-", "_").replace("manifest", "").replace("dataset", "")
    if not s:
        raise ValueError("manifest filename reduces to an empty dataloader name; pick a "
                         "more descriptive filename")
    if not s.endswith("_"):
        s += "_"
    return s


def build_validation_datasets(ds_cfg: Dict[str, Any], make_dataset):
    """One dataset, or for a list (or comma-joined string) of manifests a
    dict name -> dataset, named by `parse_dataset_as_name`."""
    paths = ds_cfg.get("manifest_filepath")
    if isinstance(paths, str) and "," in paths:
        paths = [p.strip() for p in paths.split(",")]
    if not isinstance(paths, (list, tuple)) or len(paths) <= 1:
        return make_dataset(ds_cfg)
    sets = {}
    for p in paths:
        name = parse_dataset_as_name(p)
        if name in sets:
            raise ValueError(f"validation manifests produce duplicate dataloader name '{name}'")
        sets[name] = make_dataset({**ds_cfg, "manifest_filepath": p})
    return sets


def _val_sets(val_dataset, model_cfg: Dict[str, Any]):
    """[(name, dataset)] and the index whose metrics log unprefixed."""
    if val_dataset is None:
        return [], 0
    if isinstance(val_dataset, dict):
        sets = list(val_dataset.items())
    elif isinstance(val_dataset, (list, tuple)):
        sets = [(f"{i}_", d) for i, d in enumerate(val_dataset)]
    else:
        sets = [("", val_dataset)]
    idx = int((model_cfg.get("validation_ds") or {}).get("val_dl_idx", 0) or 0)
    if not 0 <= idx < len(sets):
        raise ValueError(f"val_dl_idx={idx} is out of range for {len(sets)} validation "
                         f"dataloader(s)")
    return sets, idx


def batch_iterator(dataset, sampler, buckets: Optional[BucketSpec] = None, num_workers: int = 0,
                   prefetch_factor: int = 2):
    """Collated batches in sampler order, padded to `buckets` where given.
    With `num_workers` > 0, loading and collation run in a thread pool with a
    bounded in-order window of batches in flight, so the host's audio decode
    overlaps the device step."""

    def load(idxs):
        items = [dataset[i] for i in idxs]
        return dataset.collate(items, buckets)

    if num_workers <= 0:
        for idxs in sampler:
            yield load(idxs)
        return

    window = max(2, num_workers * max(prefetch_factor, 1))
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        pending = collections.deque()
        try:
            for idxs in sampler:
                pending.append(pool.submit(load, idxs))
                if len(pending) >= window:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()
        finally:
            for f in pending:
                f.cancel()


def _map_precision(value) -> Optional[str]:
    if value in (16, "16", "16-mixed", "bf16", "bf16-mixed", "bfloat16"):
        return "bf16"
    return None


def _yaml_safe(obj):
    if isinstance(obj, dict):
        return {k: _yaml_safe(v) for k, v in obj.items() if not callable(v)}
    if isinstance(obj, (list, tuple)):
        return [_yaml_safe(v) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return str(obj)


def _maybe_save_roar(cfg, exp: ExpManager, state) -> Optional[str]:
    """End-of-training `.roar` bundle in the JAX package's layouts, when
    `exp_manager.always_save_roar` (or
    `exp_manager.checkpoint_callback_params.always_save_roar`) is set: the
    task's own `to_jax_tree()` (the parameter tree, or for a GAN
    `{'g_params', 'd_params', 'd_stats'}`)."""
    exp_cfg = cfg.get("exp_manager") or {}
    ccp = exp_cfg.get("checkpoint_callback_params") or {}
    if not (exp_cfg.get("always_save_roar") or ccp.get("always_save_roar")):
        return None
    from roar_tpu_torch.training.save_restore import save_to

    name = exp_cfg.get("name") or cfg.get("name") or "model"
    path = str(exp.ckpt_dir / f"{name}.roar")
    save_to(path, _yaml_safe(cfg), state.model.to_jax_tree())
    print(f"saved end-of-training bundle: {path}", flush=True)
    return path


def _first_batch_indices(sampler, dataset, batch_size):
    batches = list(iter(sampler))
    if not batches:
        raise ValueError(
            f"training sampler produced 0 batches: dataset has {len(dataset)} usable items "
            f"after duration/manifest filtering but batch_size={batch_size} with drop_last "
            f"needs at least one full batch. Lower batch_size, add data, or relax "
            f"min/max_duration.")
    return batches[0]


def train_supervised(cfg: Dict[str, Any], model, dataset, val_dataset=None,
                     max_epochs: Optional[int] = None, buckets: Optional[BucketSpec] = None,
                     device="cuda") -> TrainState:
    """Train a loss_fn-style task (`FastPitchModel`, `GPTLMModel`) on `device`
    ("cuda" unless the caller asks for "cpu").  The host waits for the device
    only where it logs, validates or saves."""
    device = torch.device(device)
    trainer_cfg = cfg.get("trainer", {})
    exp_cfg = cfg.get("exp_manager", {}) or {}
    model_cfg = cfg.get("model", {})
    dl_cfg = (model_cfg.get("train_ds") or {}).get("dataloader_params", {})
    batch_size = dl_cfg.get("batch_size", 16)
    max_epochs = max_epochs or trainer_cfg.get("max_epochs", 1)
    if int(trainer_cfg.get("model_parallel_size", 1) or 1) > 1:
        raise NotImplementedError("model_parallel_size > 1 is not ported: one device")

    sampler = LengthBucketBatchSampler(
        dataset.lengths, batch_size=batch_size, shuffle=dl_cfg.get("shuffle", True),
        drop_last=True, seed=trainer_cfg.get("seed", 0))
    _first_batch_indices(sampler, dataset, batch_size)
    steps_per_epoch = max(len(sampler), 1)
    optimizer = build_optimizer(
        model.parameters(), model_cfg.get("optim", {}), steps_per_epoch=steps_per_epoch,
        max_epochs=max_epochs,
        max_steps=model_cfg.get("max_steps") or trainer_cfg.get("max_steps"),
        gradient_clip_val=trainer_cfg.get("gradient_clip_val"))
    trainer = Trainer(
        model=model, optimizer=optimizer, device=device, seed=trainer_cfg.get("seed", 0),
        log_every=trainer_cfg.get("log_every_n_steps", 100),
        precision=_map_precision(trainer_cfg.get("precision")),
        accumulate_grad_batches=int(trainer_cfg.get("accumulate_grad_batches", 1) or 1),
        # trainer.max_steps stops the run; model.max_steps is the schedule's horizon
        max_steps=trainer_cfg.get("max_steps") or model_cfg.get("max_steps"),
        freeze_updates=model_cfg.get("freeze_updates"))
    exp = ExpManager(
        exp_dir=exp_cfg.get("exp_dir") or "./exp",
        name=exp_cfg.get("name", cfg.get("name", "run")),
        version=exp_cfg.get("version"),
        resume_if_exists=exp_cfg.get("resume_if_exists", False),
        max_time_seconds=trainer_cfg.get("max_time_seconds"),
    )
    state = trainer.init_state()
    state, _ = exp.maybe_resume(state, map_location=device)

    check_val_every = trainer_cfg.get("check_val_every_n_epoch", 1)
    val_sets, val_dl_idx = _val_sets(val_dataset, model_cfg)
    num_workers = int(dl_cfg.get("num_workers") or 0)
    model.module.train()
    if hasattr(model, "attention_paths"):
        print(f"attention paths in training: {model.attention_paths()}", flush=True)
    metrics: Dict[str, float] = {}
    for epoch in range(max_epochs):
        sampler.set_epoch(epoch)
        batches = batch_iterator(dataset, sampler, buckets, num_workers=num_workers)
        state, metrics = trainer.run_epoch(state, batches, epoch=epoch, logger=exp.logger)
        stop = exp.should_stop() or trainer.reached_max_steps
        if not stop and val_sets and (epoch + 1) % check_val_every == 0:
            val_logged: Dict[str, float] = {}
            for si, (ds_name, vds) in enumerate(val_sets):
                val_sampler = LengthBucketBatchSampler(
                    vds.lengths, batch_size=batch_size, shuffle=False, drop_last=True)
                val_metrics = trainer.evaluate(
                    state, batch_iterator(vds, val_sampler, buckets, num_workers=num_workers),
                    epoch=epoch)
                # every set logs '<name>val_*'; the val_dl_idx set is THE 'val_*'
                if len(val_sets) > 1:
                    val_logged.update({f"{ds_name}val_{k}": v for k, v in val_metrics.items()})
                if si == val_dl_idx:
                    val_logged.update({f"val_{k}": v for k, v in val_metrics.items()})
            exp.logger.log_metrics(val_logged, step=state.step)
        exp.save(state, metrics)
        if stop:
            break
    exp.close()
    _maybe_save_roar(cfg, exp, state)
    return state


def train_gan(cfg: Dict[str, Any], model, dataset, val_dataset=None,
              max_epochs: Optional[int] = None, buckets: Optional[BucketSpec] = None,
              device="cuda") -> GANTrainState:
    """Train a GAN task (`HifiGanModel`, `JETSModel`) on `device` ("cuda"
    unless the caller asks for "cpu"), batches padded to `buckets` where
    given.  A task that draws random numbers (`set_dropout_generator`: JETS's
    dropout and segment starts) draws them from one generator on `device`
    seeded with `trainer.seed`, saved with the checkpoints.  The host waits
    for the device only where it logs.  `trainer.precision` bf16 / bf16-mixed
    trains through the task's `set_compute_dtype` (a task without it raises)
    and validates in fp32, as the JAX runner does."""
    device = torch.device(device)
    trainer_cfg = cfg.get("trainer", {})
    exp_cfg = cfg.get("exp_manager", {}) or {}
    model_cfg = cfg.get("model", {})
    dl_cfg = (model_cfg.get("train_ds") or {}).get("dataloader_params", {})
    batch_size = dl_cfg.get("batch_size", 16)
    max_epochs = max_epochs or trainer_cfg.get("max_epochs", 1)
    compute_dtype = None
    if _map_precision(trainer_cfg.get("precision")) == "bf16":
        if not hasattr(model, "set_compute_dtype"):
            raise NotImplementedError(
                f"trainer.precision={trainer_cfg.get('precision')!r}: the bf16 GAN step is not "
                f"ported for {type(model).__name__}; train in fp32")
        compute_dtype = torch.bfloat16

    sampler = LengthBucketBatchSampler(
        dataset.lengths, batch_size=batch_size, shuffle=dl_cfg.get("shuffle", True),
        drop_last=True, seed=trainer_cfg.get("seed", 0))
    steps_per_epoch = max(len(sampler), 1)
    optim_cfg = dict(model_cfg.get("optim", {}))
    max_steps = model_cfg.get("max_steps") or trainer_cfg.get("max_steps")
    # the JAX runner reads its first batch to initialise the parameters;
    # reading it here too keeps the dataset's crop sequence the same
    first = _first_batch_indices(sampler, dataset, batch_size)
    dataset.collate([dataset[i] for i in first], buckets)

    model.to(device)
    if compute_dtype is not None:
        model.set_compute_dtype(compute_dtype)
    generator = None
    if hasattr(model, "set_dropout_generator"):
        generator = torch.Generator(device=device).manual_seed(trainer_cfg.get("seed", 0))
        model.set_dropout_generator(generator)
    if hasattr(model, "attention_paths"):
        print(f"attention paths in training: {model.attention_paths()}", flush=True)
    opt_kwargs = dict(steps_per_epoch=steps_per_epoch, max_epochs=max_epochs, max_steps=max_steps,
                      gradient_clip_val=trainer_cfg.get("gradient_clip_val"))
    state = GANTrainState(
        model=model,
        g_opt=build_optimizer(model.g_parameters(), optim_cfg, **opt_kwargs),
        d_opt=build_optimizer(model.d_parameters(), optim_cfg, **opt_kwargs),
        generator=generator)

    exp = ExpManager(
        exp_dir=exp_cfg.get("exp_dir") or "./exp",
        name=exp_cfg.get("name", cfg.get("name", "run")),
        version=exp_cfg.get("version"),
        resume_if_exists=exp_cfg.get("resume_if_exists", False),
        max_time_seconds=trainer_cfg.get("max_time_seconds"),
    )
    state, start_step = exp.maybe_resume(state, map_location=device)

    log_every = trainer_cfg.get("log_every_n_steps", 100)
    check_val_every = trainer_cfg.get("check_val_every_n_epoch", 1)
    val_sets, val_dl_idx = _val_sets(val_dataset, model_cfg)

    # trainer.max_steps stops the run; model.max_steps is the schedule's horizon
    stop_steps = trainer_cfg.get("max_steps") or max_steps
    gstep = int(start_step or 0)
    reached_max_steps = False
    num_workers = int(dl_cfg.get("num_workers") or 0)
    for epoch in range(max_epochs):
        sampler.set_epoch(epoch)
        t0 = time.perf_counter()
        metrics: Dict[str, torch.Tensor] = {}
        for i, batch in enumerate(batch_iterator(dataset, sampler, buckets,
                                                 num_workers=num_workers)):
            lr = state.g_opt.current_lr()
            state, metrics = gan_train_step(state, to_device(batch, device), epoch=epoch)
            gstep += 1
            if i % log_every == 0:
                host = {k: float(v) for k, v in metrics.items()}  # the one sync
                host["lr"] = lr
                host["train_step_timing"] = (time.perf_counter() - t0) / (i + 1)
                exp.logger.log_metrics(host, step=state.step)
            if stop_steps is not None and gstep >= stop_steps:
                reached_max_steps = True
                break
            if exp.should_stop():
                break
        # validation: the generator's losses without updates, in fp32 from the
        # masters and the uncast batch, as the JAX runner validates
        if val_sets and (epoch + 1) % check_val_every == 0 and not exp.should_stop():
            if compute_dtype is not None:
                model.set_compute_dtype(None)
            val_logged: Dict[str, float] = {}
            for si, (ds_name, vds) in enumerate(val_sets):
                val_sampler = LengthBucketBatchSampler(
                    vds.lengths, batch_size=batch_size, shuffle=False, drop_last=True)
                totals: Dict[str, float] = {}
                n = 0
                for batch in batch_iterator(vds, val_sampler, buckets, num_workers=num_workers):
                    with torch.no_grad():
                        _, vmetrics = model.g_loss_fn(to_device(batch, device), epoch)
                    for k, v in vmetrics.items():
                        totals[k] = totals.get(k, 0.0) + float(v)
                    n += 1
                if not n:
                    if si == val_dl_idx:
                        print(f"warning: validation dataloader '{ds_name or si}' produced zero "
                              f"full batches; no val_* metrics this epoch", flush=True)
                    continue
                if len(val_sets) > 1:
                    val_logged.update({f"{ds_name}val_{k}": v / n for k, v in totals.items()})
                if si == val_dl_idx:
                    val_logged.update({f"val_{k}": v / n for k, v in totals.items()})
            if val_logged:
                exp.logger.log_metrics(val_logged, step=state.step)
            if compute_dtype is not None:
                model.set_compute_dtype(compute_dtype)
        exp.save(state, {k: float(v) for k, v in metrics.items()})
        if exp.should_stop() or reached_max_steps:
            break
    exp.close()
    _maybe_save_roar(cfg, exp, state)
    return state
