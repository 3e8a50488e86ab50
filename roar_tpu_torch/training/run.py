"""Config-driven training runner.

Port of roar_tpu/training/run.py: dataset constructors, the validation-set
naming, the threaded batch iterator, `train_supervised` (loss_fn-style tasks:
FastPitch, and GPT on a `CausalLMDataset`) and `train_gan` (HiFi-GAN, JETS),
with the `exp_manager` block's loggers, early stopping
(`create_early_stopping_callback`), preemption and snapshot; the profiler
window (`model.profile: {enabled, start_step, end_step}`, `ProfilerWindow`),
the validation artifacts (`exp_manager.log_artifacts`) and `run_test`.  One
card, one process: there is no mesh, and batches go to `device` as they are
read.
"""

from __future__ import annotations

import collections
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from roar_tpu_torch.data.dataset import BucketSpec, TTSDataset, VocoderDataset
from roar_tpu_torch.data.sampling import LengthBucketBatchSampler
from roar_tpu_torch.training.exp_manager import ExpManager, yaml_safe
from roar_tpu_torch.training.gan import GANTrainState, gan_train_step
from roar_tpu_torch.training.optim import build_optimizer
from roar_tpu_torch.training.trainer import Trainer, TrainState, to_device
from roar_tpu_torch.utils.logging import get_logger


def build_tts_dataset(ds_cfg: Dict[str, Any], tokenizer, device="cuda") -> TTSDataset:
    """A TTSDataset from a `train_ds.dataset` block (its `_target_` names the
    JAX package's class; the port builds its own).  `device` is where a
    missing sup-data cache entry is extracted."""
    kwargs = {k: v for k, v in ds_cfg.items() if k != "_target_"}
    kwargs["text_tokenizer"] = tokenizer
    return TTSDataset(**kwargs, device=device)


def build_vocoder_dataset(ds_cfg: Dict[str, Any]):
    """A vocoder dataset from a `train_ds.dataset` block: the `dataset_meta`
    family (`data/vocoder_dataset.py`) when the block has `dataset_meta` or
    its `_target_` names `vocoder_dataset`, its None values dropped, else the
    manifest_filepath `VocoderDataset`.  The block's `_target_` names the JAX
    package's class; the port builds its own class for that role."""
    kwargs = {k: v for k, v in ds_cfg.items() if k != "_target_"}
    if "dataset_meta" in kwargs or "vocoder_dataset" in ds_cfg.get("_target_", ""):
        from roar_tpu_torch.data.vocoder_dataset import VocoderDataset as MetaVocoderDataset

        return MetaVocoderDataset(**{k: v for k, v in kwargs.items() if v is not None})
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


class ProfilerWindow:
    """`torch.profiler` over a window of steps (roar_tpu/training/run.py:164-200):
    tracing starts after step `start_step` and stops after step `end_step`,
    steps counted on the host by a `Trainer` callback, so steps
    start_step + 1 .. end_step are traced.  CPU activity is recorded, and CUDA
    kernels on a CUDA device.  The Chrome trace goes to
    `<log_dir>/trace_steps_<first>_<last>.json`, and `summary.json` beside it
    holds the window's wall time (the device synchronised at both ends) and
    the union of its device kernel intervals."""

    def __init__(self, cfg: Optional[Dict[str, Any]], log_dir: str, device="cpu"):
        cfg = cfg or {}
        self.enabled = bool(cfg.get("enabled", False))
        self.start_step = int(cfg.get("start_step", 10))
        self.end_step = int(cfg.get("end_step", 20))
        self.log_dir = Path(log_dir)
        self.device = torch.device(device)
        self.trace_path: Optional[Path] = None
        self.summary: Optional[Dict[str, Any]] = None
        self._prof = None
        self._first, self._t0 = 0, 0.0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def on_step(self, step: int) -> None:
        if not self.enabled:
            return
        if self.start_step <= step < self.end_step and self._prof is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._sync()
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()
            self._first = step + 1
            self._t0 = time.perf_counter()
        elif step >= self.end_step and self._prof is not None:
            self._stop(step)

    def _stop(self, last: int) -> None:
        self._sync()
        wall_s = time.perf_counter() - self._t0
        self._prof.stop()
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.trace_path = self.log_dir / f"trace_steps_{self._first}_{last}.json"
        self._prof.export_chrome_trace(str(self.trace_path))
        self._prof = None
        self.summary = {"trace": str(self.trace_path), "first_step": self._first,
                        "last_step": last, "wall_ms": wall_s * 1e3,
                        **device_busy(self.trace_path)}
        self.summary["device_busy_share"] = self.summary["device_busy_ms"] / (wall_s * 1e3)
        (self.log_dir / "summary.json").write_text(json.dumps(self.summary, indent=1))
        get_logger().info(f"profiler window: steps {self._first} to {last}, "
                          f"{self.summary['wall_ms']:.1f} ms, device busy "
                          f"{self.summary['device_busy_share']:.3f}; {self.trace_path}")

    def as_callback(self):
        """A per-step `Trainer` callback (None when disabled)."""
        counter = {"step": 0}

        def cb(state, metrics):
            counter["step"] += 1
            self.on_step(counter["step"])

        return cb if self.enabled else None

    def close(self) -> None:
        if self._prof is not None:
            self._prof.stop()
            self._prof = None


def device_busy(trace_path) -> Dict[str, Any]:
    """From a Chrome trace of `torch.profiler`: the union of the device
    kernel intervals in ms, and the kernels by name with their counts."""
    events = json.loads(Path(trace_path).read_text()).get("traceEvents", [])
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("cat") == "kernel" and "ts" in e)
    busy_us, end = 0.0, float("-inf")
    for t0, t1 in spans:
        if t1 > end:
            busy_us += t1 - max(t0, end)
            end = t1
    names = collections.Counter(e["name"] for e in events if e.get("cat") == "kernel")
    return {"device_busy_ms": busy_us / 1e3, "device_kernels": dict(names)}


def _early_stopping_cfg(exp_cfg: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """`create_early_stopping_callback` + `early_stopping_callback_params`
    as EarlyStopping's keyword arguments; Lightning-only keys are dropped."""
    if not exp_cfg.get("create_early_stopping_callback", False):
        return None
    params = exp_cfg.get("early_stopping_callback_params") or {}
    keep = ("monitor", "mode", "min_delta", "patience", "check_finite", "verbose")
    return {k: params[k] for k in keep if k in params}


def _exp_manager(cfg: Dict[str, Any]) -> ExpManager:
    """The run's ExpManager from the `exp_manager` and `trainer` blocks."""
    exp_cfg = cfg.get("exp_manager", {}) or {}
    return ExpManager(
        exp_dir=exp_cfg.get("exp_dir") or "./exp",
        name=exp_cfg.get("name", cfg.get("name", "run")),
        version=exp_cfg.get("version"),
        resume_if_exists=exp_cfg.get("resume_if_exists", False),
        max_time_seconds=(cfg.get("trainer") or {}).get("max_time_seconds"),
        use_tensorboard=exp_cfg.get("create_tensorboard_logger", True),
        use_wandb=exp_cfg.get("create_wandb_logger", False),
        wandb_kwargs=exp_cfg.get("wandb_logger_kwargs"),
        use_mlflow=exp_cfg.get("create_mlflow_logger", False),
        mlflow_kwargs=exp_cfg.get("mlflow_logger_kwargs"),
        use_dllogger=exp_cfg.get("create_dllogger_logger", False),
        dllogger_kwargs=exp_cfg.get("dllogger_logger_kwargs"),
        use_clearml=exp_cfg.get("create_clearml_logger", False),
        clearml_kwargs=exp_cfg.get("clearml_logger_kwargs"),
        early_stopping=_early_stopping_cfg(exp_cfg),
        config=cfg,
    )


def _log_tts_artifacts(artifacts, model, val_dataset, epoch: int, device) -> None:
    """Synthesise the first validation utterance in eval mode, in its own
    speaker's voice where it has one, and write its artifacts; a failure is
    logged and training goes on, as in the JAX package.  (The JAX package
    passes no speaker, so a speaker-conditioned model fails there and writes
    nothing; ROADMAP N2.)"""
    module = model.module
    was_training = module.training
    try:
        item = val_dataset[0]
        text = np.asarray(item["text"])[None]
        pad_to = -(-text.shape[1] // 16) * 16
        pad_id = model.tokenizer.pad if model.tokenizer is not None else 0
        text = np.pad(text, ((0, 0), (0, pad_to - text.shape[1])), constant_values=pad_id)
        speaker = None
        if item.get("speaker_id") is not None:
            speaker = torch.tensor([int(item["speaker_id"])], device=device)
        module.eval()
        spect, lens = model.generate_spectrogram(torch.from_numpy(text).long().to(device),
                                                 speaker=speaker, max_mel_len=1024)
        artifacts(epoch, {"spect": spect[:, : int(lens[0])]}, {})
    except Exception as e:  # artifacts must never stop training
        get_logger().warning(f"artifact generation failed: {e}")
    finally:
        module.train(was_training)


def _map_precision(value) -> Optional[str]:
    if value in (16, "16", "16-mixed", "bf16", "bf16-mixed", "bfloat16"):
        return "bf16"
    return None


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
    save_to(path, yaml_safe(cfg), state.model.to_jax_tree())
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
    exp = _exp_manager(cfg)
    profiler = ProfilerWindow(model_cfg.get("profile"), str(exp.root / "profile"), device)
    try:
        prof_cb = profiler.as_callback()
        if prof_cb is not None:
            trainer.callbacks = tuple(trainer.callbacks) + (prof_cb,)
        state = trainer.init_state()
        state, _ = exp.maybe_resume(state, map_location=device)

        check_val_every = trainer_cfg.get("check_val_every_n_epoch", 1)
        val_sets, val_dl_idx = _val_sets(val_dataset, model_cfg)
        # validation artifacts: plots and a Griffin-Lim preview
        artifacts = None
        if exp_cfg.get("log_artifacts") and hasattr(model, "generate_spectrogram"):
            from roar_tpu_torch.training.callbacks import FastPitchArtifactGenerator

            artifacts = FastPitchArtifactGenerator(str(exp.root / "artifacts"),
                                                   log_every_epochs=check_val_every,
                                                   mel_cfg=getattr(model, "mel_cfg", None))
        num_workers = int(dl_cfg.get("num_workers") or 0)
        model.module.train()
        if hasattr(model, "attention_paths"):
            print(f"attention paths in training: {model.attention_paths()}", flush=True)
        metrics: Dict[str, float] = {}
        for epoch in range(max_epochs):
            sampler.set_epoch(epoch)
            batches = batch_iterator(dataset, sampler, buckets, num_workers=num_workers)
            state, metrics = trainer.run_epoch(state, batches, epoch=epoch, logger=exp.logger)
            if exp.should_stop() or trainer.reached_max_steps:
                exp.save(state, metrics)
                break
            if val_sets and (epoch + 1) % check_val_every == 0:
                val_logged: Dict[str, float] = {}
                for si, (ds_name, vds) in enumerate(val_sets):
                    val_sampler = LengthBucketBatchSampler(
                        vds.lengths, batch_size=batch_size, shuffle=False, drop_last=True)
                    val_metrics = trainer.evaluate(
                        state, batch_iterator(vds, val_sampler, buckets,
                                              num_workers=num_workers), epoch=epoch)
                    # every set logs '<name>val_*'; the val_dl_idx set is THE 'val_*'
                    if len(val_sets) > 1:
                        val_logged.update({f"{ds_name}val_{k}": v
                                           for k, v in val_metrics.items()})
                    if si == val_dl_idx:
                        val_logged.update({f"val_{k}": v for k, v in val_metrics.items()})
                exp.logger.log_metrics(val_logged, step=state.step)
                if artifacts is not None:
                    _log_tts_artifacts(artifacts, model, val_sets[val_dl_idx][1], epoch, device)
                if exp.check_early_stop(val_logged):
                    exp.save(state, metrics)
                    break
            exp.save(state, metrics)
    finally:
        profiler.close()
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

    exp = _exp_manager(cfg)
    try:
        state = _gan_loop(cfg, model, dataset, val_dataset, exp, state, sampler, buckets,
                          batch_size, max_epochs, max_steps, compute_dtype, device)
    finally:
        exp.close()
    _maybe_save_roar(cfg, exp, state)
    return state


def _gan_loop(cfg, model, dataset, val_dataset, exp: ExpManager, state: GANTrainState, sampler,
              buckets, batch_size: int, max_epochs: int, max_steps, compute_dtype, device
              ) -> GANTrainState:
    """`train_gan`'s epochs: steps, validation with early stopping,
    checkpoints."""
    trainer_cfg = cfg.get("trainer", {})
    model_cfg = cfg.get("model", {})
    dl_cfg = (model_cfg.get("train_ds") or {}).get("dataloader_params", {})
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
                exp.check_early_stop(val_logged)
            if compute_dtype is not None:
                model.set_compute_dtype(compute_dtype)
        exp.save(state, {k: float(v) for k, v in metrics.items()})
        if exp.should_stop() or reached_max_steps:
            break
    return state


def _compute_dtype(module: torch.nn.Module):
    """The `compute_dtype` the module's layers apply (None when none does)."""
    return next((m.compute_dtype for m in module.modules() if hasattr(m, "compute_dtype")), None)


def run_test(cfg: Dict[str, Any], model, test_dataset, state=None,
             buckets: Optional[BucketSpec] = None, log_dir: Optional[str] = None,
             epoch: Optional[int] = None, device="cuda") -> Dict[str, float]:
    """Evaluate a trained loss_fn task on one or several test sets
    (roar_tpu/training/run.py:650-756): the task's metrics in eval mode, fp32,
    without gradients, as sample-weighted means over batches of
    `model.test_ds.dataloader_params.batch_size` (the last batch ragged).
    `test_dataset` is one dataset, a list or a dict name -> dataset;
    `model.test_ds.test_dl_idx` names the set whose metrics are `test_*`, and
    with several sets each also logs `<name>test_*`.  `epoch` feeds the
    epoch-scheduled loss terms; by default it is the end of training: with
    `trainer.max_epochs` and `trainer.max_steps`, round(step / max_steps *
    max_epochs) capped at max_epochs; with `max_epochs` only, max_epochs; 0
    for an untrained `state` (or none).  With `log_dir`, appends one record to
    `<log_dir>/test_metrics.jsonl`."""
    device = torch.device(device)
    model_cfg = cfg.get("model", {})
    trainer_cfg = cfg.get("trainer", {})
    dl_cfg = (model_cfg.get("test_ds") or {}).get("dataloader_params", {})
    batch_size = dl_cfg.get("batch_size", 16)
    num_workers = int(dl_cfg.get("num_workers") or 0)
    if epoch is None:
        max_epochs = int(trainer_cfg.get("max_epochs") or 0)
        max_steps = int(trainer_cfg.get("max_steps") or 0)
        step_count = int(state.step) if state is not None else 0
        if max_epochs and max_steps and step_count:
            epoch = min(max_epochs, round(step_count / max_steps * max_epochs))
        elif max_epochs and step_count:
            epoch = max_epochs
        else:
            epoch = 0
    if isinstance(test_dataset, dict):
        sets = list(test_dataset.items())
    elif isinstance(test_dataset, (list, tuple)):
        sets = [(f"{i}_", d) for i, d in enumerate(test_dataset)]
    else:
        sets = [("", test_dataset)]
    idx = int((model_cfg.get("test_ds") or {}).get("test_dl_idx", 0) or 0)
    if not 0 <= idx < len(sets):
        raise ValueError(f"test_dl_idx={idx} is out of range for {len(sets)} test dataloader(s)")

    module = model.module
    was_training, dtype = module.training, _compute_dtype(module)
    module.eval()
    if dtype is not None:
        model.set_compute_dtype(None)
    out: Dict[str, float] = {}
    try:
        for si, (ds_name, ds) in enumerate(sets):
            sampler = LengthBucketBatchSampler(ds.lengths, batch_size=batch_size, shuffle=False,
                                               drop_last=False)
            totals: Dict[str, float] = {}
            n = 0
            for batch in batch_iterator(ds, sampler, buckets, num_workers=num_workers):
                # the sample-weighted mean: a ragged last batch counts by its size
                w = int(np.shape(batch[sorted(batch)[0]])[0])
                with torch.no_grad():
                    _, metrics = model.loss_fn(to_device(batch, device), epoch)
                for k, v in metrics.items():
                    totals[k] = totals.get(k, 0.0) + float(v) * w
                n += w
            if not n:
                if si == idx:
                    get_logger().warning(f"test dataloader '{ds_name or si}' (test_dl_idx={idx})"
                                         f" produced zero batches; no test_* metrics")
                continue
            if len(sets) > 1:
                out.update({f"{ds_name}test_{k}": v / n for k, v in totals.items()})
            if si == idx:
                out.update({f"test_{k}": v / n for k, v in totals.items()})
    finally:
        module.train(was_training)
        if dtype is not None:
            model.set_compute_dtype(dtype)
    if log_dir is not None:
        path = Path(log_dir)
        path.mkdir(parents=True, exist_ok=True)
        with open(path / "test_metrics.jsonl", "a", encoding="utf-8") as f:
            f.write(json.dumps({"time": time.time(), **out}) + "\n")
    return out
