"""Experiment directory, loggers, checkpoints, resume, early stopping,
preemption and the run snapshot.

Port of roar_tpu/training/exp_manager.py:
- the run directory `<exp_dir>/<name>[/<version>]`;
- `MetricsLogger`: JSON lines in `metrics.jsonl` always (and printed), and
  TensorBoard (`torch.utils.tensorboard`), W&B, MLflow, DLLogger and ClearML
  each when asked for; a backend whose package does not import is a no-op,
  as in the JAX package;
- `EarlyStopping` on a validation metric, fed by `check_early_stop`;
- `PreemptionHandler`: SIGTERM sets a flag that `should_stop` reads.  It is
  installed when the manager is made and put back in `close()`, which the
  runners call on their error path too; installing it off the main thread
  raises (`signal.signal` works only there);
- the snapshot of the run: `cmd-args.log`, `git-info.log` (best effort),
  `config.yaml` and a `log_process-<rank>.txt` handler on the port's logger,
  removed in `close()`;
- `save` / `maybe_resume` of a training state (anything with
  `state_dict()`, `load_state_dict()` and `step`) through `torch.save`, and
  the `max_time_seconds` limit.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from roar_tpu_torch.utils.logging import get_logger, process_index


class MetricsLogger:
    """Appends `{"step": n, "time": t, ...metrics}` lines to
    `<root>/metrics.jsonl` (printing them when `echo`), and fans the same
    scalars out to the backends asked for."""

    def __init__(self, root: Path, echo: bool = True, use_tensorboard: bool = False,
                 use_wandb: bool = False, wandb_kwargs: Optional[Dict] = None,
                 use_mlflow: bool = False, mlflow_kwargs: Optional[Dict] = None,
                 use_dllogger: bool = False, dllogger_kwargs: Optional[Dict] = None,
                 use_clearml: bool = False, clearml_kwargs: Optional[Dict] = None):
        self.root = Path(root)
        self.path = self.root / "metrics.jsonl"
        self.echo = echo
        self._file = open(self.path, "a", encoding="utf-8")
        self._tb = self._wandb = self._mlflow = self._dllogger = self._clearml = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(str(self.root / "tb"))
            except Exception:
                self._tb = None
        if use_wandb:
            try:
                import wandb

                kw = dict(wandb_kwargs or {})
                kw.setdefault("dir", str(self.root))
                self._wandb = wandb.init(**kw)
            except Exception:
                self._wandb = None
        if use_mlflow:
            try:
                import mlflow

                kw = dict(mlflow_kwargs or {})
                if kw.get("tracking_uri"):
                    mlflow.set_tracking_uri(kw["tracking_uri"])
                if kw.get("experiment_name"):
                    mlflow.set_experiment(kw["experiment_name"])
                mlflow.start_run(run_name=kw.get("run_name"))
                self._mlflow = mlflow
            except Exception:
                self._mlflow = None
        if use_dllogger:
            try:
                import dllogger
                from dllogger import JSONStreamBackend, Verbosity

                kw = dict(dllogger_kwargs or {})
                path = kw.get("json_file", str(self.root / "dllogger.json"))
                dllogger.init(backends=[JSONStreamBackend(Verbosity.DEFAULT, path)])
                self._dllogger = dllogger
            except Exception:
                self._dllogger = None
        if use_clearml:
            try:
                from clearml import Task

                kw = dict(clearml_kwargs or {})
                self._clearml = Task.init(project_name=kw.get("project_name", "roar_tpu"),
                                          task_name=kw.get("task_name", "run")).get_logger()
            except Exception:
                self._clearml = None

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        values = {k: float(v) for k, v in metrics.items()}
        record = {"step": int(step), "time": time.time(), **values}
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()
        if self.echo:
            shown = " ".join(f"{k}={v:.5g}" for k, v in values.items())
            print(f"step {int(step)}: {shown}", flush=True)
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(k, v, int(step))
        if self._wandb is not None:
            self._wandb.log(values, step=int(step))
        if self._mlflow is not None:
            self._mlflow.log_metrics(values, step=int(step))
        if self._dllogger is not None:
            self._dllogger.log(step=int(step), data=values)
        if self._clearml is not None:
            for k, v in values.items():
                self._clearml.report_scalar(k, k, v, int(step))

    def close(self) -> None:
        self._file.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
        if self._mlflow is not None:
            self._mlflow.end_run()
        if self._dllogger is not None:
            self._dllogger.flush()


@dataclasses.dataclass
class EarlyStopping:
    """Stop when a monitored validation metric stops improving: `min` or
    `max` mode, an improvement must beat the best by `min_delta`, `patience`
    counts validation rounds without one, and a non-finite value stops at
    once when `check_finite`."""

    monitor: str = "val_loss"
    mode: str = "min"
    min_delta: float = 0.001
    patience: int = 10
    check_finite: bool = True
    verbose: bool = True

    def __post_init__(self):
        if self.mode not in ("min", "max"):
            raise ValueError(f"EarlyStopping mode must be min|max, got {self.mode!r}")
        self.best: Optional[float] = None
        self.wait = 0
        self.stopped = False

    def update(self, metrics: Dict[str, float]) -> bool:
        """Feed one validation round's metrics; returns True to stop."""
        if self.monitor not in metrics:
            return self.stopped
        value = float(metrics[self.monitor])
        if self.check_finite and not math.isfinite(value):
            self.stopped = True
        else:
            improved = self.best is None or (
                value < self.best - self.min_delta if self.mode == "min"
                else value > self.best + self.min_delta)
            if improved:
                self.best = value
                self.wait = 0
            else:
                self.wait += 1
                if self.wait >= self.patience:
                    self.stopped = True
        if self.stopped and self.verbose:
            get_logger().info(f"Early stopping: {self.monitor}={value:.6g} "
                              f"(best {self.best}, patience {self.wait}/{self.patience})")
        return self.stopped


class PreemptionHandler:
    """SIGTERM sets `should_stop`; `uninstall` puts the previous handler
    back."""

    def __init__(self):
        self.should_stop = False
        self._orig: Dict[int, Any] = {}

    def install(self) -> "PreemptionHandler":
        if threading.current_thread() is not threading.main_thread():
            raise RuntimeError(
                "PreemptionHandler.install must run on the main thread (signal.signal "
                "works only there); make the ExpManager on the main thread")
        for sig in (signal.SIGTERM,):
            self._orig[sig] = signal.signal(sig, self._handler)
        return self

    def _handler(self, signum, frame):
        self.should_stop = True

    def uninstall(self) -> None:
        for sig, handler in self._orig.items():
            signal.signal(sig, handler)
        self._orig.clear()


class ExpManager:
    def __init__(self, exp_dir: str, name: str = "default", version: Optional[str] = None,
                 resume_if_exists: bool = False, max_to_keep: int = 3,
                 max_time_seconds: Optional[float] = None, echo: bool = True,
                 use_tensorboard: bool = True, use_wandb: bool = False,
                 wandb_kwargs: Optional[Dict] = None, use_mlflow: bool = False,
                 mlflow_kwargs: Optional[Dict] = None, use_dllogger: bool = False,
                 dllogger_kwargs: Optional[Dict] = None, use_clearml: bool = False,
                 clearml_kwargs: Optional[Dict] = None,
                 early_stopping: Optional[Dict] = None, config: Optional[Dict] = None,
                 log_local: bool = True):
        self.root = Path(exp_dir) / name
        if version:
            self.root = self.root / version
        self.root.mkdir(parents=True, exist_ok=True)
        self.ckpt_dir = self.root / "checkpoints"
        self.ckpt_dir.mkdir(exist_ok=True)
        self.resume_if_exists = resume_if_exists
        self.max_to_keep = max_to_keep
        self.max_time_seconds = max_time_seconds
        self.config = config
        self.preemption = PreemptionHandler().install()
        self._log_handler = None
        self.logger = None
        try:
            self._snapshot_environment(log_local)
            self.logger = MetricsLogger(
                self.root, echo=echo, use_tensorboard=use_tensorboard, use_wandb=use_wandb,
                wandb_kwargs=wandb_kwargs, use_mlflow=use_mlflow, mlflow_kwargs=mlflow_kwargs,
                use_dllogger=use_dllogger, dllogger_kwargs=dllogger_kwargs,
                use_clearml=use_clearml, clearml_kwargs=clearml_kwargs)
            self.early_stopper = (EarlyStopping(**early_stopping)
                                  if early_stopping is not None else None)
        except BaseException:
            self.close()
            raise
        self._start_time = time.monotonic()

    # -- provenance ------------------------------------------------------
    def _snapshot_environment(self, log_local: bool) -> None:
        """`cmd-args.log` (the command line), `git-info.log` (HEAD and the
        working diff, when inside a repository), `config.yaml` (the run's
        config, when given), written by process 0; and a per-process log file
        that receives the port's logger records."""
        if process_index() == 0:
            try:
                (self.root / "cmd-args.log").write_text(" ".join(sys.argv) + "\n")
            except Exception:
                pass
            try:
                head = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True,
                                      text=True, timeout=10)
                if head.returncode == 0:
                    diff = subprocess.run(["git", "diff"], capture_output=True, text=True,
                                          timeout=10)
                    (self.root / "git-info.log").write_text(
                        f"commit: {head.stdout.strip()}\n\n{diff.stdout}")
            except Exception:
                pass
            if self.config is not None:
                try:
                    import yaml

                    (self.root / "config.yaml").write_text(
                        yaml.safe_dump(yaml_safe(self.config), sort_keys=False))
                except Exception:
                    pass
        if log_local:
            try:
                handler = logging.FileHandler(self.root / f"log_process-{process_index()}.txt")
                handler.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
                get_logger().addHandler(handler)
                self._log_handler = handler
            except Exception:
                self._log_handler = None

    # -- checkpoints -----------------------------------------------------
    def _checkpoints(self):
        found = [(int(p.stem.split("_")[1]), p) for p in self.ckpt_dir.glob("step_*.pt")]
        return sorted(found)

    def save(self, state, metrics: Optional[Dict[str, float]] = None) -> Path:
        """Write `checkpoints/step_<n>.pt` and drop all but the newest `max_to_keep`."""
        path = self.ckpt_dir / f"step_{int(state.step)}.pt"
        tmp = path.with_suffix(".tmp")
        torch.save({"state": state.state_dict(),
                    "metrics": {k: float(v) for k, v in (metrics or {}).items()}}, tmp)
        tmp.replace(path)
        for _, old in self._checkpoints()[: -self.max_to_keep]:
            old.unlink()
        return path

    def latest_step(self) -> Optional[int]:
        found = self._checkpoints()
        return found[-1][0] if found else None

    def maybe_resume(self, state, map_location: Any = None):
        """(state, start_step): loads the newest checkpoint into `state` when
        `resume_if_exists` and there is one."""
        found = self._checkpoints()
        if not self.resume_if_exists or not found:
            return state, 0
        saved = torch.load(found[-1][1], map_location=map_location, weights_only=False)
        state.load_state_dict(saved["state"])
        return state, int(state.step)

    # -- run control -----------------------------------------------------
    def check_early_stop(self, val_metrics: Dict[str, float]) -> bool:
        """Feed one validation round to the early stopper (nothing when early
        stopping is not configured); returns True to stop."""
        if self.early_stopper is None:
            return False
        return self.early_stopper.update(val_metrics)

    def should_stop(self) -> bool:
        if self.preemption.should_stop:
            return True
        if self.early_stopper is not None and self.early_stopper.stopped:
            return True
        return (self.max_time_seconds is not None
                and time.monotonic() - self._start_time > self.max_time_seconds)

    def close(self) -> None:
        """Close the loggers, put the SIGTERM handler back and detach the
        per-process log file; safe to call twice."""
        try:
            if self.logger is not None:
                self.logger.close()
                self.logger = None
        finally:
            self.preemption.uninstall()
            if self._log_handler is not None:
                get_logger().removeHandler(self._log_handler)
                self._log_handler.close()
                self._log_handler = None


def yaml_safe(obj):
    """The config without what yaml cannot carry (callables go, other
    objects become their str)."""
    if isinstance(obj, dict):
        return {k: yaml_safe(v) for k, v in obj.items() if not callable(v)}
    if isinstance(obj, (list, tuple)):
        return [yaml_safe(v) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return str(obj)
