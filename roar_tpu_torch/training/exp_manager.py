"""Experiment directory, metrics log, checkpoints, resume and time limit.

A minimal port of roar_tpu/training/exp_manager.py: the run directory
`<exp_dir>/<name>[/<version>]`, a metrics logger that appends JSON lines to
`metrics.jsonl` and prints them, `save` / `maybe_resume` of a training state
(anything with `state_dict()`, `load_state_dict()` and `step`) through
`torch.save`, and `should_stop` on `max_time_seconds`.  The TensorBoard,
W&B, MLflow, DLLogger and ClearML loggers, early stopping, the preemption
handler and the environment snapshot of the JAX package are not ported yet.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional

import torch


class MetricsLogger:
    """Appends `{"step": n, ...metrics}` lines to `<root>/metrics.jsonl`."""

    def __init__(self, root: Path, echo: bool = True):
        self.path = Path(root) / "metrics.jsonl"
        self.echo = echo
        self._file = open(self.path, "a", encoding="utf-8")

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        record = {"step": int(step), "time": time.time(),
                  **{k: float(v) for k, v in metrics.items()}}
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()
        if self.echo:
            shown = " ".join(f"{k}={float(v):.5g}" for k, v in metrics.items())
            print(f"step {int(step)}: {shown}", flush=True)

    def close(self) -> None:
        self._file.close()


class ExpManager:
    def __init__(self, exp_dir: str, name: str = "default", version: Optional[str] = None,
                 resume_if_exists: bool = False, max_to_keep: int = 3,
                 max_time_seconds: Optional[float] = None, echo: bool = True):
        self.root = Path(exp_dir) / name
        if version:
            self.root = self.root / version
        self.root.mkdir(parents=True, exist_ok=True)
        self.ckpt_dir = self.root / "checkpoints"
        self.ckpt_dir.mkdir(exist_ok=True)
        self.resume_if_exists = resume_if_exists
        self.max_to_keep = max_to_keep
        self.max_time_seconds = max_time_seconds
        self.logger = MetricsLogger(self.root, echo=echo)
        self._start_time = time.monotonic()

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

    def should_stop(self) -> bool:
        return (self.max_time_seconds is not None
                and time.monotonic() - self._start_time > self.max_time_seconds)

    def close(self) -> None:
        self.logger.close()
