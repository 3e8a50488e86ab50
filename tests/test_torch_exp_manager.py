"""The port's experiment manager: early stopping (the cases of the JAX
package's tests/test_callbacks_and_misc.py, and the same updates fed to its
`EarlyStopping`), the SIGTERM handler's install, flag and uninstall, the run
snapshot, and the logger fan-out (TensorBoard's event file; the absent
backends as no-ops)."""

import importlib.util
import json
import os
import signal
import threading

import pytest

from roar_tpu.training.exp_manager import EarlyStopping as JaxEarlyStopping
from roar_tpu_torch.training.exp_manager import (
    EarlyStopping,
    ExpManager,
    MetricsLogger,
    PreemptionHandler,
)
from roar_tpu_torch.utils.logging import get_logger, log_once, process_index

# (EarlyStopping kwargs, the metrics of each round, whether each round stops)
EARLY_STOP_CASES = {
    "min_mode_patience": ({"monitor": "val_loss", "mode": "min", "min_delta": 0.0,
                           "patience": 2},
                          [{"val_loss": v} for v in (1.0, 0.9, 0.95, 0.95)],
                          [False, False, False, True]),
    "min_delta_is_no_improvement": ({"monitor": "val_loss", "min_delta": 0.5, "patience": 1},
                                    [{"val_loss": 1.0}, {"val_loss": 0.8}], [False, True]),
    "max_mode": ({"monitor": "val_acc", "mode": "max", "min_delta": 0.0, "patience": 1},
                 [{"val_acc": v} for v in (0.5, 0.6, 0.55)], [False, False, True]),
    "non_finite_stops": ({"monitor": "val_loss", "check_finite": True},
                         [{"val_loss": float("nan")}], [True]),
    "missing_monitor_is_a_no_op": ({"monitor": "val_loss", "patience": 0},
                                   [{"other": 1.0}], [False]),
    "patience_zero_stops_on_the_second_round": (
        {"monitor": "val_loss", "min_delta": 1e9, "patience": 0},
        [{"val_loss": 1.0}, {"val_loss": 0.5}], [False, True]),
}


@pytest.mark.parametrize("case", sorted(EARLY_STOP_CASES))
def test_early_stopping_matches_jax(case):
    kwargs, rounds, stops = EARLY_STOP_CASES[case]
    port, jax_side = EarlyStopping(**kwargs), JaxEarlyStopping(**kwargs)
    for metrics, stop in zip(rounds, stops):
        assert port.update(metrics) == jax_side.update(metrics) == stop
        assert (port.best, port.wait) == (jax_side.best, jax_side.wait) or port.best != port.best
    assert port.stopped == stops[-1]


def test_early_stopping_bad_mode_raises():
    with pytest.raises(ValueError, match="min|max"):
        EarlyStopping(mode="sideways")


def test_preemption_handler_install_flag_and_uninstall():
    before = signal.getsignal(signal.SIGTERM)
    handler = PreemptionHandler().install()
    try:
        assert signal.getsignal(signal.SIGTERM) == handler._handler
        assert not handler.should_stop
        os.kill(os.getpid(), signal.SIGTERM)
        assert handler.should_stop
    finally:
        handler.uninstall()
    assert signal.getsignal(signal.SIGTERM) == before
    handler.uninstall()  # a second uninstall changes nothing
    assert signal.getsignal(signal.SIGTERM) == before


def test_preemption_handler_off_the_main_thread_raises():
    errors = []

    def install():
        try:
            PreemptionHandler().install()
        except RuntimeError as e:
            errors.append(str(e))

    thread = threading.Thread(target=install)
    thread.start()
    thread.join()
    assert errors and "main thread" in errors[0]


def test_exp_manager_snapshot_stop_and_close(tmp_path):
    before = signal.getsignal(signal.SIGTERM)
    cfg = {"model": {"lr": 1e-3, "hook": print}, "trainer": {"max_epochs": 2}}
    exp = ExpManager(exp_dir=str(tmp_path), name="run", version="v1", use_tensorboard=False,
                     early_stopping={"monitor": "val_loss", "patience": 1, "min_delta": 0.0},
                     config=cfg, echo=False)
    root = tmp_path / "run" / "v1"
    assert exp.root == root
    assert (root / "cmd-args.log").read_text().strip()
    import yaml

    assert yaml.safe_load((root / "config.yaml").read_text()) == {
        "model": {"lr": 1e-3}, "trainer": {"max_epochs": 2}}  # the callable is left out
    get_logger().info("a record for the per-process file")
    log_once("said once")
    log_once("said once")
    exp.logger.log_metrics({"loss": 1.5}, step=3)
    assert not exp.should_stop()
    assert not exp.check_early_stop({"val_loss": 1.0})
    assert exp.check_early_stop({"val_loss": 1.0}) and exp.should_stop()
    exp.close()
    exp.close()
    assert signal.getsignal(signal.SIGTERM) == before
    log_file = root / f"log_process-{process_index()}.txt"
    text = log_file.read_text()
    assert "a record for the per-process file" in text and text.count("said once") == 1
    get_logger().info("after close")
    assert "after close" not in log_file.read_text()
    record = json.loads((root / "metrics.jsonl").read_text().splitlines()[0])
    assert record["step"] == 3 and record["loss"] == 1.5


def test_exp_manager_preemption_reaches_should_stop(tmp_path):
    exp = ExpManager(exp_dir=str(tmp_path), use_tensorboard=False, echo=False)
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert exp.should_stop()
    finally:
        exp.close()


def test_rank_comes_from_the_environment(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    assert process_index() == 0
    monkeypatch.setenv("RANK", "3")
    assert process_index() == 3


def test_tensorboard_event_file_and_absent_backends(tmp_path):
    tb = pytest.importorskip("torch.utils.tensorboard")
    assert tb is not None
    # each other backend is asked for only where its package is absent, so
    # that the no-op path is what runs (a present one would start a real run)
    absent = {name: importlib.util.find_spec(name) is None
              for name in ("wandb", "mlflow", "dllogger", "clearml")}
    logger = MetricsLogger(tmp_path, echo=False, use_tensorboard=True,
                           **{f"use_{name}": flag for name, flag in absent.items()})
    assert all(getattr(logger, f"_{name}") is None for name in absent)
    assert logger._tb is not None
    logger.log_metrics({"loss": 0.25, "grad_norm": 2.0}, step=1)
    logger.log_metrics({"loss": 0.125}, step=2)
    logger.close()
    events = list((tmp_path / "tb").glob("events.out.tfevents.*"))
    assert len(events) == 1 and events[0].stat().st_size > 0
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    assert [(e.step, e.value) for e in acc.Scalars("loss")] == [(1, 0.25), (2, 0.125)]
