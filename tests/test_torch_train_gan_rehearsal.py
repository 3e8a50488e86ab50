"""A rehearsal of chip_smoke.py's HiFi-GAN training phase on the CPU, at
debug widths with the kernels' plain versions: every check of the phase but
the launch counts and the timings.
"""

import json
import sys
from pathlib import Path

import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]


def test_chip_smoke_training_phase_rehearsal_on_the_cpu(capsys):
    """The card's training phase at debug widths with the plain versions:
    every check of the phase but the launch counts and the timings."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    out = chip_smoke.phase_train_hifigan(torch.device("cpu"), n_utterances=4, steps=4,
                                         batch_size=2, n_segments=2048, debug=True)
    assert out == {"launches": {"fwd": 0, "dx": 0, "dw": 0}}
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [r["step"] for r in lines if r.get("phase") == "train_hifigan"] == [
        "cli", "bundle", "kernel_path_vs_plain_path"]
