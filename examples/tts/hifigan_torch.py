"""Train the HiFi-GAN vocoder with the PyTorch port, on one CUDA card.

Same config and overrides as examples/tts/hifigan.py:

    python examples/tts/hifigan_torch.py --config-name=hifigan_22050 \
        train_dataset=train.json validation_datasets=val.json [device=cuda]

`device=cpu` runs the same loop on the host with the kernels' plain versions
(add `model.debug=true` for narrow discriminators).  `run(cfg)` takes the
loaded config as a Python dict.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch

from roar_tpu_torch.config.cli import config_runner
from roar_tpu_torch.models.hifigan_model import HifiGanModel
from roar_tpu_torch.training.run import build_validation_datasets, build_vocoder_dataset, train_gan


def run(cfg: dict):
    """Build the task and the datasets from `cfg` and train; returns the
    final GAN state."""
    seed = int((cfg.get("trainer") or {}).get("seed", 0))
    model = HifiGanModel(cfg["model"], generator=torch.Generator().manual_seed(seed))
    train_ds = build_vocoder_dataset(cfg["model"]["train_ds"]["dataset"])
    val_cfg = (cfg["model"].get("validation_ds") or {}).get("dataset")
    val_ds = build_validation_datasets(val_cfg, build_vocoder_dataset) if val_cfg else None
    return train_gan(cfg, model, train_ds, val_ds, device=cfg.get("device", "cuda"))


main = config_runner(
    config_path=str(Path(__file__).resolve().parents[2] / "configs"),
    config_name="hifigan_22050",
)(run)


if __name__ == "__main__":
    main()
