"""Train the standalone Aligner with the PyTorch port, on one CUDA card.

Same config and overrides as examples/tts/aligner.py:

    python examples/tts/aligner_torch.py --config-name=aligner \
        train_dataset=train.json sup_data_path=sup [device=cuda]

The trained `AlignerModel.align` gives each token's duration in mel frames,
which a FastPitch without learned alignment trains on (`durations` in its
`sup_data_types`, a `duration_filepath` per manifest entry).  For those
durations to count FastPitch's frames and tokens, train the aligner with
FastPitch's STFT (`n_window_size`, `n_window_stride`, `n_fft`) and
`model.text_tokenizer`.  `device=cpu` runs the same loop on the host.
`run(cfg)` takes the loaded config as a Python dict.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch

from roar_tpu_torch.config.cli import config_runner
from roar_tpu_torch.data.dataset import BucketSpec
from roar_tpu_torch.models.aligner_model import AlignerModel
from roar_tpu_torch.training.run import build_tts_dataset, train_supervised


def run(cfg: dict):
    """Build the task and the dataset from `cfg` and train; returns the final
    training state (its `model` is the AlignerModel)."""
    device = cfg.get("device", "cuda")
    trainer_cfg = cfg.get("trainer") or {}
    model_cfg = dict(cfg["model"])
    model_cfg.setdefault("max_epochs", trainer_cfg.get("max_epochs", 100))
    model = AlignerModel(model_cfg,
                         generator=torch.Generator().manual_seed(int(trainer_cfg.get("seed", 0))))
    train_ds = build_tts_dataset(cfg["model"]["train_ds"]["dataset"], model.tokenizer, device)
    return train_supervised(cfg, model, train_ds, None, buckets=BucketSpec(), device=device)


main = config_runner(
    config_path=str(Path(__file__).resolve().parents[2] / "configs"),
    config_name="aligner",
)(run)


if __name__ == "__main__":
    main()
