"""Train JETS end-to-end text->wav with the PyTorch port, on one CUDA card.

Same config and overrides as examples/tts/jets.py:

    python examples/tts/jets_torch.py --config-name=jets_22050_align \
        train_dataset=train.json validation_datasets=val.json sup_data_path=sup \
        pitch_mean=212.35 pitch_std=68.52 \
        model.speaker_encoder.lookup_module.n_speakers=4 [device=cuda]

With `model.input_fft.use_flash=true model.output_fft.use_flash=true` and
`model.input_fft.dropatt=0.0 model.output_fft.dropatt=0.0` every attention
layer runs the hand-written flash-attention kernels, forward and backward;
the multi-scale discriminator's grouped convs always run the grouped-conv
kernels on the card.  The YAML's `trainer.precision: bf16-mixed` trains in
bf16 from fp32 masters, through the kernels' bf16 forms; `trainer.precision=32`
trains in fp32.  With `--config-name=jets_22050_conformer` both stacks are
Conformers with rotary position embeddings; their attention dropout is 0.1
whatever `dropatt` says (as in the JAX package), so training and validation
take the einsum path and only synthesis reaches the flash forward.
`device=cpu` runs the same loop on the host with the kernels' plain versions.  `run(cfg)` takes the loaded config as a Python
dict.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch

from roar_tpu_torch.config.cli import config_runner
from roar_tpu_torch.data.dataset import BucketSpec
from roar_tpu_torch.models.jets_model import JETSModel
from roar_tpu_torch.training.run import build_tts_dataset, build_validation_datasets, train_gan


def run(cfg: dict):
    """Build the task and the datasets from `cfg` and train; returns the
    final GAN state."""
    device = cfg.get("device", "cuda")
    seed = int((cfg.get("trainer") or {}).get("seed", 0))
    model = JETSModel(cfg["model"], generator=torch.Generator().manual_seed(seed))
    train_ds = build_tts_dataset(cfg["model"]["train_ds"]["dataset"], model.tokenizer, device)
    val_cfg = (cfg["model"].get("validation_ds") or {}).get("dataset")
    val_ds = (
        build_validation_datasets(val_cfg, lambda c: build_tts_dataset(c, model.tokenizer, device))
        if val_cfg else None
    )
    return train_gan(cfg, model, train_ds, val_ds, buckets=BucketSpec(), device=device)


main = config_runner(
    config_path=str(Path(__file__).resolve().parents[2] / "configs"),
    config_name="jets_22050_align",
)(run)


if __name__ == "__main__":
    main()
