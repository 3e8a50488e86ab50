"""Adapter fine-tuning of FastPitch with the PyTorch port, on one CUDA card.

The steps of examples/tts/fastpitch_finetune_adapters.py:
1. build the model with bottleneck adapters (`adapter_dim`, 64 by default) in
   every layer of both FFT stacks; an adapter is the identity at insertion;
2. transplant a pretrained `.roar` bundle into it (`transfer_params`, matched
   by flax path; the adapters keep their initial values);
3. train only the adapters and the speaker table (`masked_optimizer` over
   the parameters whose flax path matches `adapter` or `speaker_table`).

    python examples/tts/fastpitch_finetune_adapters_torch.py \
        --config-name=fastpitch_22050_align \
        train_dataset=ft.json sup_data_path=sup pitch_mean=... pitch_std=... \
        +pretrained=base_model.roar +adapter_dim=64 [+device=cpu]

It trains in fp32, as the JAX recipe does.  With
`model.input_fft.use_flash=true model.output_fft.use_flash=true` and
`dropatt=0.0` in both stacks every attention layer runs the flash-attention
kernels.  `run(cfg)` takes the loaded config as a Python dict and returns the
training state.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch

from roar_tpu_torch.config.cli import config_runner
from roar_tpu_torch.data.dataset import BucketSpec
from roar_tpu_torch.data.sampling import LengthBucketBatchSampler
from roar_tpu_torch.models.fastpitch_model import FastPitchModel
from roar_tpu_torch.training import convert
from roar_tpu_torch.training.exp_manager import ExpManager
from roar_tpu_torch.training.finetune import count_trainable, masked_optimizer
from roar_tpu_torch.training.run import batch_iterator, build_tts_dataset
from roar_tpu_torch.training.save_restore import restore_from, transfer_params
from roar_tpu_torch.training.trainer import Trainer
from roar_tpu_torch.utils.logging import get_logger

TRAINABLE = [r"adapter", r"speaker_table"]


def run(cfg: dict):
    log = get_logger()
    device = cfg.get("device", "cuda")
    adapter_dim = int(cfg.get("adapter_dim", 64))
    model_cfg = dict(cfg["model"])
    for fft in ("input_fft", "output_fft"):
        model_cfg[fft] = {**(model_cfg.get(fft) or {}), "adapter_dim": adapter_dim}
    seed = int((cfg.get("trainer") or {}).get("seed", 0))
    model = FastPitchModel(model_cfg, generator=torch.Generator().manual_seed(seed))

    ds = build_tts_dataset(cfg["model"]["train_ds"]["dataset"], model.tokenizer, device)
    buckets = BucketSpec()
    sampler = LengthBucketBatchSampler(
        ds.lengths,
        batch_size=cfg["model"]["train_ds"]["dataloader_params"].get("batch_size", 16))

    if cfg.get("pretrained"):
        _, source = restore_from(cfg["pretrained"])
        tree, loaded, _ = transfer_params(convert.fastpitch_to_jax_tree(model.module), source)
        convert.load_fastpitch_params(model.module, tree)
        log.info(f"warm start: {len(loaded)} tensors transplanted")

    opt = masked_optimizer(cfg["model"].get("optim", {}), model, TRAINABLE)
    n_train, n_total = count_trainable(model, TRAINABLE)
    log.info(f"training {n_train / 1e6:.2f}M of {n_total / 1e6:.2f}M params")

    trainer = Trainer(model, opt, device=device)
    exp = ExpManager(exp_dir=(cfg.get("exp_manager") or {}).get("exp_dir") or "./exp",
                     name="fastpitch_adapters")
    try:
        state = trainer.init_state()
        for epoch in range((cfg.get("trainer") or {}).get("max_epochs", 100)):
            sampler.set_epoch(epoch)
            state, metrics = trainer.run_epoch(state, batch_iterator(ds, sampler, buckets),
                                               epoch=epoch, logger=exp.logger)
            exp.save(state, metrics)
            if exp.should_stop():
                break
    finally:
        exp.close()
    return state


main = config_runner(
    config_path=str(Path(__file__).resolve().parents[2] / "configs"),
    config_name="fastpitch_22050_align",
)(run)


if __name__ == "__main__":
    main()
