"""HiFi-GAN vocoder task, inference half.

Port of roar_tpu/models/hifigan_model.py:41 `generator_from_config`.  The GAN
training task (discriminators, losses, the D+G step) is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict

from roar_tpu_torch.models.hifigan import Generator


def generator_from_config(cfg: Dict[str, Any], initial_input_size: int = 80) -> Generator:
    """Build a Generator from a generator YAML block
    (configs/hifigan/generator/v1.yaml keys)."""
    return Generator(
        resblock=cfg.get("resblock", 1),
        upsample_rates=tuple(cfg.get("upsample_rates", (8, 8, 2, 2))),
        upsample_kernel_sizes=tuple(cfg.get("upsample_kernel_sizes", (16, 16, 4, 4))),
        upsample_initial_channel=cfg.get("upsample_initial_channel", 512),
        resblock_kernel_sizes=tuple(cfg.get("resblock_kernel_sizes", (3, 7, 11))),
        resblock_dilation_sizes=tuple(
            tuple(d) for d in cfg.get("resblock_dilation_sizes", ((1, 3, 5),) * 3)),
        initial_input_size=cfg.get("initial_input_size", initial_input_size),
    ).eval()


def vocoder_from_config(cfg: Dict[str, Any]) -> Generator:
    """The generator of a HiFi-GAN task config (the `model` block of
    configs/hifigan_22050.yaml), fed mels of the preprocessor's width."""
    pre = cfg.get("preprocessor") or {}
    n_mel = pre.get("features", pre.get("nfilt", 64))  # roar_tpu's preprocessor_config default
    return generator_from_config(cfg.get("generator") or {}, n_mel)
