"""FastPitchModel: config dict -> tokenizer + FastPitchModule, inference half.

Port of roar_tpu/models/fastpitch_model.py: `_fft_config`, `_predictor_config`,
`strip_inert_conditioning` and the inference part of `FastPitchModel`
(tokenizer, normalizer hook, `parse`, `generate_spectrogram`).  It reads the
same YAML-shaped config dict as the JAX package.  Losses and training steps
are not ported yet.
"""

from __future__ import annotations

import importlib
import warnings
from typing import Any, Dict, Tuple

import numpy as np
import torch

from roar_tpu_torch.data import tokenizers
from roar_tpu_torch.models.fastpitch import FastPitchModule, FFTConfig, PredictorConfig

_CONDITIONED_BLOCKS = (
    "input_fft", "output_fft", "duration_predictor", "pitch_predictor",
    "energy_predictor", "alignment_module",
)


def strip_inert_conditioning(cfg: Dict[str, Any], n_speakers: int, use_gst: bool) -> Dict[str, Any]:
    """With one speaker and no GST the speaker embedding is always None, so
    drop condition_types from every sub-module (with a warning), as the JAX
    package does."""
    if n_speakers > 1 or use_gst:
        return cfg
    if not any((cfg.get(k) or {}).get("condition_types") for k in _CONDITIONED_BLOCKS):
        return cfg
    warnings.warn(
        "n_speakers<=1 with no GST: speaker conditioning has no source; "
        "dropping condition_types from all sub-modules")
    cfg = dict(cfg)
    for k in _CONDITIONED_BLOCKS:
        if cfg.get(k) and cfg[k].get("condition_types"):
            cfg[k] = {**cfg[k], "condition_types": []}
    return cfg


def _fft_config(cfg: Dict[str, Any]) -> FFTConfig:
    if cfg.get("encoder_type", "conformer" if "Conformer" in cfg.get("_target_", "") else
               "transformer") != "transformer":
        raise NotImplementedError("only the transformer FFT stack is ported")
    if cfg.get("adapter_dim", 0):
        raise NotImplementedError("adapters are not ported")
    return FFTConfig(
        n_layer=cfg.get("n_layer", 6),
        n_head=cfg.get("n_head", 1),
        d_model=cfg.get("d_model", 384),
        d_head=cfg.get("d_head", 64),
        d_inner=cfg.get("d_inner", 1536),
        kernel_size=cfg.get("kernel_size", 3),
        pre_lnorm=cfg.get("pre_lnorm", False),
        condition_types=tuple(cfg.get("condition_types", ())),
        use_rope=cfg.get("use_rope", False),
        use_flash=cfg.get("use_flash", cfg.get("use_flash_attention", False)),
    )


def _predictor_config(cfg: Dict[str, Any]) -> PredictorConfig:
    return PredictorConfig(
        input_size=cfg.get("input_size", 384),
        kernel_size=cfg.get("kernel_size", 3),
        filter_size=cfg.get("filter_size", 256),
        n_layers=cfg.get("n_layers", 2),
        condition_types=tuple(cfg.get("condition_types", ())),
    )


def _instantiate(cfg: Dict[str, Any]):
    """Build a `_target_` config: class path, then keyword arguments."""
    cfg = dict(cfg)
    module, _, name = cfg.pop("_target_").rpartition(".")
    return getattr(importlib.import_module(module), name)(**cfg)


def make_tokenizer(cfg: Dict[str, Any]):
    """The port's tokenizer named by a `_target_` config.  The JAX configs
    name roar_tpu (or reference) classes; the class name picks the port's
    copy in roar_tpu_torch.data.tokenizers."""
    cfg = dict(cfg)
    name = cfg.pop("_target_").rpartition(".")[2]
    cls = getattr(tokenizers, name, None)
    if cls is None:
        raise ValueError(f"tokenizer {name} is not in roar_tpu_torch.data.tokenizers")
    return cls(**cfg)


class FastPitchModel:
    """Task wrapper: config -> tokenizer + FastPitchModule (inference)."""

    def __init__(self, cfg: Dict[str, Any]):
        self.cfg = cfg
        tok_cfg = cfg.get("text_tokenizer")
        self.tokenizer = make_tokenizer(tok_cfg) if tok_cfg else None
        self._setup_normalizer(cfg)
        n_symbols = cfg.get("n_symbols") or len(self.tokenizer.tokens)
        padding_idx = (
            self.tokenizer.pad if self.tokenizer is not None else cfg.get("padding_idx", 0))
        self.sample_rate = int((cfg.get("preprocessor") or {}).get("sample_rate", 16000))
        n_speakers = cfg.get("n_speakers", 1)
        lookup = (cfg.get("speaker_encoder") or {}).get("lookup_module") or {}
        if lookup.get("n_speakers"):
            n_speakers = lookup["n_speakers"]
        if cfg.get("use_gst"):
            raise NotImplementedError("GST conditioning is not ported")
        cfg = strip_inert_conditioning(cfg, n_speakers, False)
        energy_cfg = cfg.get("energy_predictor")
        self.learn_alignment = cfg.get("learn_alignment", cfg.get("alignment_module") is not None)
        self.module = FastPitchModule(
            n_symbols=n_symbols,
            padding_idx=padding_idx,
            encoder=_fft_config(cfg.get("input_fft", {})),
            decoder=_fft_config(cfg.get("output_fft", {})),
            duration_predictor=_predictor_config(cfg.get("duration_predictor", {})),
            pitch_predictor=_predictor_config(cfg.get("pitch_predictor", {})),
            energy_predictor=_predictor_config(energy_cfg) if energy_cfg else None,
            n_speakers=n_speakers,
            symbols_embedding_dim=cfg.get("symbols_embedding_dim", 384),
            pitch_embedding_kernel_size=cfg.get("pitch_embedding_kernel_size", 3),
            energy_embedding_kernel_size=cfg.get("energy_embedding_kernel_size", 3),
            n_mel_channels=cfg.get("n_mel_channels", 80),
            min_token_duration=cfg.get("min_token_duration", 0),
            max_token_duration=cfg.get("max_token_duration", 75),
            speaker_emb_condition_prosody=cfg.get("speaker_emb_condition_prosody", False),
            speaker_emb_condition_decoder=cfg.get("speaker_emb_condition_decoder", False),
        ).eval()

    def _setup_normalizer(self, cfg: Dict[str, Any]) -> None:
        """Optional text normalizer applied in parse(): a callable, or a
        `_target_` config (a warning, and no normalization, if it cannot be
        built)."""
        self.normalizer_call = None
        self.text_normalizer_call_kwargs = dict(cfg.get("text_normalizer_call_kwargs") or {})
        norm_cfg = cfg.get("text_normalizer")
        if norm_cfg is None:
            return
        if callable(norm_cfg):
            self.normalizer_call = norm_cfg
            return
        try:
            normalizer = _instantiate(norm_cfg)
        except Exception as e:  # an optional dependency may be absent
            warnings.warn(f"text_normalizer could not be instantiated ({e}); "
                          "parse() will skip normalization")
            return
        self.normalizer_call = getattr(normalizer, "normalize", normalizer)

    def parse(self, text: str) -> np.ndarray:
        """Text -> [1, T] int32 token ids: optional normalizer, then the
        tokenizer (the learned-alignment path)."""
        if self.tokenizer is None:
            raise ValueError("No tokenizer configured")
        if not self.learn_alignment:
            raise NotImplementedError("the ENCharParser path (learn_alignment: false) "
                                      "is not ported")
        if self.normalizer_call is not None:
            text = self.normalizer_call(text, **self.text_normalizer_call_kwargs)
        return np.asarray(self.tokenizer(text), np.int32)[None]

    @torch.inference_mode()
    def generate_spectrogram(self, tokens: torch.Tensor, speaker=None, pace: float = 1.0,
                             max_mel_len: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens [B, T_text] -> (mel [B, max_mel_len, n_mel], lens [B])."""
        out = self.module.infer(tokens, speaker=speaker, pace=pace, max_mel_len=max_mel_len)
        return out["spect"], out["num_frames"]
