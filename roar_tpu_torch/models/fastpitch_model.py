"""FastPitchModel: config dict -> tokenizer + FastPitchModule + losses.

Port of roar_tpu/models/fastpitch_model.py: `_fft_config`, `_predictor_config`,
`preprocessor_config`, `strip_inert_conditioning` and `FastPitchModel`
(tokenizer, normalizer hook, `parse`, `generate_spectrogram`, the mel front end
of a batch, `loss_fn` with the `bin_loss` warm-up by epoch,
`interpolate_speaker`).  It reads the same YAML-shaped config dict as the JAX
package.  The parameters live in `self.module`; `loss_fn(batch, epoch)` takes
a batch of tensors on the module's device.
"""

from __future__ import annotations

import importlib
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from roar_tpu_torch.data import tokenizers
from roar_tpu_torch.losses.fastpitch_losses import (
    duration_loss,
    energy_loss,
    mel_loss,
    pitch_loss,
)
from roar_tpu_torch.models.fastpitch import (
    AlignerConfig,
    FastPitchModule,
    FFTConfig,
    PredictorConfig,
    init_parameters,
)
from roar_tpu_torch.models.submodules import set_compute_dtype, set_dropout_generator
from roar_tpu_torch.ops.forward_sum import bin_loss, forward_sum_loss
from roar_tpu_torch.ops.spectrogram import MelConfig, log_mel_spectrogram

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
    if cfg.get("remat", False):
        raise NotImplementedError("remat (recomputing layer activations) is not ported")
    return FFTConfig(
        n_layer=cfg.get("n_layer", 6),
        n_head=cfg.get("n_head", 1),
        d_model=cfg.get("d_model", 384),
        d_head=cfg.get("d_head", 64),
        d_inner=cfg.get("d_inner", 1536),
        kernel_size=cfg.get("kernel_size", 3),
        dropout=cfg.get("dropout", 0.1),
        dropatt=cfg.get("dropatt", 0.1),
        dropemb=cfg.get("dropemb", 0.0),
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
        dropout=cfg.get("dropout", 0.1),
        n_layers=cfg.get("n_layers", 2),
        condition_types=tuple(cfg.get("condition_types", ())),
    )


def preprocessor_config(cfg: Dict[str, Any]) -> MelConfig:
    """The `preprocessor` YAML block (fastpitch_22050_align.yaml:118-135) as a
    MelConfig."""
    lzgv = cfg.get("log_zero_guard_value", 2 ** -24)
    if isinstance(lzgv, str) and lzgv not in ("tiny", "eps"):
        lzgv = float(lzgv)
    return MelConfig(
        sample_rate=cfg.get("sample_rate", 16000),
        n_window_size=cfg.get("n_window_size", 320),
        n_window_stride=cfg.get("n_window_stride", 160),
        window=cfg.get("window", "hann"),
        normalize=cfg.get("normalize"),
        n_fft=cfg.get("n_fft"),
        preemph=cfg.get("preemph", 0.97),
        nfilt=cfg.get("features", cfg.get("nfilt", 64)),
        lowfreq=cfg.get("lowfreq", 0),
        highfreq=cfg.get("highfreq"),
        log=cfg.get("log", True),
        log_zero_guard_type=cfg.get("log_zero_guard_type", "add"),
        log_zero_guard_value=lzgv,
        dither=cfg.get("dither", 1e-5),
        pad_to=cfg.get("pad_to", 16),
        exact_pad=cfg.get("exact_pad", False),
        pad_value=cfg.get("pad_value", 0),
        mag_power=cfg.get("mag_power", 2.0),
        mel_norm=cfg.get("mel_norm", "slaney"),
    )


@torch.no_grad()
def spec_from_batch(batch: Dict[str, torch.Tensor], mel_cfg: MelConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, T_mel, n_mel] log-mel of the batch's audio on the device and its
    lengths, the time axis cropped or zero-padded to the batch's mel bucket
    (the sup-data's frames; the audio is padded to an audio bucket, so the raw
    frame count can exceed the collated mel bucket)."""
    mel, mel_lens = log_mel_spectrogram(batch["audio"], batch["audio_len"], mel_cfg)
    spec = mel.transpose(1, 2)
    t_mel = next((batch[key].shape[1] for key in ("align_prior_matrix", "pitch", "energy")
                  if batch.get(key) is not None), None)
    if t_mel is not None:
        if spec.shape[1] > t_mel:
            spec = spec[:, :t_mel]
        elif spec.shape[1] < t_mel:
            spec = torch.nn.functional.pad(spec, (0, 0, 0, t_mel - spec.shape[1]))
        mel_lens = torch.clamp(mel_lens, max=t_mel)
    return spec.contiguous(), mel_lens


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
    """Task wrapper: config -> tokenizer + FastPitchModule + losses.
    `generator`, when given, seeds the parameters (the flax initialisers'
    distributions, `models.fastpitch.init_parameters`); without one they are
    torch's defaults, to be filled by `convert.load_fastpitch_params`."""

    def __init__(self, cfg: Dict[str, Any], generator: Optional[torch.Generator] = None):
        self.cfg = cfg
        tok_cfg = cfg.get("text_tokenizer")
        self.tokenizer = make_tokenizer(tok_cfg) if tok_cfg else None
        self._setup_normalizer(cfg)
        n_symbols = cfg.get("n_symbols") or len(self.tokenizer.tokens)
        padding_idx = (
            self.tokenizer.pad if self.tokenizer is not None else cfg.get("padding_idx", 0))
        self.mel_cfg = preprocessor_config(cfg.get("preprocessor") or {})
        self.sample_rate = int(self.mel_cfg.sample_rate)
        n_speakers = cfg.get("n_speakers", 1)
        lookup = (cfg.get("speaker_encoder") or {}).get("lookup_module") or {}
        if lookup.get("n_speakers"):
            n_speakers = lookup["n_speakers"]
        if cfg.get("use_gst"):
            raise NotImplementedError("GST conditioning is not ported")
        cfg = strip_inert_conditioning(cfg, n_speakers, False)
        energy_cfg = cfg.get("energy_predictor")
        aligner_cfg = cfg.get("alignment_module")
        self.learn_alignment = cfg.get("learn_alignment", aligner_cfg is not None)
        aligner_cfg = aligner_cfg or {}
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
            aligner=AlignerConfig(
                n_text_channels=aligner_cfg.get("n_text_channels",
                                                cfg.get("symbols_embedding_dim", 384)),
                n_att_channels=aligner_cfg.get("n_att_channels", 80),
                temperature=aligner_cfg.get("temperature", 0.0005),
                condition_types=tuple(aligner_cfg.get("condition_types", ())),
                dist_type=aligner_cfg.get("dist_type", "l2"),
            ) if self.learn_alignment else None,
            speaker_emb_condition_aligner=cfg.get("speaker_emb_condition_aligner", False),
        ).eval()
        if generator is not None:
            init_parameters(self.module, generator)

        self.bin_loss_warmup_epochs = cfg.get("bin_loss_warmup_epochs", 100)
        self.aligner_loss_scale = cfg.get("aligner_loss_scale", 1.0)
        # prosody losses are scaled 0.1 when alignment is learned, 1.0 with given durations
        default_prosody_scale = 0.1 if self.learn_alignment else 1.0
        self.dur_loss_scale = cfg.get("dur_loss_scale", default_prosody_scale)
        self.pitch_loss_scale = cfg.get("pitch_loss_scale", default_prosody_scale)
        self.energy_loss_scale = cfg.get("energy_loss_scale", default_prosody_scale)

    # ------------------------------------------------------------------
    def parameters(self):
        return list(self.module.parameters())

    def to_jax_tree(self) -> Dict[str, Any]:
        """The parameters as the flax tree the JAX package's task holds (what
        a `.roar` bundle stores)."""
        from roar_tpu_torch.training import convert

        return convert.fastpitch_to_jax_tree(self.module)

    def set_dropout_generator(self, generator: Optional[torch.Generator]) -> None:
        """Draw the dropout masks of training-mode forwards from `generator`
        (which must live on the module's device)."""
        set_dropout_generator(self.module, generator)

    def set_compute_dtype(self, dtype: Optional[torch.dtype]) -> None:
        """Compute in `dtype` (bf16: `precision="bf16"` of
        roar_tpu/training/trainer.py:152-174) from the fp32 masters, the
        layers casting each parameter where they use it; the mel front end,
        the aligner's mel queries, MAS and the loss masks stay fp32 as in the
        JAX package.  None computes in the parameters' own type."""
        set_compute_dtype(self.module, dtype)

    def attention_paths(self) -> Dict[str, str]:
        """Which attention path each FFT stack takes in the module's present
        mode: "flash" (the kernels) or "einsum"."""
        return {"input_fft": self.module.encoder_module.stack.attention_path(),
                "output_fft": self.module.decoder_module.attention_path()}

    def loss_fn(self, batch: Dict[str, torch.Tensor], epoch: int = 0,
                mark=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Training loss of one batch (roar_tpu/models/fastpitch_model.py:243-313):
        (loss, metrics as tensors on the batch's device).  Dropout follows the
        module's mode.  `mark(name)`, when given, is called as each part has
        been enqueued ("mel_front_end", "model_forward", "losses")."""
        mark = mark or (lambda name: None)
        spec, mel_lens = spec_from_batch(batch, self.mel_cfg)
        mark("mel_front_end")
        text_lens = batch["text_len"]
        out = self.module(
            batch["text"].long(), durs=batch.get("durations"), pitch=batch.get("pitch"),
            energy=batch.get("energy"),
            speaker=batch["speaker_id"].long() if "speaker_id" in batch else None,
            spec=spec if self.learn_alignment else None,
            attn_prior=batch.get("align_prior_matrix"), mel_lens=mel_lens,
            input_lens=text_lens,
            max_mel_len=None if self.learn_alignment else spec.shape[1])
        mark("model_forward")

        l_mel = mel_loss(out["spect"], spec)
        durs_tgt = out["attn_hard_dur"] if self.learn_alignment else batch.get("durations")
        l_dur = duration_loss(out["log_durs_predicted"], durs_tgt, text_lens,
                              loss_scale=self.dur_loss_scale)
        loss = l_mel + l_dur
        metrics = {"mel_loss": l_mel, "dur_loss": l_dur}
        if out["pitch"] is not None:
            l_pitch = pitch_loss(out["pitch_predicted"], out["pitch"], text_lens,
                                 loss_scale=self.pitch_loss_scale)
            loss = loss + l_pitch
            metrics["pitch_loss"] = l_pitch
        if out["energy_pred"] is not None and out["energy_tgt"] is not None:
            l_energy = energy_loss(out["energy_pred"], out["energy_tgt"], text_lens,
                                   loss_scale=self.energy_loss_scale)
            loss = loss + l_energy
            metrics["energy_loss"] = l_energy
        if self.learn_alignment:
            ctc = forward_sum_loss(out["attn_logprob"], text_lens, mel_lens,
                                   loss_scale=self.aligner_loss_scale)
            # zero at epoch 0, one from `bin_loss_warmup_epochs` on
            bin_w = min(epoch / max(self.bin_loss_warmup_epochs, 1), 1.0)
            l_bin = bin_loss(out["attn_hard"], out["attn_soft"]) * bin_w * self.aligner_loss_scale
            loss = loss + ctc + l_bin
            metrics["ctc_loss"] = ctc
            metrics["bin_loss"] = l_bin
        metrics["loss"] = loss
        mark("losses")
        return loss, {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def interpolate_speaker(self, original_speaker_1: int, original_speaker_2: int,
                            weight_speaker_1: float, weight_speaker_2: float,
                            new_speaker_id: int) -> None:
        """Blend two trained speaker embeddings into a third slot of the
        speaker table, in place: row `new_speaker_id` becomes
        `w1 * emb[s1] + w2 * emb[s2]`."""
        table = getattr(self.module, "speaker_table", None)
        if table is None:
            raise ValueError("Speaker interpolation needs a multi-speaker FastPitch "
                             "(n_speakers > 1); this model has no speaker table.")
        n_speakers = table.weight.shape[0]
        for sid in (original_speaker_1, original_speaker_2, new_speaker_id):
            if not 0 <= sid < n_speakers:
                raise ValueError(f"speaker id {sid} out of range for n_speakers={n_speakers}")
        table.weight[new_speaker_id] = (weight_speaker_1 * table.weight[original_speaker_1]
                                        + weight_speaker_2 * table.weight[original_speaker_2])

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
