"""JETSModel: the end-to-end text->wav GAN task.

Port of roar_tpu/models/jets_model.py: config -> tokenizer, `JETSModule`
(FastPitch graph + trainable HiFi-GAN generator), MPD and MSD, and the D and
G losses that training/gan.py steps with its shared forward.  Per step:

- the module's forward gives predicted audio segments and the alignment and
  prosody outputs;
- the ground-truth audio is sliced at `z_start_idxs * hop`, the starts
  clamped to the audio buffer;
- D: MPD + MSD LSGAN losses on (real segment, predicted segment);
- G: L1 of the full-band mels of the segments x45, the duration, pitch and
  energy losses, forward-sum x2 and the bin loss x2 with its warm-up by
  epoch, feature matching x2 and the adversarial losses x1.

The modules hold their own parameters, so the loss functions take tensors
only.  One preprocessor, full band (`highfreq=None`) with gradients, serves
both the aligner's input mel and the segments' mel loss, as in the JAX
package.  bf16 (`precision: bf16-mixed`, the shipped config): `set_compute_dtype`
makes every layer of the generator graph and of the discriminators cast its
parameters where it uses them, and training/gan.py casts the batch.
The FFT stacks are the transformer or the Conformer (RoPE attention,
configs/jets_22050_conformer.yaml); `remat` on a transformer stack recomputes
its layers in the backward.  `use_gst` is ignored, as the JAX task ignores it
(ROADMAP N10).  `maybe_remat_disc` is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from roar_tpu_torch.losses.fastpitch_losses import duration_loss, energy_loss, pitch_loss
from roar_tpu_torch.losses.hifigan_losses import (
    discriminator_loss,
    feature_matching_loss,
    generator_loss,
    l1_mel_loss,
)
from roar_tpu_torch.models.fastpitch import AlignerConfig, init_parameters
from roar_tpu_torch.models.fastpitch_model import (
    _fft_config,
    _predictor_config,
    make_tokenizer,
    preprocessor_config,
    spec_from_batch,
    strip_inert_conditioning,
)
from roar_tpu_torch.models.hifigan import (
    Generator,
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
)
from roar_tpu_torch.models.hifigan_model import _generator_kwargs
from roar_tpu_torch.models.jets import JETSModule
from roar_tpu_torch.models.submodules import set_compute_dtype
from roar_tpu_torch.ops.forward_sum import bin_loss, forward_sum_loss
from roar_tpu_torch.ops.lengths import slice_segments
from roar_tpu_torch.ops.spectrogram import log_mel_spectrogram


class JETSModel:
    """The JETS GAN task.  `cfg` is the `model` block of
    configs/jets_22050_align.yaml; `generator`, when given, seeds the
    parameters (the flax initialisers' distributions); without one they are
    to be filled by `training.convert.load_jets_bundle`."""

    def __init__(self, cfg: Dict[str, Any], generator: Optional[torch.Generator] = None):
        self.cfg = cfg
        tok_cfg = cfg.get("text_tokenizer")
        self.tokenizer = make_tokenizer(tok_cfg) if tok_cfg else None
        n_symbols = cfg.get("n_symbols") or len(self.tokenizer.tokens)
        padding_idx = (
            self.tokenizer.pad if self.tokenizer is not None else cfg.get("padding_idx", 0))

        # ONE preprocessor, full band (highfreq=None -> Nyquist) whatever the
        # config's fmax: the aligner's input mel and the segments' mel loss
        self.mel_cfg = dataclasses.replace(preprocessor_config(cfg.get("preprocessor") or {}),
                                           use_grads=True, highfreq=None)
        self.sample_rate = int(self.mel_cfg.sample_rate)
        self.segment_size = cfg.get("segment_size", 64)
        self.hop_length = self.mel_cfg.hop_length

        d = cfg.get("symbols_embedding_dim", 384)
        self.learn_alignment = cfg.get("learn_alignment", cfg.get("alignment_module") is not None)
        gen_cfg = dict(cfg.get("waveform_generator", cfg.get("generator", {})))
        gen_cfg.setdefault("initial_input_size", d)
        waveform = Generator(**_generator_kwargs(gen_cfg, d), weight_norm=True,
                             generator=generator)
        if waveform.upsample_factor != self.hop_length:
            raise ValueError(f"generator upsample {waveform.upsample_factor} != hop "
                             f"{self.hop_length}")

        lookup = (cfg.get("speaker_encoder") or {}).get("lookup_module") or {}
        n_speakers = lookup.get("n_speakers") or cfg.get("n_speakers", 1)
        cfg = strip_inert_conditioning(cfg, n_speakers, False)
        aligner_cfg = cfg.get("alignment_module") or {}
        energy_cfg = cfg.get("energy_predictor")
        self.module = JETSModule(
            n_symbols=n_symbols,
            generator=waveform,
            padding_idx=padding_idx,
            encoder=_fft_config(cfg.get("input_fft", {})),
            decoder=_fft_config(cfg.get("output_fft", {})),
            duration_predictor=_predictor_config(cfg.get("duration_predictor", {})),
            pitch_predictor=_predictor_config(cfg.get("pitch_predictor", {})),
            energy_predictor=_predictor_config(energy_cfg) if energy_cfg else None,
            aligner=AlignerConfig(
                n_text_channels=aligner_cfg.get("n_text_channels", d),
                n_att_channels=aligner_cfg.get("n_att_channels", 80),
                temperature=aligner_cfg.get("temperature", 0.0005),
                condition_types=tuple(aligner_cfg.get("condition_types", ())),
                dist_type=aligner_cfg.get("dist_type", "l2"),
            ) if self.learn_alignment else None,
            n_speakers=n_speakers,
            symbols_embedding_dim=d,
            segment_size=self.segment_size,
            n_mel_channels=self.mel_cfg.nfilt,
            max_token_duration=cfg.get("max_token_duration", 75),
            speaker_emb_condition_prosody=cfg.get("speaker_emb_condition_prosody", False),
            speaker_emb_condition_decoder=cfg.get("speaker_emb_condition_decoder", False),
            speaker_emb_condition_aligner=cfg.get("speaker_emb_condition_aligner", False),
        )
        if generator is not None:
            init_parameters(self.module, generator)  # the generator's convs drew their own
        debug = cfg.get("debug", False)
        self.mpd = MultiPeriodDiscriminator(debug=debug, generator=generator)
        self.msd = MultiScaleDiscriminator(debug=debug, variant=cfg.get("msd_variant", "grouped"),
                                           generator=generator)

        self.mel_loss_scale = cfg.get("mel_loss_scale", 45.0)
        self.feature_loss_scale = cfg.get("feature_loss_scale", 2.0)
        self.adversarial_loss_scale = cfg.get("adv_loss_scale", 1.0)
        self.aligner_loss_scale = cfg.get("aligner_loss_scale", 2.0)
        self.bin_loss_warmup_epochs = cfg.get("bin_loss_warmup_epochs", 100)
        self.compute_dtype: Optional[torch.dtype] = None

    # ------------------------------------------------------------------
    def set_compute_dtype(self, dtype: Optional[torch.dtype]) -> None:
        """Compute in `dtype` (bf16: the JAX step's `precision="bf16"`) from
        the fp32 masters; None computes in the parameters' own type."""
        self.compute_dtype = dtype
        for m in (self.module, self.mpd, self.msd):
            set_compute_dtype(m, dtype)

    def to(self, device) -> "JETSModel":
        for m in (self.module, self.mpd, self.msd):
            m.to(device)
        return self

    def g_parameters(self):
        return list(self.module.parameters())

    def d_parameters(self):
        return list(self.mpd.parameters()) + list(self.msd.parameters())

    def state_modules(self) -> Dict[str, torch.nn.Module]:
        """The modules a checkpoint holds, by name."""
        return {"module": self.module, "mpd": self.mpd, "msd": self.msd}

    def to_jax_tree(self) -> Dict[str, Any]:
        """`{'g_params', 'd_params', 'd_stats'}` as the JAX package's task
        holds them (what a `.roar` bundle stores)."""
        from roar_tpu_torch.training import convert

        return convert.jets_bundle_to_jax_tree(self.module, self.mpd, self.msd)

    def set_dropout_generator(self, generator: Optional[torch.Generator]) -> None:
        """Draw the dropout masks of training-mode forwards, and the segment
        starts, from `generator` (on the module's device)."""
        self.module.set_dropout_generator(generator)

    def attention_paths(self) -> Dict[str, str]:
        """Which attention path each FFT stack takes in training mode:
        "flash" (the kernels) or "einsum"."""
        was = self.module.training
        self.module.train()
        try:
            return {"input_fft": self.module.encoder_module.stack.attention_path(),
                    "output_fft": self.module.decoder_module.attention_path()}
        finally:
            self.module.train(was)

    # ------------------------------------------------------------------
    def _forward(self, batch, deterministic: bool = False) -> Dict[str, torch.Tensor]:
        """The module's training forward on a batch; dropout acts unless
        `deterministic`.  None outputs are left out."""
        spec, mel_lens = spec_from_batch(batch, self.mel_cfg)
        self.module.train(not deterministic)
        out = self.module(
            batch["text"].long(), pitch=batch.get("pitch"), energy=batch.get("energy"),
            speaker=batch["speaker_id"].long() if batch.get("speaker_id") is not None else None,
            spec=spec if self.learn_alignment else None,
            attn_prior=batch.get("align_prior_matrix"), mel_lens=mel_lens,
            input_lens=batch["text_len"])
        out["mel_lens"] = mel_lens
        return {k: v for k, v in out.items() if v is not None}

    def forward_split(self, batch, epoch: int = 0) -> Dict[str, torch.Tensor]:
        """The generator forward, run once per step (dropout on, as the JAX
        step's `_forward` runs it)."""
        return self._forward(batch)

    def _gt_segments(self, batch, z_start_idxs) -> torch.Tensor:
        seg = self.segment_size * self.hop_length
        # clamped so the segments stay inside the padded audio buffer
        starts = torch.clamp(z_start_idxs.long() * self.hop_length,
                             max=batch["audio"].shape[-1] - seg)
        return slice_segments(batch["audio"][:, None, :], starts, seg)[:, 0]

    def _disc_all(self, y, y_hat, update_stats: bool):
        return self.mpd(y, y_hat), self.msd(y, y_hat, update_stats=update_stats)

    def d_loss_from_out(self, out, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """LSGAN discriminator loss on (real segment, predicted segment);
        stores the spectral norm's new u and sigma."""
        audio_seg = self._gt_segments(batch, out["z_start_idxs"])
        mpd_out, msd_out = self._disc_all(audio_seg, out["wav"], update_stats=True)
        loss_mpd, _, _ = discriminator_loss(mpd_out[0], mpd_out[1])
        loss_msd, _, _ = discriminator_loss(msd_out[0], msd_out[1])
        return loss_mpd + loss_msd, {"d_loss_mpd": loss_mpd, "d_loss_msd": loss_msd}

    def g_loss_from_out(self, out, batch, epoch: int = 0
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The generator's loss (roar_tpu/models/jets_model.py:236-289)."""
        wav_pred = out["wav"]
        audio_seg = self._gt_segments(batch, out["z_start_idxs"])
        seg_len = torch.full((wav_pred.shape[0],), wav_pred.shape[-1], dtype=torch.int32,
                             device=wav_pred.device)
        mel_gt, _ = log_mel_spectrogram(audio_seg, seg_len, self.mel_cfg)
        mel_pred, _ = log_mel_spectrogram(wav_pred, seg_len, self.mel_cfg)
        l_mel = l1_mel_loss(mel_pred, mel_gt) * self.mel_loss_scale

        text_lens = batch["text_len"]
        l_dur = duration_loss(out["log_durs_predicted"], out["attn_hard_dur"], text_lens)
        loss = l_mel + l_dur
        metrics = {"g_mel_loss": l_mel, "dur_loss": l_dur}
        if out.get("pitch") is not None:
            l_pitch = pitch_loss(out["pitch_predicted"], out["pitch"], text_lens)
            loss = loss + l_pitch
            metrics["pitch_loss"] = l_pitch
        if out.get("energy_pred") is not None and out.get("energy_tgt") is not None:
            l_energy = energy_loss(out["energy_pred"], out["energy_tgt"], text_lens)
            loss = loss + l_energy
            metrics["energy_loss"] = l_energy
        if self.learn_alignment:
            ctc = forward_sum_loss(out["attn_logprob"], text_lens, out["mel_lens"],
                                   loss_scale=self.aligner_loss_scale)
            # zero at epoch 0, one from `bin_loss_warmup_epochs` on
            bin_w = min(epoch / max(self.bin_loss_warmup_epochs, 1), 1.0)
            l_bin = bin_loss(out["attn_hard"], out["attn_soft"]) * bin_w * self.aligner_loss_scale
            loss = loss + ctc + l_bin
            metrics["ctc_loss"] = ctc
            metrics["bin_loss"] = l_bin

        mpd_out, msd_out = self._disc_all(audio_seg, wav_pred, update_stats=False)
        _, mpd_fake, mpd_fr, mpd_fg = mpd_out
        _, msd_fake, msd_fr, msd_fg = msd_out
        l_fm = (feature_matching_loss(mpd_fr, mpd_fg)
                + feature_matching_loss(msd_fr, msd_fg)) * self.feature_loss_scale
        l_adv = (generator_loss(mpd_fake)[0]
                 + generator_loss(msd_fake)[0]) * self.adversarial_loss_scale
        loss = loss + l_fm + l_adv
        metrics["g_fm_loss"] = l_fm
        metrics["g_adv_loss"] = l_adv
        return loss, metrics

    def g_loss_fn(self, batch, epoch: int = 0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Generator forward and its loss, as validation reads it."""
        return self.g_loss_from_out(self.forward_split(batch, epoch), batch, epoch)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def convert_text_to_waveform(self, tokens: torch.Tensor, speaker=None, pace: float = 1.0,
                                 max_mel_len: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens [B, T_text] -> (wav [B, max_mel_len * hop], num_frames [B]),
        dropout off."""
        was = self.module.training
        self.module.eval()
        try:
            out = self.module.infer(tokens, speaker=speaker, pace=pace, max_mel_len=max_mel_len)
        finally:
            self.module.train(was)
        return out["wav"], out["num_frames"]

    def parse(self, text: str) -> np.ndarray:
        """Text -> [1, T] int32 token ids."""
        if self.tokenizer is None:
            raise ValueError("No tokenizer configured")
        return np.asarray(self.tokenizer(text), np.int32)[None]
