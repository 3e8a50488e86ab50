"""HiFi-GAN vocoder task: config -> generator, discriminators, losses.

Port of roar_tpu/models/hifigan_model.py.  `generator_from_config` and
`vocoder_from_config` build the folded serving generator; `HifiGanModel`
is the GAN training task: the mel front end (exact_pad, clamp guard,
gradients through the predicted-audio branch), the generator in its
trainable `(v, scale)` form, MPD and MSD, and the D and G losses that
training/gan.py steps.  The modules hold their own parameters, so the loss
functions take tensors only.

`compute_stft_bias` and `denoise` subtract the generator's bias spectrum
through `ops/griffin_lim.istft`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from roar_tpu_torch.losses.hifigan_losses import (
    discriminator_loss,
    feature_matching_loss,
    generator_loss,
    l1_mel_loss,
)
from roar_tpu_torch.models.hifigan import (
    Generator,
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
)
from roar_tpu_torch.models.submodules import set_compute_dtype
from roar_tpu_torch.ops.spectrogram import MelConfig, log_mel_spectrogram


def preprocessor_config(cfg: Dict[str, Any]) -> MelConfig:
    """A preprocessor YAML block (configs/hifigan_22050.yaml `model.preprocessor`)
    as a MelConfig; the defaults are roar_tpu's `preprocessor_config`."""
    lzgv = cfg.get("log_zero_guard_value", 2 ** -24)
    if isinstance(lzgv, str):
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


def _generator_kwargs(cfg: Dict[str, Any], initial_input_size: int) -> Dict[str, Any]:
    return dict(
        resblock=cfg.get("resblock", 1),
        upsample_rates=tuple(cfg.get("upsample_rates", (8, 8, 2, 2))),
        upsample_kernel_sizes=tuple(cfg.get("upsample_kernel_sizes", (16, 16, 4, 4))),
        upsample_initial_channel=cfg.get("upsample_initial_channel", 512),
        resblock_kernel_sizes=tuple(cfg.get("resblock_kernel_sizes", (3, 7, 11))),
        resblock_dilation_sizes=tuple(
            tuple(d) for d in cfg.get("resblock_dilation_sizes", ((1, 3, 5),) * 3)),
        initial_input_size=cfg.get("initial_input_size", initial_input_size),
    )


def generator_from_config(cfg: Dict[str, Any], initial_input_size: int = 80) -> Generator:
    """Build a Generator from a generator YAML block
    (configs/hifigan/generator/v1.yaml keys)."""
    return Generator(**_generator_kwargs(cfg, initial_input_size)).eval()


def vocoder_from_config(cfg: Dict[str, Any]) -> Generator:
    """The generator of a HiFi-GAN task config (the `model` block of
    configs/hifigan_22050.yaml), fed mels of the preprocessor's width."""
    pre = cfg.get("preprocessor") or {}
    n_mel = pre.get("features", pre.get("nfilt", 64))  # roar_tpu's preprocessor_config default
    return generator_from_config(cfg.get("generator") or {}, n_mel)


class HifiGanModel:
    """The GAN vocoder task.  `cfg` is the `model` block of
    configs/hifigan_22050.yaml; `generator` seeds the parameter init (normal
    0.01 for conv kernels, normal for the spectral norm's u)."""

    def __init__(self, cfg: Dict[str, Any], generator: Optional[torch.Generator] = None):
        self.cfg = cfg
        pre = dict(cfg.get("preprocessor") or {})
        self.mel_cfg = dataclasses.replace(preprocessor_config(pre), use_grads=True)
        # the L1 mel loss compares full-band mels (highfreq=None -> Nyquist)
        # even when the generator's input mel is capped
        self.trg_mel_cfg = dataclasses.replace(self.mel_cfg, highfreq=None)
        self.generator = Generator(
            **_generator_kwargs(cfg.get("generator") or {}, self.mel_cfg.nfilt),
            weight_norm=True, generator=generator)
        debug = cfg.get("debug", False)
        self.mpd = MultiPeriodDiscriminator(debug=debug, generator=generator)
        self.msd = MultiScaleDiscriminator(debug=debug, variant=cfg.get("msd_variant", "grouped"),
                                           generator=generator)
        self.l1_factor = cfg.get("l1_loss_factor", 45)
        self.compute_dtype: Optional[torch.dtype] = None

    def set_compute_dtype(self, dtype: Optional[torch.dtype]) -> None:
        """Compute in `dtype` (bf16: the JAX step's `precision="bf16"`) from
        the fp32 masters; None computes in the parameters' own type."""
        self.compute_dtype = dtype
        for m in (self.generator, self.mpd, self.msd):
            set_compute_dtype(m, dtype)

    def to(self, device) -> "HifiGanModel":
        for m in (self.generator, self.mpd, self.msd):
            m.to(device)
        return self

    def to_jax_tree(self) -> Dict[str, Any]:
        """`{'g_params', 'd_params', 'd_stats'}` as the JAX package's task
        holds them (what a `.roar` bundle stores)."""
        from roar_tpu_torch.training import convert

        return convert.to_jax_tree(self.generator, self.mpd, self.msd)

    def state_modules(self) -> Dict[str, torch.nn.Module]:
        """The modules a checkpoint holds, by name."""
        return {"generator": self.generator, "mpd": self.mpd, "msd": self.msd}

    def g_parameters(self):
        return list(self.generator.parameters())

    def d_parameters(self):
        return list(self.mpd.parameters()) + list(self.msd.parameters())

    # ------------------------------------------------------------------
    def _mel(self, audio, lens, cfg: Optional[MelConfig] = None):
        mel, mel_lens = log_mel_spectrogram(audio, lens, cfg or self.mel_cfg)
        return mel.transpose(1, 2), mel_lens

    def _input_mel(self, batch) -> torch.Tensor:
        """The generator's input mel [B, T, n_mel]: a precomputed `mel` in
        the batch wins (fine-tuning on predicted mels), else it is computed
        from the audio, in fp32 (the front end widens the audio).  Either is
        cast to the compute type, so that an fp32 mel does not promote the
        generator out of bf16 (roar_tpu/models/hifigan_model.py:114-135)."""
        mel = batch.get("mel")
        if mel is None:
            mel = self._mel(batch["audio"], batch["audio_len"])[0]
        return mel if self.compute_dtype is None else mel.to(self.compute_dtype)

    def forward_split(self, batch, epoch: int = 0) -> Dict[str, torch.Tensor]:
        """The generator forward, run once per step (`epoch` is not read)."""
        return {"fake": self.generator(self._input_mel(batch))}

    def _disc_all(self, y, y_hat, update_stats: bool):
        return self.mpd(y, y_hat), self.msd(y, y_hat, update_stats=update_stats)

    def d_loss_from_out(self, diff_out, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """LSGAN discriminator loss on (real, fake); stores the spectral
        norm's new u and sigma (`update_stats=True`)."""
        mpd_out, msd_out = self._disc_all(batch["audio"], diff_out["fake"], update_stats=True)
        loss_mpd, _, _ = discriminator_loss(mpd_out[0], mpd_out[1])
        loss_msd, _, _ = discriminator_loss(msd_out[0], msd_out[1])
        return loss_mpd + loss_msd, {"d_loss_mpd": loss_mpd, "d_loss_msd": loss_msd}

    def g_loss_from_out(self, diff_out, batch, epoch: int = 0
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """L1 mel x l1_loss_factor on the full-band mels of the ground-truth
        and generated audio, feature matching, LSGAN generator loss (`epoch`
        is not read)."""
        audio, lens, fake = batch["audio"], batch["audio_len"], diff_out["fake"]
        mel_gt, _ = self._mel(audio, lens, self.trg_mel_cfg)
        mel_fake, _ = self._mel(fake, lens, self.trg_mel_cfg)
        l_mel = l1_mel_loss(mel_fake, mel_gt) * self.l1_factor
        mpd_out, msd_out = self._disc_all(audio, fake, update_stats=False)
        _, mpd_fake, mpd_fr, mpd_fg = mpd_out
        _, msd_fake, msd_fr, msd_fg = msd_out
        l_fm = feature_matching_loss(mpd_fr, mpd_fg) + feature_matching_loss(msd_fr, msd_fg)
        l_adv = generator_loss(mpd_fake)[0] + generator_loss(msd_fake)[0]
        loss = l_mel + l_fm + l_adv
        return loss, {"g_mel_loss": l_mel, "g_fm_loss": l_fm, "g_adv_loss": l_adv}

    def g_loss_fn(self, batch, epoch: int = 0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Generator forward and its loss, as validation reads it."""
        return self.g_loss_from_out(self.forward_split(batch), batch)

    # ------------------------------------------------------------------
    def convert_spectrogram_to_audio(self, spec: torch.Tensor) -> torch.Tensor:
        """mel [B, T, n_mel] -> audio [B, T * upsample]."""
        with torch.no_grad():
            return self.generator(spec)

    @torch.no_grad()
    def compute_stft_bias(self) -> torch.Tensor:
        """The generator's bias magnitude spectrum [1, F, 1]: |STFT| of its
        output on a zero mel of 88 frames, first frame
        (roar_tpu/models/hifigan_model.py:240-254)."""
        from roar_tpu_torch.ops.spectrogram import stft_magnitude

        device = next(self.generator.parameters()).device
        zero_mel = torch.zeros(1, 88, self.mel_cfg.nfilt, device=device)
        mag = stft_magnitude(self.generator(zero_mel), n_fft=self.mel_cfg.fft_length,
                             hop_length=self.mel_cfg.hop_length,
                             win_length=self.mel_cfg.win_length, window=self.mel_cfg.window,
                             center=True)
        return mag[:, :, 0:1]

    @torch.no_grad()
    def denoise(self, audio: torch.Tensor, strength: float = 0.0025,
                stft_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Subtract `strength` times the generator's bias spectrum from the
        magnitudes of `audio` [B, S], clipped at 0, phase kept
        (roar_tpu/models/hifigan_model.py:256-289)."""
        from roar_tpu_torch.ops.griffin_lim import _stft_complex, istft

        if stft_bias is None:
            stft_bias = self.compute_stft_bias()
        cfg = self.mel_cfg
        n_fft, hop, win = cfg.fft_length, cfg.hop_length, cfg.win_length
        t = audio.shape[-1] // hop + 1
        re, im = _stft_complex(audio.float(), n_fft, hop, win, cfg.window, t)
        mag = torch.sqrt(re * re + im * im + 1e-12)
        new_mag = torch.clamp(mag - strength * stft_bias, min=0.0)
        scale = new_mag / torch.clamp(mag, min=1e-8)
        return istft(re * scale, im * scale, n_fft, hop, win, cfg.window, length=audio.shape[-1])
