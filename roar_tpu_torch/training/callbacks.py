"""Validation artifacts: spectrogram, alignment and pitch plots, and audio
previews.

Port of roar_tpu/training/callbacks.py.  The plots are matplotlib figures
written under the run directory; each helper returns None when matplotlib
does not import.  `FastPitchArtifactGenerator` also writes a Griffin-Lim
preview WAV of the predicted mel (`ops/griffin_lim.py`, 30 iterations);
like the JAX package it swallows any failure of that preview, so a caller
that needs the WAV checks that the file was written.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def _pyplot():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    return plt


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def plot_spectrogram_to_file(spec: np.ndarray, path: str, title: str = "") -> Optional[str]:
    """spec: [n_mel, T].  Returns path, or None without matplotlib."""
    plt = _pyplot()
    if plt is None:
        return None
    fig, ax = plt.subplots(figsize=(10, 3))
    im = ax.imshow(spec, aspect="auto", origin="lower", interpolation="none")
    fig.colorbar(im, ax=ax)
    ax.set_title(title)
    ax.set_xlabel("frames")
    ax.set_ylabel("mel bins")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


def plot_alignment_to_file(attn: np.ndarray, path: str, title: str = "alignment") -> Optional[str]:
    """attn: [T_mel, T_text]."""
    plt = _pyplot()
    if plt is None:
        return None
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.imshow(attn.T, aspect="auto", origin="lower", interpolation="none")
    ax.set_title(title)
    ax.set_xlabel("mel frames")
    ax.set_ylabel("text tokens")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


def plot_pitch_to_file(pitch: np.ndarray, path: str, title: str = "pitch") -> Optional[str]:
    plt = _pyplot()
    if plt is None:
        return None
    fig, ax = plt.subplots(figsize=(10, 2.5))
    ax.plot(pitch)
    ax.set_title(title)
    ax.set_xlabel("frames")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


def plot_multipitch_to_file(pitch_gt: np.ndarray, pitch_pred: np.ndarray, path: str,
                            title: str = "pitch (gt vs pred)", ylim_range=None) -> Optional[str]:
    """Ground-truth and predicted pitch contours overlaid; the path, or None
    without matplotlib."""
    plt = _pyplot()
    if plt is None:
        return None
    fig, ax = plt.subplots(figsize=(12, 3))
    ax.plot(np.asarray(pitch_gt), label="gt", alpha=0.8)
    ax.plot(np.asarray(pitch_pred), label="pred", alpha=0.8)
    if ylim_range is not None:
        ax.set_ylim(ylim_range)
    ax.set_xlabel("frames")
    ax.set_ylabel("pitch")
    ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


class FastPitchArtifactGenerator:
    """Every `log_every_epochs`: the predicted spectrogram, the alignment and
    the pitch as images, and with `audio_preview` and a `mel_cfg` a
    Griffin-Lim preview WAV."""

    def __init__(self, out_dir: str, log_every_epochs: int = 5, audio_preview: bool = True,
                 mel_cfg=None):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.log_every_epochs = log_every_epochs
        self.audio_preview = audio_preview
        self.mel_cfg = mel_cfg

    def __call__(self, epoch: int, outputs: Dict[str, Any], batch: Dict[str, Any]) -> List[str]:
        if epoch % self.log_every_epochs != 0:
            return []
        written = []
        spect = outputs["spect"]  # [B, T, n_mel]
        p = self.out_dir / f"epoch{epoch:05d}_spec_pred.png"
        if plot_spectrogram_to_file(_host(spect)[0].T, str(p), "predicted mel"):
            written.append(str(p))
        if outputs.get("attn_soft") is not None:
            p = self.out_dir / f"epoch{epoch:05d}_alignment.png"
            if plot_alignment_to_file(_host(outputs["attn_soft"])[0, 0], str(p)):
                written.append(str(p))
        if outputs.get("pitch_predicted") is not None:
            p = self.out_dir / f"epoch{epoch:05d}_pitch.png"
            if plot_pitch_to_file(_host(outputs["pitch_predicted"])[0], str(p)):
                written.append(str(p))
        if self.audio_preview and self.mel_cfg is not None:
            try:
                from roar_tpu_torch.data.audio import write_wav
                from roar_tpu_torch.ops.griffin_lim import mel_to_audio_griffin_lim

                cfg = self.mel_cfg
                mel = torch.as_tensor(spect[:1]).float().transpose(1, 2)
                audio = mel_to_audio_griffin_lim(
                    mel, sample_rate=cfg.sample_rate, n_fft=cfg.fft_length,
                    hop_length=cfg.hop_length, win_length=cfg.win_length, n_mels=cfg.nfilt,
                    fmin=cfg.lowfreq, fmax=cfg.highfreq, n_iters=30)
                p = self.out_dir / f"epoch{epoch:05d}_preview.wav"
                write_wav(str(p), _host(audio)[0], cfg.sample_rate)
                written.append(str(p))
            except Exception:
                pass
        return written


class VocoderArtifactGenerator:
    """Ground-truth and generated audio pairs as WAVs, every
    `log_every_epochs`."""

    def __init__(self, out_dir: str, sample_rate: int, log_every_epochs: int = 5):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.sample_rate = sample_rate
        self.log_every_epochs = log_every_epochs

    def __call__(self, epoch: int, audio_real, audio_gen) -> List[str]:
        if epoch % self.log_every_epochs != 0:
            return []
        from roar_tpu_torch.data.audio import write_wav

        written = []
        for name, wav in (("real", audio_real), ("gen", audio_gen)):
            p = self.out_dir / f"epoch{epoch:05d}_{name}.wav"
            write_wav(str(p), _host(wav)[0], self.sample_rate)
            written.append(str(p))
        return written
