"""Inverse STFT and Griffin-Lim phase reconstruction, in fp32.

Port of roar_tpu/ops/griffin_lim.py: `istft` (the inverse real DFT of each
frame, windowed, overlap-added and divided by the overlap-added squared
window, `center=True` framing), `griffin_lim` (iterated STFT / inverse STFT
round trips keeping the given magnitudes) and `mel_to_audio_griffin_lim`
(log-mel -> linear magnitudes through the filterbank's pseudo-inverse, then
Griffin-Lim).  The JAX op forms the DFTs as matrix products for the TPU;
here they are `torch.fft.irfft` and `torch.stft`, and the overlap-add is
`F.fold`.

The starting phase: the JAX function draws it from
`jax.random.uniform(PRNGKey(0), ...)`, a stream torch cannot reproduce.
`phase` takes it from the caller; by default it is drawn uniform in
[-pi, pi) on the host from a `torch.Generator` seeded with 0.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from roar_tpu_torch.ops.spectrogram import _padded_window, _reflect_pad_1d, mel_filterbank


def _overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """[B, T, n] frames -> [B, n + hop * (T - 1)] summed where they overlap."""
    b, t, n = frames.shape
    out_len = n + hop_length * (t - 1)
    return F.fold(frames.transpose(1, 2), output_size=(1, out_len), kernel_size=(1, n),
                  stride=(1, hop_length))[:, 0, 0]


def istft(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
          window: str = "hann", length: Optional[int] = None) -> torch.Tensor:
    """Inverse STFT with overlap-add; re / im [B, F, T] (center=True framing).
    Returns [B, length or T * hop] audio."""
    t = re.shape[2]
    frames = torch.fft.irfft(torch.complex(re, im).transpose(1, 2), n=n_fft)  # [B, T, n_fft]
    win = _padded_window(n_fft, win_length, window, str(re.device))
    audio = _overlap_add(frames * win, hop_length)
    wsq = _overlap_add((win * win).expand(1, t, n_fft), hop_length)
    audio = audio / torch.clamp(wsq, min=1e-8)
    pad = n_fft // 2
    audio = audio[:, pad: audio.shape[1] - pad]
    if length is not None:
        if audio.shape[1] < length:  # zero-filled to `length`, as torch.istft does
            audio = F.pad(audio, (0, length - audio.shape[1]))
        audio = audio[:, :length]
    return audio


def _stft_complex(x: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
                  window: str, t: int):
    """(re, im) [B, F, t] of the reflect-padded, windowed STFT of x."""
    win = _padded_window(n_fft, win_length, window, str(x.device))
    spec = torch.stft(_reflect_pad_1d(x, n_fft // 2), n_fft, hop_length=hop_length,
                      win_length=n_fft, window=win, center=False, return_complex=True)
    return spec.real[:, :, :t], spec.imag[:, :, :t]


def default_phase(shape, device=None) -> torch.Tensor:
    """The starting phase `griffin_lim` draws when given none: uniform in
    [-pi, pi), from a CPU generator seeded with 0."""
    u = torch.rand(tuple(shape), generator=torch.Generator().manual_seed(0))
    return (u * (2 * np.pi) - np.pi).to(device)


def griffin_lim(magnitudes: torch.Tensor, n_iters: int = 50, n_fft: int = 1024,
                hop_length: Optional[int] = None, win_length: Optional[int] = None,
                window: str = "hann", phase: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Magnitude spectrogram [B, F, T] -> audio via Griffin-Lim, starting
    from `phase` [B, F, T] (`default_phase` when None)."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    magnitudes = magnitudes.float()
    t = magnitudes.shape[2]
    if phase is None:
        phase = default_phase(magnitudes.shape, magnitudes.device)
    phase = phase.to(magnitudes.device, torch.float32)
    re, im = magnitudes * torch.cos(phase), magnitudes * torch.sin(phase)
    for _ in range(n_iters):
        audio = istft(re, im, n_fft, hop_length, win_length, window)
        re2, im2 = _stft_complex(audio, n_fft, hop_length, win_length, window, t)
        mag = torch.sqrt(re2 * re2 + im2 * im2 + 1e-12)
        scale = magnitudes / torch.clamp(mag, min=1e-8)
        re, im = re2 * scale, im2 * scale
    return istft(re, im, n_fft, hop_length, win_length, window)


def mel_to_audio_griffin_lim(log_mel: torch.Tensor, sample_rate: int, n_fft: int,
                             hop_length: int, win_length: int, n_mels: int, fmin: float = 0.0,
                             fmax: Optional[float] = None, log_zero_guard: float = 1e-5,
                             n_iters: int = 50, phase: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """log-mel [B, n_mels, T] -> audio preview: the filterbank's
    pseudo-inverse, then Griffin-Lim."""
    fb = mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax)  # [M, F]
    pinv = torch.from_numpy(np.linalg.pinv(fb)).to(log_mel.device)  # [F, M]
    mel_lin = torch.exp(log_mel.float()) - log_zero_guard
    mag = torch.clamp(torch.einsum("fm,bmt->bft", pinv, torch.clamp(mel_lin, min=0.0)), min=0.0)
    return griffin_lim(mag, n_iters=n_iters, n_fft=n_fft, hop_length=hop_length,
                       win_length=win_length, phase=phase)
