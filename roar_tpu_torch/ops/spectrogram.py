"""STFT / mel-spectrogram front end in PyTorch.

Port of roar_tpu/ops/spectrogram.py.  The mel filterbank and the windows are
the same numpy code (copied: the port imports nothing of the JAX package), so
both packages hold bit-identical tables.  The JAX op computes the STFT as one
windowed-DFT matrix product because the TPU has no FFT unit; here it is
`torch.stft` (cuFFT on the card) on the same reflect-padded signal with the
same window, zero-padded and centred to `n_fft`.  Framing is `Tensor.unfold`.

Tensors follow the input's device; the static tables are built once with
numpy and cached per (parameters, device).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def full_fp32_matmul():
    """Run fp32 matrix products in full fp32 on the card whatever the caller
    set: the JAX package asks for `Precision.HIGHEST` in the same places."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------------------------------------
# Mel filterbank (librosa-compatible, built host-side with numpy)
# ---------------------------------------------------------------------------


def hz_to_mel(frequencies: np.ndarray, htk: bool = False) -> np.ndarray:
    """Convert Hz to mels (slaney formula by default, as librosa)."""
    frequencies = np.asanyarray(frequencies, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + frequencies / 700.0)
    # Slaney: linear below 1 kHz, logarithmic above.
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (frequencies - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = frequencies >= min_log_hz
    mels = np.where(
        log_region,
        min_log_mel + np.log(np.maximum(frequencies, min_log_hz) / min_log_hz) / logstep,
        mels,
    )
    return mels


def mel_to_hz(mels: np.ndarray, htk: bool = False) -> np.ndarray:
    """Convert mels to Hz (inverse of :func:`hz_to_mel`)."""
    mels = np.asanyarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = mels >= min_log_mel
    freqs = np.where(
        log_region,
        min_log_hz * np.exp(logstep * (np.where(log_region, mels, min_log_mel) - min_log_mel)),
        freqs,
    )
    return freqs


def mel_frequencies(n_mels: int, fmin: float, fmax: float, htk: bool = False) -> np.ndarray:
    mels = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels)
    return mel_to_hz(mels, htk)


def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    norm: Optional[str] = "slaney",
    htk: bool = False,
    dtype: np.dtype = np.float32,
) -> np.ndarray:
    """Triangular mel filterbank, [n_mels, 1 + n_fft // 2].

    Matches ``librosa.filters.mel`` (consumed by the reference at
    features.py:298-308) including slaney area normalization.
    """
    if fmax is None:
        fmax = float(sample_rate) / 2
    n_freqs = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, float(sample_rate) / 2, n_freqs)
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax, htk)

    fdiff = np.diff(mel_f)
    ramps = mel_f.reshape(-1, 1) - fftfreqs.reshape(1, -1)

    lower = -ramps[:-2] / fdiff[:-1].reshape(-1, 1)
    upper = ramps[2:] / fdiff[1:].reshape(-1, 1)
    weights = np.maximum(0.0, np.minimum(lower, upper))

    if norm == "slaney":
        enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
        weights *= enorm.reshape(-1, 1)
    elif norm is not None:
        raise ValueError(f"Unsupported mel norm: {norm!r}")

    return weights.astype(dtype)


# ---------------------------------------------------------------------------
# Windows
# ---------------------------------------------------------------------------

_WINDOW_FNS = {}


def _register_window(name):
    def deco(fn):
        _WINDOW_FNS[name] = fn
        return fn

    return deco


def _cosine_sum_window(coeffs, win_length: int) -> np.ndarray:
    """Symmetric generalized-cosine window (periodic=False torch semantics)."""
    if win_length == 1:
        return np.ones(1)
    n = np.arange(win_length, dtype=np.float64)
    x = 2 * np.pi * n / (win_length - 1)
    out = np.zeros(win_length)
    for k, a in enumerate(coeffs):
        out += a * np.cos(k * x) * ((-1) ** k)
    return out


@_register_window("hann")
def _hann(win_length):
    return _cosine_sum_window([0.5, 0.5], win_length)


@_register_window("hamming")
def _hamming(win_length):
    # torch.hamming_window defaults: alpha=0.54, beta=0.46
    return _cosine_sum_window([0.54, 0.46], win_length)


@_register_window("blackman")
def _blackman(win_length):
    return _cosine_sum_window([0.42, 0.5, 0.08], win_length)


@_register_window("bartlett")
def _bartlett(win_length):
    n = np.arange(win_length, dtype=np.float64)
    return 1.0 - np.abs(2.0 * n / (win_length - 1) - 1.0)


@_register_window("none")
def _rect(win_length):
    return np.ones(win_length)


def get_window(window: str, win_length: int) -> np.ndarray:
    """Symmetric window matching torch.hann_window(periodic=False) et al.

    (features.py:267-277 builds the same symmetric windows.)
    """
    if window not in _WINDOW_FNS:
        raise ValueError(f"Unsupported window {window!r}; options: {sorted(_WINDOW_FNS)}")
    return _WINDOW_FNS[window](win_length)


# ---------------------------------------------------------------------------
# Framed STFT
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def _padded_window_np(n_fft: int, win_length: int, window: str) -> np.ndarray:
    """The window zero-padded and centred to n_fft, float32 [n_fft] (the
    window column of roar_tpu's `_windowed_dft_matrix`)."""
    win = np.zeros(n_fft)
    left = (n_fft - win_length) // 2
    win[left : left + win_length] = get_window(window, win_length)
    return win.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _padded_window(n_fft: int, win_length: int, window: str, device: str) -> torch.Tensor:
    return torch.from_numpy(_padded_window_np(n_fft, win_length, window)).to(device)


@functools.lru_cache(maxsize=32)
def _filterbank(cfg: "MelConfig", device: str) -> torch.Tensor:
    return torch.from_numpy(cfg.filterbank()).to(device)


def stft_frame_count(num_samples, n_fft: int, hop_length: int, pad_amount: int):
    """floor((len + 2*pad - n_fft)/hop) + 1, for ints, arrays and tensors."""
    return (num_samples + 2 * pad_amount - n_fft) // hop_length + 1


def _reflect_pad_1d(x: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0, :]


def frame_signal(x: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """[B, S] (already padded) -> [B, T, n_fft] overlapping frames (a view)."""
    return x.unfold(-1, n_fft, hop_length)


def stft_magnitude(
    x: torch.Tensor,
    n_fft: int,
    hop_length: int,
    win_length: int,
    window: str = "hann",
    center: bool = True,
    exact_pad: bool = False,
    mag_eps: float = 0.0,
) -> torch.Tensor:
    """Magnitude STFT, [B, n_freqs, T].

    center=True reflect-pads n_fft//2 both sides; exact_pad reflect-pads
    (n_fft - hop)//2 with center=False.  `mag_eps` is the sqrt guard used
    when gradients flow through.
    """
    if x.dim() == 1:
        x = x[None]
    if exact_pad:
        x = _reflect_pad_1d(x, (n_fft - hop_length) // 2)
    elif center:
        x = _reflect_pad_1d(x, n_fft // 2)
    win = _padded_window(n_fft, win_length, window, str(x.device))
    spec = torch.stft(x, n_fft, hop_length=hop_length, win_length=n_fft, window=win,
                      center=False, return_complex=True)  # [B, F, T]
    return torch.sqrt(spec.real.square() + spec.imag.square() + mag_eps)


# ---------------------------------------------------------------------------
# Log-mel front end
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MelConfig:
    """The fields and defaults of roar_tpu.ops.spectrogram.MelConfig."""

    sample_rate: int = 16000
    n_window_size: int = 320
    n_window_stride: int = 160
    window: str = "hann"
    normalize: Optional[str] = "per_feature"
    n_fft: Optional[int] = None
    preemph: Optional[float] = 0.97
    nfilt: int = 64
    lowfreq: float = 0.0
    highfreq: Optional[float] = None
    log: bool = True
    log_zero_guard_type: str = "add"
    log_zero_guard_value: float = 2 ** -24
    dither: float = 1e-5
    pad_to: int = 16
    exact_pad: bool = False
    pad_value: float = 0.0
    mag_power: float = 2.0
    mel_norm: Optional[str] = "slaney"
    use_grads: bool = False

    def __post_init__(self):
        if self.exact_pad and self.n_window_stride % 2 == 1:
            raise ValueError("exact_pad requires an even hop size")
        if self.log_zero_guard_type not in ("add", "clamp"):
            raise ValueError(f"bad log_zero_guard_type {self.log_zero_guard_type!r}")

    @property
    def win_length(self) -> int:
        return self.n_window_size

    @property
    def hop_length(self) -> int:
        return self.n_window_stride

    @property
    def fft_length(self) -> int:
        return self.n_fft or 2 ** math.ceil(math.log2(self.win_length))

    @property
    def pad_amount(self) -> int:
        if self.exact_pad:
            return (self.fft_length - self.hop_length) // 2
        return self.fft_length // 2

    def get_seq_len(self, num_samples):
        return stft_frame_count(num_samples, self.fft_length, self.hop_length, self.pad_amount)

    def filterbank(self) -> np.ndarray:
        return mel_filterbank(
            self.sample_rate,
            self.fft_length,
            self.nfilt,
            fmin=self.lowfreq,
            fmax=self.highfreq or self.sample_rate / 2.0,
            norm=self.mel_norm,
        )


def preemphasis(x: torch.Tensor, coeff: float) -> torch.Tensor:
    """x[t] - coeff * x[t-1], first sample kept."""
    return torch.cat([x[..., :1], x[..., 1:] - coeff * x[..., :-1]], dim=-1)


def normalize_batch(
    x: torch.Tensor, seq_len: torch.Tensor, normalize_type: str, eps: float = 1e-5
) -> torch.Tensor:
    """Per-utterance feature normalization over valid frames (unbiased std,
    +1e-5 guard).  x: [B, C, T]; seq_len: [B]."""
    if normalize_type not in ("per_feature", "all_features"):
        raise ValueError(f"Unsupported normalize_type: {normalize_type!r}")
    t = x.shape[-1]
    mask = (torch.arange(t, device=x.device)[None, :] < seq_len[:, None]).to(x.dtype)[:, None, :]
    cnt = torch.clamp(seq_len.to(x.dtype), min=1.0)
    dims = (-1,)
    if normalize_type == "all_features":
        cnt, dims = cnt * x.shape[1], (1, 2)
    cnt = cnt[:, None, None]
    mean = torch.sum(x * mask, dim=dims, keepdim=True) / cnt
    var = torch.sum(torch.square(x - mean) * mask, dim=dims, keepdim=True)
    std = torch.sqrt(var / torch.clamp(cnt - 1.0, min=1.0))
    return (x - mean) / (std + eps)


def log_mel_spectrogram(
    audio: torch.Tensor,
    audio_lens: torch.Tensor,
    cfg: MelConfig,
    *,
    training: bool = False,
    dither_generator: Optional[torch.Generator] = None,
    linear_spec: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """wav -> (log-)mel spectrogram: dither -> preemphasis -> STFT magnitude
    -> power -> mel product -> log guard -> normalize -> mask + pad_to.
    Returns ([B, nfilt, T], [B] frame lengths).  Dither is drawn only in
    training and only from an explicit `dither_generator`."""
    if audio.dim() == 1:
        audio = audio[None]
    x = audio.float()
    seq_len = cfg.get_seq_len(audio_lens.to(x.device))

    if training and cfg.dither > 0 and dither_generator is not None:
        noise = torch.randn(x.shape, dtype=x.dtype, device=x.device, generator=dither_generator)
        x = x + cfg.dither * noise

    if cfg.preemph is not None:
        x = preemphasis(x, cfg.preemph)

    mag = stft_magnitude(
        x,
        n_fft=cfg.fft_length,
        hop_length=cfg.hop_length,
        win_length=cfg.win_length,
        window=cfg.window,
        center=not cfg.exact_pad,
        exact_pad=cfg.exact_pad,
        mag_eps=1e-5 if cfg.use_grads else 0.0,
    )  # [B, F, T]

    if cfg.mag_power != 1.0:
        mag = torch.pow(mag, cfg.mag_power)

    if linear_spec:
        return mag, seq_len

    with full_fp32_matmul():
        mel = torch.matmul(_filterbank(cfg, str(x.device)), mag)  # [B, nfilt, T]

    if cfg.log:
        if cfg.log_zero_guard_type == "add":
            mel = torch.log(mel + cfg.log_zero_guard_value)
        else:
            mel = torch.log(torch.clamp(mel, min=cfg.log_zero_guard_value))

    if cfg.normalize:
        mel = normalize_batch(mel, seq_len, cfg.normalize)

    # mask beyond seq_len, then pad the time axis to a multiple of pad_to
    t = mel.shape[-1]
    mask = torch.arange(t, device=x.device)[None, None, :] < seq_len[:, None, None]
    mel = torch.where(mask, mel, cfg.pad_value)
    if isinstance(cfg.pad_to, int) and cfg.pad_to > 0 and t % cfg.pad_to != 0:
        mel = F.pad(mel, (0, cfg.pad_to - t % cfg.pad_to), value=cfg.pad_value)
    return mel, seq_len


def frame_energy(audio: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """Per-frame energy = L2 norm of the magnitude STFT over frequency
    (no preemphasis, no power), [B, T]."""
    mag = stft_magnitude(
        audio,
        n_fft=cfg.fft_length,
        hop_length=cfg.hop_length,
        win_length=cfg.win_length,
        window=cfg.window,
        center=True,
    )
    return torch.sqrt(torch.sum(torch.square(mag), dim=1))
