"""Audio IO without external deps: WAV read/write + polyphase resampling.

The port's copy of roar_tpu/data/audio.py (host code, numpy/scipy only):
read, channel-select, resample and trim.  The JAX package's optional native
WAV decoder is not carried over; `read_wav` goes through scipy.
"""

from __future__ import annotations

import dataclasses
import wave
from typing import Optional

import numpy as np


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file to float32 in [-1, 1]; returns (samples [S] or [S, C], sr)."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    return data, int(sr)


def write_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """Write float32 [-1, 1] samples as 16-bit PCM."""
    samples = np.clip(np.asarray(samples), -1.0, 1.0)
    pcm = (samples * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as f:
        f.setnchannels(1 if pcm.ndim == 1 else pcm.shape[1])
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (scipy.signal.resample_poly)."""
    if orig_sr == target_sr:
        return audio
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(orig_sr, target_sr)
    return resample_poly(audio, target_sr // g, orig_sr // g).astype(np.float32)


def trim_silence(
    audio: np.ndarray,
    sample_rate: int,
    threshold_db: float = 60.0,
    frame_length: int = 2048,
    hop_length: int = 512,
) -> np.ndarray:
    """Energy-based leading/trailing silence trim (librosa.effects.trim
    semantics: drop frames more than `threshold_db` below the peak)."""
    if audio.size == 0:
        return audio
    n = 1 + max(0, (len(audio) - frame_length)) // hop_length
    if n == 0:
        return audio
    idx = np.arange(n)[:, None] * hop_length + np.arange(frame_length)[None, :]
    idx = np.minimum(idx, len(audio) - 1)
    frames = audio[idx]
    rms = np.sqrt(np.mean(np.square(frames), axis=-1))
    ref = rms.max()
    if ref <= 0:
        return audio
    keep = rms > ref * (10.0 ** (-threshold_db / 20.0))
    if not keep.any():
        return audio[:0]
    first, last = np.argmax(keep), len(keep) - 1 - np.argmax(keep[::-1])
    start = first * hop_length
    end = min(last * hop_length + frame_length, len(audio))
    return audio[start:end]


@dataclasses.dataclass
class AudioSegment:
    """A mono float32 audio buffer + sample rate."""

    samples: np.ndarray
    sample_rate: int

    @classmethod
    def from_file(
        cls,
        path: str,
        target_sr: Optional[int] = None,
        offset: float = 0.0,
        duration: Optional[float] = None,
        trim: bool = False,
        trim_db: float = 60.0,
        channel_selector: Optional[int] = None,
    ) -> "AudioSegment":
        data, sr = read_wav(path)
        if data.ndim == 2:
            data = data[:, channel_selector] if channel_selector is not None else data.mean(axis=1)
        if offset > 0:
            data = data[int(offset * sr):]
        if duration is not None:
            data = data[: int(duration * sr)]
        if target_sr is not None and target_sr != sr:
            data = resample(data, sr, target_sr)
            sr = target_sr
        if trim:
            data = trim_silence(data, sr, threshold_db=trim_db)
        return cls(samples=np.ascontiguousarray(data, dtype=np.float32), sample_rate=sr)

    @property
    def num_samples(self) -> int:
        return int(self.samples.shape[0])

    @property
    def duration(self) -> float:
        return self.num_samples / self.sample_rate
