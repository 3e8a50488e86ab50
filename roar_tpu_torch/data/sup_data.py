"""Supplementary-data (sup-data) extraction on the card.

Port of roar_tpu/data/sup_data.py: log-mel, pYIN pitch (with voiced mask and
probability) and frame energy as one batched device function over padded
audio buckets; the host does only WAV IO and cache writes.  Buckets, the
`.npy` cache layout and the file names are the JAX package's, so either
package reads what the other wrote.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from roar_tpu_torch.ops.pyin import PyinConfig, pyin
from roar_tpu_torch.ops.spectrogram import MelConfig, frame_energy, log_mel_spectrogram

# Sup-data type names (roar_tpu/data/sup_data.py:28).
SUP_DATA_TYPES = (
    "log_mel",
    "durations",
    "align_prior_matrix",
    "pitch",
    "energy",
    "speaker_id",
    "voiced_mask",
    "p_voiced",
    "reference_audio",
)
CACHED_KINDS = ("pitch", "energy", "voiced_mask", "p_voiced")


@dataclasses.dataclass(frozen=True)
class SupDataConfig:
    """Audio/feature parameters shared by dataset + extractor; the field
    names are the YAML configs' dataset keys."""

    sample_rate: int = 22050
    n_fft: int = 2048
    win_length: int = 2048
    hop_length: int = 512
    window: str = "hann"
    n_mels: int = 80
    lowfreq: float = 0.0
    highfreq: Optional[float] = 8000.0
    pitch_fmin: float = 65.40639132514966
    pitch_fmax: float = 2093.004522404789

    def mel_config(self) -> MelConfig:
        # plain |STFT| -> slaney mel -> log(x + 1e-5); no preemph/dither/norm
        return MelConfig(
            sample_rate=self.sample_rate,
            n_window_size=self.win_length,
            n_window_stride=self.hop_length,
            window=self.window,
            n_fft=self.n_fft,
            nfilt=self.n_mels,
            lowfreq=self.lowfreq,
            highfreq=self.highfreq,
            preemph=None,
            normalize=None,
            mag_power=1.0,
            log=True,
            log_zero_guard_type="add",
            log_zero_guard_value=1e-5,
            dither=0.0,
            pad_to=1,
        )

    def pyin_config(self) -> PyinConfig:
        # librosa.pyin(frame_length=win_length, sr, fmin, fmax, fill_na=0):
        # the hop defaults to frame_length // 4
        return PyinConfig(
            sample_rate=self.sample_rate,
            fmin=self.pitch_fmin,
            fmax=self.pitch_fmax,
            frame_length=self.win_length,
            hop_length=None,
            fill_na=0.0,
        )


def _extract_batch(
    audio: torch.Tensor,
    audio_lens: torch.Tensor,
    mel_cfg: MelConfig,
    pyin_cfg: PyinConfig,
):
    """One bucket on the device `audio` lies on: (mel [B, n_mels, T], mel_lens
    [B], energy [B, T], f0 [B, T_pitch], voiced [B, T_pitch], p_voiced)."""
    mel, mel_lens = log_mel_spectrogram(audio, audio_lens, mel_cfg)
    energy = frame_energy(audio, mel_cfg)
    f0, voiced, vprob = pyin(audio, audio_lens, pyin_cfg)
    return mel, mel_lens, energy, f0, voiced, vprob


class SupDataExtractor:
    """Batched device extraction with per-file .npy caching.  Runs on the
    card unless the caller passes another `device`."""

    def __init__(
        self,
        cfg: SupDataConfig,
        sup_data_path: Optional[str] = None,
        batch_size: int = 8,
        audio_pad_multiple: int = 16384,
        device="cuda",
    ):
        self.cfg = cfg
        self.sup_data_path = Path(sup_data_path) if sup_data_path else None
        self.batch_size = batch_size
        self.audio_pad_multiple = audio_pad_multiple
        self.device = torch.device(device)
        if self.sup_data_path is not None:
            for sub in CACHED_KINDS:
                (self.sup_data_path / sub).mkdir(parents=True, exist_ok=True)

    def _cache_file(self, kind: str, file_id: str) -> Optional[Path]:
        if self.sup_data_path is None:
            return None
        return self.sup_data_path / kind / f"{file_id}.npy"

    def load_cached(self, kind: str, file_id: str) -> Optional[np.ndarray]:
        p = self._cache_file(kind, file_id)
        if p is not None and p.exists():
            return np.load(p)
        return None

    def extract(
        self, audios: Sequence[np.ndarray], file_ids: Optional[Sequence[str]] = None
    ) -> List[Dict[str, np.ndarray]]:
        """Compute sup-data for a list of raw audio arrays.

        Pads each bucket of `batch_size` utterances to a common
        `audio_pad_multiple` length, runs one device call per bucket, trims
        per utterance (mel and energy to the mel length, pitch and voicing to
        the pitch frame count), optionally writes the cache.
        """
        out: List[Dict[str, np.ndarray]] = []
        mel_cfg, pyin_cfg = self.cfg.mel_config(), self.cfg.pyin_config()
        for i in range(0, len(audios), self.batch_size):
            chunk = [np.asarray(a, np.float32) for a in audios[i : i + self.batch_size]]
            lens = np.array([len(a) for a in chunk], np.int32)
            pad_len = int(np.ceil(lens.max() / self.audio_pad_multiple)) * self.audio_pad_multiple
            batch = np.zeros((len(chunk), pad_len), np.float32)
            for j, a in enumerate(chunk):
                batch[j, : len(a)] = a
            with torch.no_grad():
                results = _extract_batch(
                    torch.from_numpy(batch).to(self.device),
                    torch.from_numpy(lens).to(self.device), mel_cfg, pyin_cfg,
                )
            mel, mel_lens, energy, f0, voiced, vprob = (r.cpu().numpy() for r in results)
            n_pitch_frames = pyin_cfg.num_frames(lens)
            for j in range(len(chunk)):
                ml, pl = int(mel_lens[j]), int(n_pitch_frames[j])
                item = {
                    "log_mel": mel[j, :, :ml],
                    "mel_len": np.int32(ml),
                    "energy": energy[j, :ml],
                    "pitch": f0[j, :pl],
                    "voiced_mask": voiced[j, :pl],
                    "p_voiced": vprob[j, :pl],
                }
                out.append(item)
                if file_ids is not None and self.sup_data_path is not None:
                    fid = file_ids[i + j]
                    for kind in CACHED_KINDS:
                        np.save(self._cache_file(kind, fid), item[kind])
        return out


def pitch_statistics(pitches: Sequence[np.ndarray]) -> Dict[str, float]:
    """Mean/std/min/max over nonzero (voiced) pitch values."""
    vals = np.concatenate([p[p != 0.0] for p in pitches]) if pitches else np.zeros(1)
    if vals.size == 0:
        vals = np.zeros(1)
    return {
        "pitch_mean": float(vals.mean()),
        "pitch_std": float(vals.std()),
        "pitch_min": float(vals.min()),
        "pitch_max": float(vals.max()),
    }
