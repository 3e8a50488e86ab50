"""Manifest-driven datasets; the port's copy of roar_tpu/data/dataset.py
`VocoderDataset` (host code, numpy: the same seed gives the same crops).
`TTSDataset` waits for the FastPitch training slice."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from roar_tpu_torch.data.audio import AudioSegment
from roar_tpu_torch.data.manifest import filter_by_duration, read_manifest


class VocoderDataset:
    """Fixed-size audio segments for GAN vocoder training: random
    `n_segments`-sample crops, statically shaped by construction."""

    def __init__(
        self,
        manifest_filepath,
        sample_rate: int,
        n_segments: Optional[int] = 8192,
        max_duration: Optional[float] = None,
        min_duration: Optional[float] = None,
        ignore_file: Optional[str] = None,
        trim: bool = False,
        load_precomputed_mel: bool = False,
        hop_length: Optional[int] = None,
        seed: int = 0,
        **_unused,
    ):
        entries = read_manifest(manifest_filepath)
        if ignore_file:
            ignored = {e.get("audio_filepath") for e in read_manifest(ignore_file)}
            entries = [e for e in entries if e.get("audio_filepath") not in ignored]
        entries, _, _ = filter_by_duration(entries, min_duration, max_duration)
        self.entries = entries
        self.sample_rate = sample_rate
        self.n_segments = n_segments
        self.trim = trim
        self.load_precomputed_mel = load_precomputed_mel
        self.hop_length = hop_length
        self.lengths = [float(e.get("duration", 0.0)) for e in entries]
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        entry = self.entries[idx]
        seg = AudioSegment.from_file(
            entry["audio_filepath"], target_sr=self.sample_rate, trim=self.trim
        )
        audio = seg.samples

        if self.load_precomputed_mel:
            # fine-tuning on predicted mels: hop-aligned (mel, audio) segment pairs
            if self.hop_length is None:
                raise ValueError("load_precomputed_mel requires hop_length")
            mel = np.load(entry["mel_filepath"])  # [n_mel, T]
            if self.n_segments:
                frames = self.n_segments // self.hop_length
                if mel.shape[1] > frames:
                    start = int(self._rng.integers(0, mel.shape[1] - frames + 1))
                else:
                    start = 0
                    mel = np.pad(mel, ((0, 0), (0, frames - mel.shape[1])))
                mel = mel[:, start : start + frames]
                a0 = start * self.hop_length
                audio_seg = audio[a0 : a0 + self.n_segments]
                if len(audio_seg) < self.n_segments:
                    audio_seg = np.pad(audio_seg, (0, self.n_segments - len(audio_seg)))
                audio = audio_seg
            return {
                "audio": audio.astype(np.float32),
                "audio_len": np.int32(len(audio)),
                "mel": mel.astype(np.float32),
            }

        if self.n_segments is not None and self.n_segments > 0:
            if len(audio) >= self.n_segments:
                start = int(self._rng.integers(0, len(audio) - self.n_segments + 1))
                audio = audio[start : start + self.n_segments]
            else:
                audio = np.pad(audio, (0, self.n_segments - len(audio)))
            audio_len = self.n_segments
        else:
            audio_len = len(audio)
        return {"audio": audio, "audio_len": np.int32(audio_len)}

    def collate(self, items: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        b = len(items)
        s = max(len(i["audio"]) for i in items)
        audio = np.zeros((b, s), np.float32)
        lens = np.zeros((b,), np.int32)
        for j, it in enumerate(items):
            audio[j, : len(it["audio"])] = it["audio"]
            lens[j] = it["audio_len"]
        out = {"audio": audio, "audio_len": lens}
        if "mel" in items[0]:
            t = max(i["mel"].shape[1] for i in items)
            m = items[0]["mel"].shape[0]
            mel = np.zeros((b, t, m), np.float32)
            for j, it in enumerate(items):
                mel[j, : it["mel"].shape[1]] = it["mel"].T
            out["mel"] = mel
        return out
