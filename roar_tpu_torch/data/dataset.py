"""Manifest-driven datasets; the port's copy of roar_tpu/data/dataset.py
`BucketSpec`, `TTSDataset` and `VocoderDataset` (host code, numpy: the same
manifest, cache and seed give the same items and batches as the JAX
package's).  `MixerTTSXDataset` and `PairedRealFakeSpectrogramsDataset` are
not ported yet."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from roar_tpu_torch.data.audio import AudioSegment
from roar_tpu_torch.data.manifest import filter_by_duration, read_manifest
from roar_tpu_torch.data.sup_data import SupDataConfig, SupDataExtractor
from roar_tpu_torch.ops.priors import BetaBinomialInterpolator, beta_binomial_prior_np


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Pad-to-multiple quanta of collated batches: a few fixed shapes
    instead of one per length."""

    text_multiple: int = 16
    mel_multiple: int = 32
    audio_multiple: int = 16384

    def text(self, n: int) -> int:
        return _round_up(max(n, 1), self.text_multiple)

    def mel(self, n: int) -> int:
        return _round_up(max(n, 1), self.mel_multiple)

    def audio(self, n: int) -> int:
        return _round_up(max(n, 1), self.audio_multiple)


class TTSDataset:
    """Text + audio dataset with cached sup-data: manifest, duration filter,
    texts tokenized at load, pitch / energy / voicing from the `.npy` cache
    of `SupDataExtractor` (extracted on `device` on a miss), pitch
    normalization, the beta-binomial alignment prior, bucketed collation."""

    def __init__(
        self,
        manifest_filepath,
        sample_rate: int,
        text_tokenizer,
        sup_data_path: Optional[str] = None,
        sup_data_types: Sequence[str] = ("align_prior_matrix", "pitch"),
        n_fft: int = 1024,
        win_length: Optional[int] = None,
        hop_length: Optional[int] = None,
        window: str = "hann",
        n_mels: int = 80,
        lowfreq: float = 0.0,
        highfreq: Optional[float] = None,
        max_duration: Optional[float] = None,
        min_duration: Optional[float] = None,
        ignore_file: Optional[str] = None,
        trim: bool = False,
        pitch_fmin: float = 65.40639132514966,
        pitch_fmax: float = 2093.004522404789,
        pitch_norm: bool = False,
        pitch_mean: Optional[float] = None,
        pitch_std: Optional[float] = None,
        pitch_stats: Optional[Dict[str, Dict[str, float]]] = None,
        use_beta_binomial_interpolator: bool = True,
        device="cuda",
        **_unused,
    ):
        self.sample_rate = sample_rate
        self.text_tokenizer = text_tokenizer
        self.trim = trim
        self.sup_data_types = set(sup_data_types or ())
        self.pitch_norm = pitch_norm
        self.pitch_mean = pitch_mean
        self.pitch_std = pitch_std
        self.pitch_stats = pitch_stats

        self.sup_cfg = SupDataConfig(
            sample_rate=sample_rate,
            n_fft=n_fft,
            win_length=win_length or n_fft,
            hop_length=hop_length or n_fft // 4,
            window=window,
            n_mels=n_mels,
            lowfreq=lowfreq,
            highfreq=highfreq,
            pitch_fmin=pitch_fmin,
            pitch_fmax=pitch_fmax,
        )
        self.extractor = SupDataExtractor(self.sup_cfg, sup_data_path, device=device)
        self.prior_interp = (
            BetaBinomialInterpolator() if use_beta_binomial_interpolator else None
        )

        entries = read_manifest(manifest_filepath)
        if ignore_file:
            ignored = {e.get("audio_filepath") for e in read_manifest(ignore_file)}
            entries = [e for e in entries if e.get("audio_filepath") not in ignored]
        entries, total_h, kept_h = filter_by_duration(entries, min_duration, max_duration)
        self.entries = entries
        self.total_hours, self.kept_hours = total_h, kept_h

        self.tokens = [
            np.asarray(self.text_tokenizer(e.get("normalized_text", e.get("text", ""))), np.int32)
            for e in self.entries
        ]
        self.lengths = [float(e.get("duration", 0.0)) for e in self.entries]

    def __len__(self) -> int:
        return len(self.entries)

    @staticmethod
    def file_id(entry: Dict[str, Any]) -> str:
        p = Path(entry["audio_filepath"])
        return "_".join(p.parts[-2:]).replace(p.suffix, "")

    def _load_audio(self, entry) -> np.ndarray:
        seg = AudioSegment.from_file(
            entry["audio_filepath"], target_sr=self.sample_rate, trim=self.trim
        )
        return seg.samples

    def _normalize_pitch(self, pitch: np.ndarray, entry) -> np.ndarray:
        """Subtract the mean, re-zero the frames that were zero, divide by std."""
        if not self.pitch_norm:
            return pitch
        if self.pitch_mean is not None and self.pitch_std is not None:
            mean, std = self.pitch_mean, self.pitch_std
        elif self.pitch_stats:
            key = str(entry.get("speaker_id", ""))
            stats = self.pitch_stats.get(key) or self.pitch_stats.get("default")
            if stats is None:
                raise ValueError(f"Could not find pitch stats for {entry}")
            mean, std = stats["pitch_mean"], stats["pitch_std"]
        else:
            raise ValueError("Missing statistics for pitch normalization.")
        out = pitch - mean
        out[out == -mean] = 0.0
        return out / std

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        entry = self.entries[idx]
        fid = self.file_id(entry)
        audio = self._load_audio(entry)
        tokens = self.tokens[idx]
        item: Dict[str, Any] = {
            "audio": audio,
            "audio_len": np.int32(len(audio)),
            "text": tokens,
            "text_len": np.int32(len(tokens)),
        }
        mel_len = self.sup_cfg.mel_config().get_seq_len(np.int64(len(audio)))
        item["mel_len"] = np.int32(mel_len)

        needs_pitch = {"pitch", "voiced_mask", "p_voiced"} & self.sup_data_types
        needs_energy = "energy" in self.sup_data_types
        cached: Dict[str, Optional[np.ndarray]] = {}
        if needs_pitch:
            for kind in ("pitch", "voiced_mask", "p_voiced"):
                cached[kind] = self.extractor.load_cached(kind, fid)
        if needs_energy:
            cached["energy"] = self.extractor.load_cached("energy", fid)

        if (needs_pitch and cached.get("pitch") is None) or (
            needs_energy and cached.get("energy") is None
        ):
            computed = self.extractor.extract([audio], [fid])[0]
            for kind in ("pitch", "energy", "voiced_mask", "p_voiced"):
                if cached.get(kind) is None:
                    cached[kind] = computed[kind]

        if "pitch" in self.sup_data_types:
            item["pitch"] = self._normalize_pitch(
                np.asarray(cached["pitch"], np.float32).copy(), entry
            )
        if "voiced_mask" in self.sup_data_types:
            item["voiced_mask"] = np.asarray(cached["voiced_mask"], bool)
        if "p_voiced" in self.sup_data_types:
            item["p_voiced"] = np.asarray(cached["p_voiced"], np.float32)
        if needs_energy:
            item["energy"] = np.asarray(cached["energy"], np.float32)

        if "align_prior_matrix" in self.sup_data_types:
            if self.prior_interp is not None:
                prior = self.prior_interp(int(mel_len), len(tokens))
            else:
                prior = beta_binomial_prior_np(len(tokens), int(mel_len))
            item["align_prior_matrix"] = prior

        if "speaker_id" in self.sup_data_types:
            item["speaker_id"] = np.int32(entry.get("speaker_id", 0))
        if "durations" in self.sup_data_types and "duration_filepath" in entry:
            item["durations"] = np.load(entry["duration_filepath"])
        return item

    def collate(
        self, items: List[Dict[str, Any]], buckets: Optional[BucketSpec] = None
    ) -> Dict[str, np.ndarray]:
        """Pad a list of items into one batch with bucketed shapes."""
        buckets = buckets or BucketSpec()
        b = len(items)
        t_text = buckets.text(max(int(i["text_len"]) for i in items))
        t_mel = buckets.mel(max(int(i["mel_len"]) for i in items))
        s_audio = buckets.audio(max(int(i["audio_len"]) for i in items))

        out: Dict[str, np.ndarray] = {
            "audio": np.zeros((b, s_audio), np.float32),
            "audio_len": np.zeros((b,), np.int32),
            "text": np.zeros((b, t_text), np.int32),
            "text_len": np.zeros((b,), np.int32),
            "mel_len": np.zeros((b,), np.int32),
        }
        out["text"].fill(self.text_tokenizer.pad)
        for j, it in enumerate(items):
            out["audio"][j, : int(it["audio_len"])] = it["audio"]
            out["audio_len"][j] = it["audio_len"]
            out["text"][j, : int(it["text_len"])] = it["text"]
            out["text_len"][j] = it["text_len"]
            out["mel_len"][j] = it["mel_len"]

        def pad_time(key, length, dtype=np.float32):
            if key not in items[0]:
                return
            arr = np.zeros((b, length), dtype)
            for j, it in enumerate(items):
                v = np.asarray(it[key])[:length]
                arr[j, : len(v)] = v
            out[key] = arr

        pad_time("pitch", t_mel)
        pad_time("energy", t_mel)
        pad_time("voiced_mask", t_mel, bool)
        pad_time("p_voiced", t_mel)
        if "align_prior_matrix" in items[0]:
            prior = np.zeros((b, t_mel, t_text), np.float32)
            for j, it in enumerate(items):
                p = it["align_prior_matrix"]
                prior[j, : p.shape[0], : p.shape[1]] = p
            out["align_prior_matrix"] = prior
        if "speaker_id" in items[0]:
            out["speaker_id"] = np.asarray([it["speaker_id"] for it in items], np.int32)
        if "durations" in items[0]:
            durs = np.zeros((b, t_text), np.float32)
            for j, it in enumerate(items):
                d = np.asarray(it["durations"])[:t_text]
                durs[j, : len(d)] = d
            out["durations"] = durs
        return out


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

    def collate(self, items: List[Dict[str, Any]],
                buckets: Optional[BucketSpec] = None) -> Dict[str, np.ndarray]:
        """Pad a list of items to the longest one (`buckets` is accepted so
        every dataset collates through one call, and ignored: training
        segments share one length)."""
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
