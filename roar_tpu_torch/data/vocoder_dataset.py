"""New-style VocoderDataset: dataset_meta-driven audio sampling + weights.

The port's copy of roar_tpu/data/vocoder_dataset.py (host code, numpy: the
same manifests and seed give the same items, weights and batches as the JAX
package's).  Multiple named sub-datasets (`dataset_meta` of {name:
{manifest_path, audio_dir, sample_weight}}), random `n_samples` crops from an
explicit numpy generator seeded with `seed`, truncation, feature processors,
IO retries, and per-sample weights for a weighted sampler.  Collate pads to an
`audio_multiple`, so a training run sees a few batch shapes, not one per
length (configs/hifigan_dataset/hifigan_22050.yaml's recipe).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from roar_tpu_torch.data.audio import AudioSegment
from roar_tpu_torch.data.manifest import filter_by_duration, read_manifest
from roar_tpu_torch.utils.logging import get_logger

logging = get_logger()


def _round_up(x: int, m: int) -> int:
    return ((max(x, 1) + m - 1) // m) * m


@dataclasses.dataclass
class DatasetMeta:
    manifest_path: str
    audio_dir: str
    sample_weight: float = 1.0


def get_abs_rel_paths(input_path: Path, base_path: Path):
    """(abs, rel) pair for a manifest audio path
    (tts_dataset_utils.get_abs_rel_paths)."""
    input_path = Path(input_path)
    if input_path.is_absolute():
        try:
            rel = input_path.relative_to(base_path)
        except ValueError:
            rel = Path(input_path.name)
        return input_path, rel
    return Path(base_path) / input_path, input_path


class VocoderDataset:
    """See module docstring.  Items: {audio_filepath (rel), audio,
    audio_len}; collate: {audio_filepaths, audio, audio_lens}."""

    def __init__(
        self,
        dataset_meta: Dict[str, Dict[str, Any]],
        sample_rate: int,
        n_samples: Optional[int] = None,
        weighted_sampling_steps_per_epoch: Optional[int] = None,
        feature_processors: Optional[Dict[str, Any]] = None,
        min_duration: Optional[float] = None,
        max_duration: Optional[float] = None,
        trunc_duration: Optional[float] = None,
        num_audio_retries: int = 5,
        audio_multiple: int = 1024,
        seed: int = 0,
    ):
        self.sample_rate = sample_rate
        self.n_samples = n_samples
        self.weighted_sampling_steps_per_epoch = weighted_sampling_steps_per_epoch
        self.num_audio_retries = num_audio_retries
        self.audio_multiple = audio_multiple
        self.trunc_samples = (
            int(trunc_duration * sample_rate) if trunc_duration else None
        )
        self.feature_processors = list((feature_processors or {}).values())
        self._rng = np.random.default_rng(seed)

        self.data_samples: List[Dict[str, Any]] = []
        self.sample_weights: List[float] = []
        self.lengths: List[float] = []
        for name, info in dataset_meta.items():
            meta = DatasetMeta(**info)
            entries = read_manifest(meta.manifest_path)
            filtered, total_h, kept_h = filter_by_duration(
                entries, min_duration, max_duration
            )
            logging.info(
                f"{name}: {len(filtered)}/{len(entries)} files, "
                f"{kept_h:.2f}/{total_h:.2f} hours after duration filtering"
            )
            for e in filtered:
                self.data_samples.append(
                    {"entry": e, "audio_dir": Path(meta.audio_dir)}
                )
                self.sample_weights.append(meta.sample_weight)
                self.lengths.append(float(e.get("duration", 0.0)))

    def get_sampler_indices(self, batch_size: int) -> Optional[np.ndarray]:
        """Weighted with-replacement epoch indices
        (get_weighted_sampler, tts_dataset_utils.py:214)."""
        if not self.weighted_sampling_steps_per_epoch:
            return None
        num = self.weighted_sampling_steps_per_epoch * batch_size
        w = np.asarray(self.sample_weights, np.float64)
        return self._rng.choice(len(self.data_samples), size=num, p=w / w.sum())

    # ------------------------------------------------------------------

    def _segment_audio(self, path: Path) -> np.ndarray:
        last = None
        for _ in range(self.num_audio_retries):
            try:
                seg = AudioSegment.from_file(str(path), target_sr=self.sample_rate)
                audio = seg.samples
                if self.n_samples:
                    if len(audio) > self.n_samples:
                        start = int(
                            self._rng.integers(0, len(audio) - self.n_samples + 1)
                        )
                        audio = audio[start : start + self.n_samples]
                    else:
                        audio = np.pad(audio, (0, self.n_samples - len(audio)))
                return audio
            except Exception as exc:  # sporadic IO (vocoder_dataset.py:116-128)
                last = exc
        raise ValueError(f"Failed to read audio {path}") from last

    def __len__(self) -> int:
        return len(self.data_samples)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        data = self.data_samples[idx]
        abs_path, rel_path = get_abs_rel_paths(
            Path(data["entry"]["audio_filepath"]), data["audio_dir"]
        )
        audio = self._segment_audio(abs_path).astype(np.float32)
        if self.trunc_samples:
            audio = audio[: self.trunc_samples]
        example = {
            "audio_filepath": str(rel_path),
            "audio": audio,
            "audio_len": np.int32(len(audio)),
        }
        for processor in self.feature_processors:
            processor.process(example)
        return example

    def collate(self, batch: List[Dict[str, Any]], buckets=None) -> Dict[str, Any]:
        """Pad to the longest item rounded up to `audio_multiple`.  `buckets`
        is accepted so every dataset collates through one call, and ignored:
        `audio_multiple` is this dataset's bucket."""
        b = len(batch)
        s = _round_up(max(len(e["audio"]) for e in batch), self.audio_multiple)
        audio = np.zeros((b, s), np.float32)
        lens = np.zeros((b,), np.int32)
        for j, e in enumerate(batch):
            audio[j, : len(e["audio"])] = e["audio"]
            lens[j] = e["audio_len"]
        return {
            "audio_filepaths": [e["audio_filepath"] for e in batch],
            "audio": audio,
            "audio_lens": lens,
            # alias for tasks expecting the old-style key
            "audio_len": lens,
        }

    collate_fn = collate
