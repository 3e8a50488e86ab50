"""Featurizer framework + feature processors (the "new-style" data path).

Port of roar_tpu/data/featurizers.py, itself a re-design of roar/collections/tts/parts/preprocessing/features.py:40-397
(Featurizer ABC, MelSpectrogramFeaturizer, EnergyFeaturizer, PitchFeaturizer)
and feature_processors.py:23-180 (FeatureScaler, LogCompression,
MeanVarianceNormalization, MeanVarianceSpeakerNormalization).  The compute
kernels are the on-device ops; featurizers add the save/load/collate
protocol around them.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from roar_tpu_torch.data.sup_data import SupDataConfig, SupDataExtractor


def _feature_path(feature_dir: Path, feature_name: str, entry: Dict[str, Any]) -> Path:
    p = Path(entry["audio_filepath"])
    fid = "_".join(p.parts[-2:]).replace(p.suffix, "")
    return feature_dir / feature_name / f"{fid}.npy"


class Featurizer:
    """save/load protocol (features.py:40-79)."""

    feature_names = ()

    def __init__(self, cfg: SupDataConfig, feature_dir: str, device="cuda"):
        self.cfg = cfg
        self.feature_dir = Path(feature_dir)
        self.extractor = SupDataExtractor(cfg, feature_dir, device=device)

    def setup(self):
        for name in self.feature_names:
            (self.feature_dir / name).mkdir(parents=True, exist_ok=True)

    def save(self, entry: Dict[str, Any], audio: np.ndarray) -> None:
        item = self.extractor.extract([audio])[0]
        for name in self.feature_names:
            np.save(_feature_path(self.feature_dir, name, entry), item[name])

    def load(self, entry: Dict[str, Any]) -> Dict[str, np.ndarray]:
        return {
            name: np.load(_feature_path(self.feature_dir, name, entry))
            for name in self.feature_names
        }


class MelSpectrogramFeaturizer(Featurizer):
    feature_names = ("log_mel",)

    def save(self, entry, audio):
        item = self.extractor.extract([audio])[0]
        np.save(_feature_path(self.feature_dir, "log_mel", entry), item["log_mel"])


class EnergyFeaturizer(Featurizer):
    feature_names = ("energy",)


class PitchFeaturizer(Featurizer):
    feature_names = ("pitch", "voiced_mask", "p_voiced")


# ---------------------------------------------------------------------------
# Feature processors (feature_processors.py:23-180)
# ---------------------------------------------------------------------------


class FeatureScaler:
    def __init__(self, field: str, add_value: float = 0.0, div_value: float = 1.0):
        self.field, self.add_value, self.div_value = field, add_value, div_value

    def process(self, example: Dict[str, Any]) -> None:
        example[self.field] = (example[self.field] + self.add_value) / self.div_value


class LogCompression:
    def __init__(self, field: str, log_zero_guard_type: str = "add",
                 log_zero_guard_value: float = 1.0):
        self.field = field
        self.kind = log_zero_guard_type
        self.value = log_zero_guard_value

    def process(self, example: Dict[str, Any]) -> None:
        x = example[self.field]
        if self.kind == "add":
            example[self.field] = np.log(x + self.value)
        else:
            example[self.field] = np.log(np.clip(x, self.value, None))


class MeanVarianceNormalization:
    def __init__(self, field: str, stats_path: str, mask_field: Optional[str] = "voiced_mask"):
        self.field = field
        self.mask_field = mask_field
        with open(stats_path) as f:
            stats = json.load(f)["default"]
        self.mean = stats[f"{field}_mean"]
        self.std = stats[f"{field}_std"]

    def process(self, example: Dict[str, Any]) -> None:
        x = example[self.field]
        x = (x - self.mean) / max(self.std, 1e-8)
        if self.mask_field and self.mask_field in example:
            x = np.where(example[self.mask_field], x, 0.0)
        example[self.field] = x


class MeanVarianceSpeakerNormalization:
    def __init__(self, field: str, stats_path: str, speaker_field: str = "speaker_id",
                 mask_field: Optional[str] = "voiced_mask", fallback_to_default: bool = True):
        self.field = field
        self.speaker_field = speaker_field
        self.mask_field = mask_field
        self.fallback = fallback_to_default
        with open(stats_path) as f:
            self.stats = json.load(f)

    def process(self, example: Dict[str, Any]) -> None:
        key = str(example.get(self.speaker_field, "default"))
        stats = self.stats.get(key)
        if stats is None:
            if not self.fallback:
                raise ValueError(f"No stats for speaker {key}")
            stats = self.stats["default"]
        x = example[self.field]
        x = (x - stats[f"{self.field}_mean"]) / max(stats[f"{self.field}_std"], 1e-8)
        if self.mask_field and self.mask_field in example:
            x = np.where(example[self.mask_field], x, 0.0)
        example[self.field] = x
