"""JSON-lines manifest IO; the port's copy of roar_tpu/data/manifest.py
(the reference's manifest format:
roar/collections/asr/parts/utils/manifest_utils.py read/write_manifest)."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Sequence, Union


def read_manifest(path: Union[str, Path, Sequence[Union[str, Path]]]) -> List[Dict[str, Any]]:
    """Read one or several JSON-lines manifests (comma-separated paths, lists,
    and nested lists accepted — mirroring the reference's flexibility
    at dataset.py:214-230)."""
    if isinstance(path, (list, tuple)):
        out: List[Dict[str, Any]] = []
        for p in path:
            out.extend(read_manifest(p))
        return out
    if isinstance(path, str) and "," in path:
        return read_manifest(path.split(","))
    entries = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                entries.append(json.loads(line))
    return entries


def write_manifest(path: Union[str, Path], entries: Sequence[Dict[str, Any]]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for e in entries:
            f.write(json.dumps(e, ensure_ascii=False) + "\n")


def filter_by_duration(entries, min_duration=None, max_duration=None):
    """Duration filtering with kept/total hour accounting
    (tts_dataset_utils.py:178-211)."""
    kept, total_s, kept_s = [], 0.0, 0.0
    for e in entries:
        d = float(e.get("duration", 0.0))
        total_s += d
        if min_duration and d < min_duration:
            continue
        if max_duration and d > max_duration:
            continue
        kept_s += d
        kept.append(e)
    return kept, total_s / 3600.0, kept_s / 3600.0
