"""Extract supplementary data (pitch, energy, voicing) for a manifest with the
PyTorch port, on one CUDA card.

Same config, overrides and printed lines as
scripts/dataset_processing/tts/extract_sup_data.py: audio is read on the
host, pushed through one batched device pipeline (log-mel + pYIN + energy),
cached as .npy, and the nonzero-pitch statistics are printed at the end
(PITCH_MEAN / PITCH_STD, consumed by the FastPitch/JETS configs).

    python scripts/dataset_processing/tts/extract_sup_data_torch.py \
        --config-name=ds_for_fastpitch_align \
        manifest_filepath=train.json sup_data_path=sup [device=cuda]

`device=cpu` runs the same pipeline on the host with the kernels' plain
versions.  `run(cfg)` takes the loaded config as a Python dict.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[3]))

from roar_tpu_torch.config.cli import config_runner
from roar_tpu_torch.data.audio import AudioSegment
from roar_tpu_torch.data.manifest import read_manifest
from roar_tpu_torch.data.sup_data import SupDataConfig, SupDataExtractor, pitch_statistics


def file_id(entry) -> str:
    p = Path(entry["audio_filepath"])
    return "_".join(p.parts[-2:]).replace(p.suffix, "")


def run(cfg: dict) -> dict:
    """Extract sup-data for `cfg["dataset"]["manifest_filepath"]` into
    `cfg["dataset"]["sup_data_path"]`; returns the pitch statistics plus
    `mel_frames` and `seconds`."""
    ds = cfg["dataset"]
    sup_cfg = SupDataConfig(
        sample_rate=ds["sample_rate"],
        n_fft=ds["n_fft"],
        win_length=ds["win_length"],
        hop_length=ds["hop_length"],
        window=ds.get("window", "hann"),
        n_mels=ds.get("n_mels", 80),
        lowfreq=ds.get("lowfreq", 0),
        highfreq=ds.get("highfreq"),
        pitch_fmin=ds.get("pitch_fmin", 65.40639132514966),
        pitch_fmax=ds.get("pitch_fmax", 2093.004522404789),
    )
    extractor = SupDataExtractor(
        sup_cfg,
        sup_data_path=ds["sup_data_path"],
        batch_size=cfg.get("batch_size", 16),
        audio_pad_multiple=cfg.get("audio_pad_multiple", 16384),
        device=cfg.get("device", "cuda"),
    )

    entries = read_manifest(ds["manifest_filepath"])
    print(f"Extracting sup-data for {len(entries)} utterances ...")

    pitches = []
    total_frames = 0
    t0 = time.perf_counter()
    bs = extractor.batch_size
    for i in range(0, len(entries), bs):
        chunk = entries[i : i + bs]
        audios = [
            AudioSegment.from_file(e["audio_filepath"], target_sr=sup_cfg.sample_rate).samples
            for e in chunk
        ]
        items = extractor.extract(audios, [file_id(e) for e in chunk])
        for item in items:
            pitches.append(item["pitch"])
            total_frames += int(item["mel_len"])
        if (i // bs) % 20 == 0:
            dt = time.perf_counter() - t0
            print(f"  {i + len(chunk)}/{len(entries)}  ({total_frames / max(dt, 1e-9):.0f} frames/s)")

    stats = pitch_statistics(pitches)
    dt = time.perf_counter() - t0
    print(f"Done: {total_frames} mel frames in {dt:.1f}s "
          f"({total_frames / max(dt, 1e-9):.0f} frames/s)")
    print(f"PITCH_MEAN={stats['pitch_mean']}, PITCH_STD={stats['pitch_std']}")
    print(f"PITCH_MIN={stats['pitch_min']}, PITCH_MAX={stats['pitch_max']}")
    return {**stats, "mel_frames": total_frames, "seconds": dt}


main = config_runner(
    config_path=str(Path(__file__).resolve().parents[3] / "configs"),
    config_name="ds_for_fastpitch_align",
)(run)


if __name__ == "__main__":
    main()
