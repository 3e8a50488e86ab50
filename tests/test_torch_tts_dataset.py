"""`TTSDataset` and `BucketSpec` of the port against the JAX package's: the
same manifest, tokenizer settings and sup-data cache give equal items and
equal collated batches (host code on both sides, so equality is the bar).
"""

import numpy as np
import pytest

from roar_tpu.data import tokenizers as jax_tok
from roar_tpu.data.dataset import BucketSpec as JaxBucketSpec
from roar_tpu.data.dataset import TTSDataset as JaxTTSDataset
from roar_tpu_torch.data import tokenizers as port_tok
from roar_tpu_torch.data.audio import write_wav
from roar_tpu_torch.data.dataset import BucketSpec, TTSDataset
from roar_tpu_torch.data.manifest import write_manifest
from roar_tpu_torch.training.run import batch_iterator, build_tts_dataset

SR = 22050
TEXTS = ["hello there", "a much longer sentence, with punctuation!", "hi", "four score and seven",
         "short one", "the quick brown fox"]
ALL_TYPES = ["align_prior_matrix", "pitch", "energy", "voiced_mask", "p_voiced", "speaker_id"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Six tones of 0.3 to 1.5 s as 16-bit WAVs, a manifest with text and
    speaker ids, and a sup-data cache with seeded arrays for every file."""
    root = tmp_path_factory.mktemp("tts_corpus")
    rng = np.random.default_rng(0)
    entries = []
    sup = root / "sup"
    for kind in ("pitch", "energy", "voiced_mask", "p_voiced"):
        (sup / kind).mkdir(parents=True)
    for i, text in enumerate(TEXTS):
        n = int(SR * rng.uniform(0.3, 1.5))
        audio = (0.3 * np.sin(2 * np.pi * 110 * (i + 1) * np.arange(n) / SR)).astype(np.float32)
        path = root / "wavs" / f"utt{i}.wav"
        path.parent.mkdir(exist_ok=True)
        write_wav(str(path), audio, SR)
        entries.append({"audio_filepath": str(path), "text": text, "duration": n / SR,
                        "speaker_id": i % 3})
        frames = n // 256 + 1
        voiced = rng.random(frames) < 0.7
        fid = f"wavs_utt{i}"
        np.save(sup / "pitch" / f"{fid}.npy",
                np.where(voiced, rng.uniform(80, 400, frames), 0.0).astype(np.float32))
        np.save(sup / "energy" / f"{fid}.npy", rng.random(frames).astype(np.float32) * 30)
        np.save(sup / "voiced_mask" / f"{fid}.npy", voiced)
        np.save(sup / "p_voiced" / f"{fid}.npy", rng.random(frames).astype(np.float32))
    manifest = str(root / "train_manifest.json")
    write_manifest(manifest, entries)
    return manifest, str(sup)


def _pair(manifest, sup, **kwargs):
    common = dict(manifest_filepath=manifest, sample_rate=SR, sup_data_path=sup, n_fft=1024,
                  win_length=1024, hop_length=256, n_mels=80, lowfreq=0, highfreq=8000, **kwargs)
    tok_kwargs = dict(punct=True, apostrophe=True, pad_with_space=True)
    want = JaxTTSDataset(text_tokenizer=jax_tok.EnglishCharsTokenizer(**tok_kwargs), **common)
    got = TTSDataset(text_tokenizer=port_tok.EnglishCharsTokenizer(**tok_kwargs), device="cpu",
                     **common)
    return got, want


def _assert_same(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, f"{what} {k}: {g.dtype}{g.shape}"
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")


@pytest.mark.parametrize("kwargs", [
    dict(sup_data_types=ALL_TYPES, pitch_norm=True, pitch_mean=200.0, pitch_std=50.0),
    dict(sup_data_types=["align_prior_matrix", "pitch", "speaker_id"], pitch_norm=True,
         pitch_stats={"0": {"pitch_mean": 180.0, "pitch_std": 40.0},
                      "default": {"pitch_mean": 210.0, "pitch_std": 60.0}}),
    dict(sup_data_types=["align_prior_matrix", "pitch"], use_beta_binomial_interpolator=False),
    dict(sup_data_types=["pitch", "energy"], min_duration=0.6, max_duration=1.4),
], ids=["all_types", "per_speaker_stats", "exact_prior", "duration_filter"])
def test_items_and_batches_equal_the_jax_dataset(corpus, kwargs):
    got_ds, want_ds = _pair(*corpus, **kwargs)
    assert len(got_ds) == len(want_ds) and got_ds.lengths == want_ds.lengths
    assert (got_ds.total_hours, got_ds.kept_hours) == (want_ds.total_hours, want_ds.kept_hours)
    if "min_duration" in kwargs:
        assert len(got_ds) < len(TEXTS)
    for i in range(len(want_ds)):
        _assert_same(got_ds[i], want_ds[i], f"item {i}")
    order = list(range(len(want_ds)))[::-1]
    _assert_same(got_ds.collate([got_ds[i] for i in order]),
                 want_ds.collate([want_ds[i] for i in order]), "default buckets")
    small = dict(text_multiple=8, mel_multiple=16, audio_multiple=4096)
    _assert_same(got_ds.collate([got_ds[i] for i in order[:2]], BucketSpec(**small)),
                 want_ds.collate([want_ds[i] for i in order[:2]], JaxBucketSpec(**small)),
                 "small buckets")


def test_collated_shapes_follow_the_buckets(corpus):
    got_ds, _ = _pair(*corpus, sup_data_types=ALL_TYPES)
    batch = got_ds.collate([got_ds[i] for i in range(4)])
    t_text, t_mel = batch["text"].shape[1], batch["pitch"].shape[1]
    assert t_text % 16 == 0 and t_mel % 32 == 0 and batch["audio"].shape[1] % 16384 == 0
    assert batch["align_prior_matrix"].shape == (4, t_mel, t_text)
    assert (batch["text"][np.arange(t_text)[None] >= batch["text_len"][:, None]]
            == got_ds.text_tokenizer.pad).all()
    for j in range(4):
        prior = batch["align_prior_matrix"][j]
        assert prior[: batch["mel_len"][j] - 1, : batch["text_len"][j]].sum(-1).min() > 0
        assert prior[batch["mel_len"][j]:].sum() == 0.0
        assert prior[:, batch["text_len"][j]:].sum() == 0.0
    assert BucketSpec().mel(65) == 96 and BucketSpec().text(0) == 16


def test_missing_pitch_statistics_raise(corpus):
    got_ds, _ = _pair(*corpus, sup_data_types=["pitch"], pitch_norm=True)
    with pytest.raises(ValueError, match="Missing statistics"):
        got_ds[0]


def test_build_tts_dataset_and_bucketed_batch_iterator(corpus):
    manifest, sup = corpus
    tok = port_tok.EnglishCharsTokenizer(pad_with_space=True)
    ds = build_tts_dataset({"_target_": "roar_tpu.data.dataset.TTSDataset",
                            "manifest_filepath": manifest, "sample_rate": SR,
                            "sup_data_path": sup, "sup_data_types": ["pitch", "speaker_id"],
                            "n_fft": 1024, "hop_length": 256, "text_tokenizer": "ignored"},
                           tok, device="cpu")
    assert isinstance(ds, TTSDataset) and ds.text_tokenizer is tok
    sampler = [[0, 1], [2, 3, 4]]
    plain = list(batch_iterator(ds, sampler, BucketSpec(mel_multiple=8)))
    threaded = list(batch_iterator(ds, sampler, BucketSpec(mel_multiple=8), num_workers=2))
    assert [b["pitch"].shape[0] for b in plain] == [2, 3]
    assert all(b["pitch"].shape[1] % 8 == 0 for b in plain)
    for a, b in zip(plain, threaded):
        _assert_same(a, b, "threaded")
