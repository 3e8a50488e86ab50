"""The language-model data layer: a word-level tokenizer, packed next-token
blocks, and the BERT pretraining datasets.

Port of roar_tpu/data/lm_dataset.py, numpy only: `find_newlines`,
`SimpleWordTokenizer`, `CausalLMDataset` and the three BERT classes,
`BertPretrainingDataset` (raw text -> sentence pairs with NSP labels and
whole-word MLM masking, each item drawn from a `np.random.Generator` seeded
by `(seed, idx)`, so the same seed gives the same masked batches as the JAX
package), `BertPretrainingPreprocessedDataset` (already-masked `.npz`
shards) and `BertPretrainingFileLoader` (an epoch iterator over shards).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["find_newlines", "SimpleWordTokenizer", "CausalLMDataset",
           "BertPretrainingDataset", "BertPretrainingPreprocessedDataset",
           "BertPretrainingFileLoader"]


def find_newlines(contents: bytes) -> np.ndarray:
    """Byte offsets of line starts in `contents`: offset 0 plus the position
    after every newline that still has text behind it, without the starts of
    empty lines."""
    buf = np.frombuffer(contents, dtype=np.uint8)
    after = np.flatnonzero(buf == 0x0A) + 1
    starts = np.concatenate([[0], after[after < len(buf)]])
    nonempty = buf[starts] != 0x0A
    return starts[nonempty].astype(np.int64)


class SimpleWordTokenizer:
    """Whitespace word-level tokenizer with BERT special tokens.

    The vocabulary is built from the corpus file(s) at construction: the
    specials, then the words by falling count (ties by the word itself), cut
    at `max_vocab`.  `is_continuation` is the grouping hook of whole-word
    masking and is overridable for subword vocabularies."""

    SPECIALS = ["[PAD]", "[CLS]", "[SEP]", "[EOS]", "[MASK]", "[UNK]"]

    def __init__(self, corpus_files: Sequence[str], max_vocab: int = 30000):
        counts: Dict[str, int] = {}
        for path in corpus_files:
            with open(path, "r", encoding="utf-8", errors="ignore") as f:
                for line in f:
                    for w in line.split():
                        counts[w] = counts.get(w, 0) + 1
        words = sorted(counts, key=lambda w: (-counts[w], w))
        self._tokens = list(self.SPECIALS) + words[: max_vocab - len(self.SPECIALS)]
        self._ids = {t: i for i, t in enumerate(self._tokens)}
        self.pad_id = self._ids["[PAD]"]
        self.cls_id = self._ids["[CLS]"]
        self.sep_id = self._ids["[SEP]"]
        self.eos_id = self._ids["[EOS]"]
        self.mask_id = self._ids["[MASK]"]
        self.unk_id = self._ids["[UNK]"]

    @property
    def vocab_size(self) -> int:
        return len(self._tokens)

    def text_to_ids(self, text: str) -> List[int]:
        return [self._ids.get(w, self.unk_id) for w in text.split()]

    def ids_to_tokens(self, ids: Sequence[int]) -> List[str]:
        return [self._tokens[i] for i in ids]

    def token_to_id(self, token: str) -> int:
        return self._ids.get(token, self.unk_id)

    def is_continuation(self, token: str) -> bool:
        """Whether `token` continues the previous word (subword hook)."""
        return token.startswith("##")


class CausalLMDataset:
    """Packed next-token-prediction blocks for GPT pretraining.

    The corpus is tokenized once, its documents (lines) joined with the
    tokenizer's EOS id, and the id stream cut into contiguous non-overlapping
    windows of `seq_length + 1`; item `i` yields `input_ids = window[:-1]` and
    `labels = window[1:]`.  Packing means no padding: every position carries a
    real next-token target, so the loss needs no mask."""

    def __init__(self, tokenizer, corpus_file: str, seq_length: int = 512):
        self.tokenizer = tokenizer
        self.seq_length = int(seq_length)
        ids: List[int] = []
        eos = getattr(tokenizer, "eos_id", None)
        with open(corpus_file, "r", encoding="utf-8", errors="ignore") as f:
            for line in f:
                if not line.strip():
                    continue
                ids.extend(tokenizer.text_to_ids(line))
                if eos is not None:
                    ids.append(eos)
        self.data = np.asarray(ids, np.int32)
        self.n_blocks = max(0, (len(self.data) - 1) // self.seq_length)
        if self.n_blocks == 0:
            raise ValueError(f"corpus {corpus_file} has only {len(self.data)} tokens: fewer "
                             f"than one {self.seq_length}-token block")
        # every packed block is exactly seq_length tokens (the sampler's protocol)
        self.lengths = [float(self.seq_length)] * self.n_blocks

    def __len__(self) -> int:
        return self.n_blocks

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        start = idx * self.seq_length
        window = self.data[start: start + self.seq_length + 1]
        return {"input_ids": window[:-1], "labels": window[1:]}

    @staticmethod
    def collate(items, buckets=None):
        return {k: np.stack([i[k] for i in items]) for k in items[0]}


def _load_sentence_indices(sentence_idx_file, data_file, prefix):
    """(indices | None, idx_file, data_dir) — cache handling mirroring
    bert_dataset.py:74-97 ``load_data_indices``."""
    data_dir = data_file[: data_file.rfind("/")] if "/" in data_file else "."
    if sentence_idx_file is None:
        base = os.path.basename(data_file)
        sentence_idx_file = os.path.join(data_dir, f"{prefix}_{base}.pkl")
    if os.path.isfile(sentence_idx_file):
        with open(sentence_idx_file, "rb") as f:
            return pickle.load(f), sentence_idx_file, data_dir
    return None, sentence_idx_file, data_dir


class BertPretrainingDataset:
    """Raw-text MLM+NSP dataset (bert_dataset.py:39-345 semantics).

    Each item is a dict of fixed ``max_seq_length`` arrays:
    ``input_ids`` (masked), ``input_type_ids`` (segment B marker),
    ``input_mask`` (non-pad), ``output_ids`` (unmasked targets),
    ``output_mask`` (positions that count toward the MLM loss) and the
    scalar ``is_next`` NSP label."""

    def __init__(
        self,
        tokenizer,
        data_file: str,
        max_seq_length: int = 128,
        mask_prob: float = 0.15,
        short_seq_prob: float = 0.1,
        seq_a_ratio: float = 0.6,
        sentence_idx_file: Optional[str] = None,
        seed: int = 0,
    ):
        self.tokenizer = tokenizer
        self.max_seq_length = int(max_seq_length)
        self.mask_prob = float(mask_prob)
        self.short_seq_prob = float(short_seq_prob)
        self.seq_a_ratio = float(seq_a_ratio)
        self.seed = int(seed)

        indices, idx_file, data_dir = _load_sentence_indices(
            sentence_idx_file, data_file, "sentence_indices"
        )
        if indices is None:
            with open(data_file, "rb") as f:
                starts = find_newlines(f.read())
            name = os.path.basename(data_file) if os.path.isdir(data_dir) else data_file
            indices = {name: starts}
            with open(idx_file, "wb") as f:
                pickle.dump(indices, f)
        # drop files with <2 usable lines (can't form pairs), as the
        # reference does (bert_dataset.py:100-112)
        self.sentence_indices = {k: np.asarray(v) for k, v in indices.items()
                                 if len(v) > 1}
        if not self.sentence_indices:
            raise ValueError(f"{data_file}: needs at least 2 non-empty lines")
        self.dataset = data_dir
        self.filenames = sorted(self.sentence_indices)
        self.corpus_size = sum(len(v) for v in self.sentence_indices.values())
        self.vocab_size = tokenizer.vocab_size
        # static shapes: every item is max_seq_length long
        self.lengths = [float(max_seq_length)] * self.corpus_size

    def __len__(self) -> int:
        return self.corpus_size

    # -- corpus access -----------------------------------------------------
    def _read_line(self, filename: str, offset: int) -> List[int]:
        path = filename
        if os.path.isdir(self.dataset):
            path = os.path.join(self.dataset, filename)
        with open(path, "rb") as f:
            f.seek(int(offset))
            text = f.readline().rstrip(b"\n").decode("utf-8", errors="ignore")
        return self.tokenizer.text_to_ids(text)

    def _grow_to(self, doc, target_len, filename, line_idx, rng):
        """Append following (or random restart) lines until ``doc`` reaches
        ``target_len`` tokens (bert_dataset.py:152-175)."""
        starts = self.sentence_indices[filename]
        guard = 0
        while len(doc) < target_len and guard < 1000:
            guard += 1
            if line_idx < len(starts) - 1:
                line_idx += 1
            else:
                line_idx = int(rng.integers(len(starts)))
                doc = []
            doc = doc + self._read_line(filename, starts[line_idx])
        return doc, line_idx

    # -- masking -----------------------------------------------------------
    def mask_ids(self, ids: List[int], rng: np.random.Generator):
        """Whole-word MLM masking (bert_dataset.py:287-345): group subword
        continuations with their word, then mask each word with
        ``mask_prob``; masked words become [MASK] 80% / random token 10% /
        unchanged 10%.  Specials (CLS/SEP/EOS) are never masked."""
        tok = self.tokenizer
        tokens = tok.ids_to_tokens(ids)
        groups: List[List[int]] = []
        for pos, t in enumerate(tokens):
            if pos > 0 and tok.is_continuation(t):
                groups[-1].append(pos)
            else:
                groups.append([pos])

        special = {tok.cls_id, tok.sep_id, tok.eos_id}
        masked = list(ids)
        out_mask = [0] * len(ids)
        for g in groups:
            if ids[g[0]] in special or rng.random() > self.mask_prob:
                continue
            p = rng.random()
            for pos in g:
                out_mask[pos] = 1
                if p < 0.8:
                    masked[pos] = tok.mask_id
                elif p < 0.9:
                    r = int(rng.integers(self.vocab_size))
                    while r in (tok.cls_id, tok.sep_id):
                        r = int(rng.integers(self.vocab_size))
                    masked[pos] = r
        return masked, out_mask

    # -- item --------------------------------------------------------------
    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, idx))
        msl = self.max_seq_length
        max_num_tokens = msl - 3  # [CLS] a [SEP] b [EOS]
        target = max_num_tokens
        if rng.random() < self.short_seq_prob:
            target = int(rng.integers(2, max_num_tokens + 1))
        target_a = max(1, int(round(target * self.seq_a_ratio)))
        target_b = max(1, target - target_a)

        a_file = self.filenames[int(rng.integers(len(self.filenames)))]
        a_starts = self.sentence_indices[a_file]
        a_idx = int(rng.integers(len(a_starts)))
        a_doc = self._read_line(a_file, a_starts[a_idx])
        a_doc, a_idx = self._grow_to(a_doc, target_a, a_file, a_idx, rng)

        last = a_idx >= len(a_starts) - 1
        take_random_b = bool(rng.random() < 0.5) or last
        if take_random_b:
            b_file, b_idx = a_file, a_idx
            for _ in range(10):
                b_file = self.filenames[int(rng.integers(len(self.filenames)))]
                b_idx = int(rng.integers(len(self.sentence_indices[b_file])))
                if b_file != a_file or b_idx != a_idx:
                    break
        else:
            b_file, b_idx = a_file, a_idx + 1
        is_next = int(not take_random_b)
        b_starts = self.sentence_indices[b_file]
        b_doc = self._read_line(b_file, b_starts[b_idx])
        b_doc, b_idx = self._grow_to(b_doc, target_b, b_file, b_idx, rng)

        # truncate the pair from a random end (bert_dataset.py:231-253)
        while len(a_doc) + len(b_doc) > max_num_tokens:
            doc = a_doc if len(a_doc) > len(b_doc) else b_doc
            if len(doc) <= 1:
                raise ValueError(
                    "corpus too small to fill a sequence pair to "
                    f"max_seq_length={msl}"
                )
            if rng.random() < 0.5:
                del doc[0]
            else:
                doc.pop()

        tok = self.tokenizer
        output_ids = [tok.cls_id] + a_doc + [tok.sep_id] + b_doc + [tok.eos_id]
        input_ids, output_mask = self.mask_ids(output_ids, rng)

        n = len(input_ids)
        input_mask = np.zeros(msl, np.int32)
        input_mask[:n] = 1
        input_type_ids = np.zeros(msl, np.int32)
        input_type_ids[len(a_doc) + 2 : n] = 1  # segment B incl. [EOS]
        pad = msl - n
        input_ids = np.asarray(input_ids + [tok.pad_id] * pad, np.int32)
        output_ids = np.asarray(output_ids + [tok.pad_id] * pad, np.int32)
        output_mask = np.asarray(output_mask + [0] * pad, np.float32)
        return {
            "input_ids": input_ids,
            "input_type_ids": input_type_ids,
            "input_mask": input_mask,
            "output_ids": output_ids,
            "output_mask": output_mask,
            "is_next": np.int32(is_next),
        }

    @staticmethod
    def collate(items, buckets=None):
        return {k: np.stack([i[k] for i in items]) for k in items[0]}


class BertPretrainingPreprocessedDataset:
    """Already-masked arrays -> the same item dict
    (bert_dataset.py:347-406).  ``input_file`` is ``.npz`` with keys
    ``input_ids``, ``input_mask``, ``segment_ids``, ``masked_lm_positions``,
    ``masked_lm_ids``, ``next_sentence_labels`` (``.h5``/``.hdf5`` accepted
    when h5py is importable).  ``masked_lm_positions`` rows are
    zero-padded; position 0 marks the end of real predictions (it can never
    be a real mask position — it is always [CLS])."""

    KEYS = ["input_ids", "input_mask", "segment_ids", "masked_lm_positions",
            "masked_lm_ids", "next_sentence_labels"]

    def __init__(self, input_file: str, max_predictions_per_seq: int):
        self.max_predictions_per_seq = int(max_predictions_per_seq)
        if input_file.endswith((".h5", ".hdf5")):
            try:
                import h5py  # pragma: no cover - an optional package
            except ImportError as e:  # pragma: no cover
                raise ImportError(
                    "h5py is not available; convert the shard to .npz "
                    "(np.savez with the same keys)"
                ) from e
            with h5py.File(input_file, "r") as f:  # pragma: no cover
                self.inputs = [np.asarray(f[k][:]) for k in self.KEYS]
        else:
            with np.load(input_file) as f:
                self.inputs = [np.asarray(f[k]) for k in self.KEYS]
        msl = self.inputs[0].shape[1]
        self.lengths = [float(msl)] * len(self.inputs[0])

    def __len__(self) -> int:
        return len(self.inputs[0])

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        input_ids, input_mask, segment_ids, lm_pos, lm_ids, nsp = (
            a[index] for a in self.inputs
        )
        k = self.max_predictions_per_seq
        padded = np.flatnonzero(lm_pos == 0)
        if padded.size:
            k = int(padded[0])
        output_mask = np.zeros_like(input_ids, np.float32)
        output_ids = input_ids.astype(np.int32).copy()
        output_mask[lm_pos[:k]] = 1.0
        output_ids[lm_pos[:k]] = lm_ids[:k]
        return {
            "input_ids": input_ids.astype(np.int32),
            "input_type_ids": segment_ids.astype(np.int32),
            "input_mask": input_mask.astype(np.int32),
            "output_ids": output_ids,
            "output_mask": output_mask,
            "is_next": np.int32(nsp),
        }

    collate = staticmethod(BertPretrainingDataset.collate)


class BertPretrainingFileLoader:
    """Epoch iterator over preprocessed shard files
    (bert_dataset.py:409-454): shuffles the file list with a shared seed
    (same order on every process), then yields collated batches, sharding
    batch indices ``shard_rank::num_shards`` across processes."""

    def __init__(self, data_files: List[str], max_predictions_per_seq: int,
                 batch_size: int, seed: int = 42,
                 num_shards: int = 1, shard_rank: int = 0):
        self.data_files = list(data_files)
        self.max_predictions_per_seq = int(max_predictions_per_seq)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.num_shards = int(num_shards)
        self.shard_rank = int(shard_rank)
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def __iter__(self):
        order = np.random.default_rng((self.seed, self._epoch)).permutation(
            len(self.data_files)
        )
        for fi in order:
            ds = BertPretrainingPreprocessedDataset(
                self.data_files[int(fi)], self.max_predictions_per_seq
            )
            n_batches = len(ds) // self.batch_size
            for b in range(self.shard_rank, n_batches, self.num_shards):
                idxs = range(b * self.batch_size, (b + 1) * self.batch_size)
                yield ds.collate([ds[i] for i in idxs])
