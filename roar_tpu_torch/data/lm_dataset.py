"""The causal-LM data layer: a word-level tokenizer and packed next-token blocks.

Port of the parts of roar_tpu/data/lm_dataset.py that GPT pretraining uses
(`find_newlines`, `SimpleWordTokenizer`, `CausalLMDataset`); numpy only.  The
three BERT pretraining datasets of that module are not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

__all__ = ["find_newlines", "SimpleWordTokenizer", "CausalLMDataset"]


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
