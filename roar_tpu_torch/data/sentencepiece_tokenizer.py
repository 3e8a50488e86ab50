"""SentencePiece tokenizer wrapper.

A copy of roar_tpu/data/sentencepiece_tokenizer.py for the port (pure
Python; it imports nothing of torch or of the JAX package): the reference
wrapper's API over a trained `.model` file, including legacy-mode
special-token splicing (special tokens are matched as literal substrings and
mapped to ids appended after the base vocabulary).

The `sentencepiece` package is optional: without it, constructing the
tokenizer raises a clear ImportError, and the rest of the port works.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Union

import numpy as np

try:
    import sentencepiece as _spm
except ImportError:  # pragma: no cover - exercised via the gate test
    _spm = None


class SentencePieceTokenizer:
    def __init__(
        self,
        model_path: str,
        special_tokens: Optional[Union[Dict[str, str], List[str]]] = None,
        legacy: bool = False,
    ):
        if _spm is None:
            raise ImportError(
                "SentencePieceTokenizer requires the `sentencepiece` package, "
                "which is not installed in this environment."
            )
        if not model_path or not os.path.exists(model_path):
            raise ValueError(f"model_path: {model_path} is invalid")
        self.tokenizer = _spm.SentencePieceProcessor()
        self.tokenizer.Load(model_path)

        self.original_vocab_size = self.tokenizer.get_piece_size()
        self.vocab_size = self.tokenizer.get_piece_size()
        self.legacy = legacy
        self.special_token_to_id: Dict[str, int] = {}
        self.id_to_special_token: Dict[int, str] = {}
        if special_tokens:
            if not self.legacy:
                raise ValueError(
                    "Special tokens must be None when legacy is False. "
                    "Provide special tokens at train time."
                )
            self.add_special_tokens(special_tokens)
        self.space_sensitive = self.text_to_tokens("x y") != (
            self.text_to_tokens("x") + self.text_to_tokens("y")
        )

    # -- special-token-aware segmentation (legacy mode) -------------------
    def _split_on_special(self, text: str):
        """Yield (plain_segment, special_or_None) pairs scanning left to
        right for the earliest special-token literal."""
        idx = 0
        while True:
            hits = {
                tok: text.index(tok, idx)
                for tok in self.special_token_to_id
                if tok in text[idx:]
            }
            if not hits:
                break
            tok = min(hits, key=hits.get)
            yield text[idx : hits[tok]], tok
            idx = hits[tok] + len(tok)
        yield text[idx:], None

    def text_to_tokens(self, text: str) -> List[str]:
        if self.legacy:
            out: List[str] = []
            for seg, special in self._split_on_special(text):
                out.extend(self.tokenizer.encode_as_pieces(seg))
                if special is not None:
                    out.append(special)
            return out
        return self.tokenizer.encode_as_pieces(text)

    def text_to_ids(self, text: str) -> List[int]:
        if self.legacy:
            out: List[int] = []
            for seg, special in self._split_on_special(text):
                out.extend(self.tokenizer.encode_as_ids(seg))
                if special is not None:
                    out.append(self.special_token_to_id[special])
            return out
        return self.tokenizer.encode_as_ids(text)

    def tokens_to_text(self, tokens) -> str:
        if isinstance(tokens, np.ndarray):
            tokens = tokens.tolist()
        return self.tokenizer.decode_pieces(tokens)

    def ids_to_text(self, ids) -> str:
        if isinstance(ids, np.ndarray):
            ids = ids.tolist()
        if self.legacy:
            parts: List[str] = []
            last = 0
            for i, tid in enumerate(ids):
                if tid in self.id_to_special_token:
                    parts.append(self.tokenizer.decode_ids(ids[last:i]))
                    parts.append(self.id_to_special_token[tid])
                    last = i + 1
            parts.append(self.tokenizer.decode_ids(ids[last:]))
            return " ".join(p for p in parts if p).strip()
        return self.tokenizer.decode_ids(ids)

    def token_to_id(self, token: str) -> int:
        if self.legacy and token in self.special_token_to_id:
            return self.special_token_to_id[token]
        return self.tokenizer.piece_to_id(token)

    def ids_to_tokens(self, ids) -> List[str]:
        return [
            self.id_to_special_token[i]
            if i >= self.original_vocab_size
            else self.tokenizer.id_to_piece(i)
            for i in ids
        ]

    def tokens_to_ids(self, tokens: Union[str, List[str]]) -> List[int]:
        if isinstance(tokens, str):
            tokens = [tokens]
        return [self.token_to_id(t) for t in tokens]

    def add_special_tokens(self, special_tokens) -> None:
        if not self.legacy:
            raise AttributeError(
                "Special token addition requires legacy=True."
            )
        items = (
            special_tokens.items()
            if isinstance(special_tokens, dict)
            else ((None, t) for t in special_tokens)
        )
        for name, token in items:
            if name is not None:
                setattr(self, name, token)
            if (
                self.tokenizer.piece_to_id(token) == self.tokenizer.unk_id()
                and token not in self.special_token_to_id
            ):
                self.special_token_to_id[token] = self.vocab_size
                self.id_to_special_token[self.vocab_size] = token
                self.vocab_size += 1

    # -- reserved ids ------------------------------------------------------
    def _named_id(self, attr: str, native) -> int:
        if self.legacy:
            return self.tokens_to_ids([getattr(self, attr)])[0]
        return native()

    @property
    def pad_id(self) -> int:
        return self._named_id("pad_token", self.tokenizer.pad_id)

    @property
    def bos_id(self) -> int:
        return self._named_id("bos_token", self.tokenizer.bos_id)

    @property
    def eos_id(self) -> int:
        return self._named_id("eos_token", self.tokenizer.eos_id)

    @property
    def unk_id(self) -> int:
        return self.tokenizer.unk_id()

    @property
    def sep_id(self) -> int:
        if self.legacy:
            return self.tokens_to_ids([self.sep_token])[0]
        raise NameError("Use function token_to_id to retrieve special tokens")

    @property
    def cls_id(self) -> int:
        if self.legacy:
            return self.tokens_to_ids([self.cls_token])[0]
        raise NameError("Use function token_to_id to retrieve special tokens")

    @property
    def mask_id(self) -> int:
        if self.legacy:
            return self.tokens_to_ids([self.mask_token])[0]
        raise NameError("Use function token_to_id to retrieve special tokens")

    @property
    def additional_special_tokens_ids(self) -> List[int]:
        """Ids of all special tokens except the named ones."""
        named = {
            getattr(self, name)
            for name in ("bos_token", "eos_token", "pad_token", "mask_token",
                         "cls_token", "sep_token")
            if hasattr(self, name)
        }
        return [v for k, v in self.special_token_to_id.items() if k not in named]

    @property
    def vocab(self) -> List[str]:
        main = [
            self.tokenizer.id_to_piece(i) for i in range(self.original_vocab_size)
        ]
        extra = [
            self.id_to_special_token[i]
            for i in range(self.original_vocab_size, self.vocab_size)
        ]
        return main + extra
