"""Character-level text parsers (cleaning + id mapping).

The port's copy of roar_tpu/data/parsers.py (host code, pure Python; the same
labels and text give the same ids, and the same None on a normalisation
failure).  It covers the capability of roar/collections/common/parts/preprocessing/
parsers.py (CharParser :12, ENCharParser :108, RUCharParser :162,
make_parser :209) — the text path FastPitchModel takes when
`learn_alignment` is false (models/fastpitch.py:277-285).  The design here
is data-driven rather than a subclass ladder: one `CharParser` does the
id mapping, and locale behavior (punctuation replacement map + the full
cleaners pipeline) is a single `CleaningCharParser` parameterized by a
`replacements` dict, with "en"/"ru" as registry entries.

Contract (held against the JAX package by tests/test_torch_parsers.py):
  * labels index == token id; multi-character labels match whole
    space-delimited words; a space token joins words; ids equal to
    `blank_id` are dropped (so unk==blank silently removes OOV).
  * normalization failures return None (callers skip the utterance).
  * decode() maps ids back to labels, tolerating BOS/EOS/pad extras
    appended after the label vocabulary.

The ASR-dataset CharParser (roar_tpu/data/asr_datasets.py, not ported) is the bare id-mapping
variant without cleaning.
"""

from __future__ import annotations

import string
from itertools import chain
from typing import Dict, Iterable, List, Optional, Sequence

from roar_tpu_torch.data import cleaners

_VIRTUAL_TAIL = ("<BOS>", "<EOS>", "<P>")


def _punctuation_table(keep: Iterable[str]) -> Dict[int, str]:
    """str.translate table mapping ASCII punctuation to spaces, except the
    characters in `keep` (replacement keys and in-vocabulary labels)."""
    kept = set(keep)
    return str.maketrans({c: " " for c in string.punctuation if c not in kept})


class CharParser:
    """Maps a string to a list of int token ids.

    Words (space-delimited) are looked up whole against the multi-char
    labels first; otherwise each character maps through the vocabulary,
    OOV characters becoming `unk_id`.  Ids equal to `blank_id` are
    filtered from the result.
    """

    def __init__(
        self,
        labels: Sequence[str],
        *,
        unk_id: int = -1,
        blank_id: int = -1,
        do_normalize: bool = True,
        do_lowercase: bool = True,
        do_tokenize: bool = True,
    ):
        self._labels = list(labels)
        self._unk_id = unk_id
        self._blank_id = blank_id
        self._do_normalize = do_normalize
        self._do_lowercase = do_lowercase
        self._do_tokenize = do_tokenize
        self._id_of: Dict[str, int] = {s: i for i, s in enumerate(self._labels)}
        self._word_labels = frozenset(s for s in self._labels if len(s) > 1)
        self._space_id = self._id_of.get(" ", unk_id)
        # decode table: label per id, plus the virtual tail ids some models
        # append after the vocabulary (BOS/EOS/pad).
        self._decode_table: Dict[int, str] = dict(enumerate(self._labels))
        for offset, name in enumerate(_VIRTUAL_TAIL):
            self._decode_table[len(self._labels) + offset] = name

    # -- public API ---------------------------------------------------------

    def __call__(self, text: str):
        if self._do_normalize:
            text = self._normalize(text)
            if text is None:
                return None
        if not self._do_tokenize:
            return text
        return self._tokenize(text)

    def decode(self, ids) -> str:
        table = self._decode_table
        return "".join(table[i] for i in map(int, ids) if i in table)

    # -- pieces subclasses/registry entries override ------------------------

    def _normalize(self, text: str) -> Optional[str]:
        text = text.strip()
        return text.lower() if self._do_lowercase else text

    def _encode_word(self, word: str) -> List[int]:
        if word in self._word_labels:
            return [self._id_of[word]]
        lookup = self._id_of.get
        return [lookup(c, self._unk_id) for c in word]

    def _tokenize(self, text: str) -> List[int]:
        pieces = (self._encode_word(w) for w in text.split(" "))
        joined = chain.from_iterable(
            ids if i == 0 else chain([self._space_id], ids)
            for i, ids in enumerate(pieces)
        )
        blank = self._blank_id
        return [t for t in joined if t != blank]


class CleaningCharParser(CharParser):
    """CharParser whose normalization runs the full `cleaners.clean_text`
    pipeline (abbreviations, numbers, currency, transliteration) with a
    locale-specific punctuation `replacements` map.

    Replaces the reference's ENCharParser/RUCharParser pair
    (parsers.py:108-206): both were the same class with different constant
    tables, so here the table is a constructor argument.
    """

    PUNCTUATION_TO_REPLACE: Dict[str, str] = {}

    def __init__(
        self,
        labels: Sequence[str],
        *,
        replacements: Optional[Dict[str, str]] = None,
        abbreviation_version: Optional[str] = None,
        make_table: bool = True,
        **kwargs,
    ):
        super().__init__(labels, **kwargs)
        self.replacements = (
            dict(replacements)
            if replacements is not None
            else dict(self.PUNCTUATION_TO_REPLACE)
        )
        self.abbreviation_version = abbreviation_version
        self._table = (
            _punctuation_table(chain(self.replacements, self._labels))
            if make_table
            else None
        )

    def _normalize(self, text: str) -> Optional[str]:
        try:
            return cleaners.clean_text(
                string=text,
                table=self._table,
                punctuation_to_replace=self.replacements,
                abbreviation_version=self.abbreviation_version,
            )
        except Exception:
            return None


class ENCharParser(CleaningCharParser):
    PUNCTUATION_TO_REPLACE = {"+": "plus", "&": "and", "%": "percent"}


class RUCharParser(CleaningCharParser):
    PUNCTUATION_TO_REPLACE = {"+": "плюс", "ё": "е"}


NAME_TO_PARSER = {"base": CharParser, "en": ENCharParser, "ru": RUCharParser}


def make_parser(
    labels: Optional[Sequence[str]] = None, name: str = "base", **kwargs
) -> CharParser:
    """Parser factory keyed by locale name (parsers.py:209-244 surface)."""
    try:
        cls = NAME_TO_PARSER[name]
    except KeyError:
        raise ValueError(
            f"Invalid parser name {name!r}; choose from {sorted(NAME_TO_PARSER)}"
        ) from None
    if labels is None:
        labels = list(string.printable)
    return cls(labels=labels, **kwargs)
