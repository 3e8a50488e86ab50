"""Character tokenizers for TTS, including the Indic family.

A copy of roar_tpu/data/tokenizers.py (host code, no jax), kept so that the
port imports nothing from roar_tpu: importing roar_tpu.data loads jax.
Token ids must stay equal to the JAX package's (tests/test_torch_serving.py).

Re-implements the reference tokenizer semantics
(roar/collections/common/tokenizers/text_to_speech/tts_tokenizers.py:21-446):
dynamic pad/blank/oov ids appended after the base token list, whitespace
collapsing, punctuation filtering, unicode-range Indic character sets with
mixed-language ascii + digits, and the same text preprocessing (NFC
normalization, right-single-quote -> apostrophe).

Note: the reference's `get_characters_from_range`
(tokenizer_utils.py:45-53) passes an int code point to unicodedata.category,
which raises TypeError — we implement the evidently intended behavior
(filter unassigned "Cn" code points) correctly.
"""

from __future__ import annotations

import re
import string
import unicodedata
import warnings
from typing import List, Optional, Sequence, Tuple

from roar_tpu_torch.data.ipa_lexicon import (
    get_ipa_character_set,
    get_ipa_punctuation_list,
    validate_locale,
)

# Derived from LJSpeech (tokenizer_utils.py:18-22)
_SYNOGLYPHS = {"'": ["’"], '"': ["”", "“"]}
SYNOGLYPH2ASCII = {g: a for a, gs in _SYNOGLYPHS.items() for g in gs}

# https://en.wikipedia.org/wiki/List_of_Unicode_characters (tokenizer_utils.py:33-36)
LATIN_ALPHABET_BASIC = "A-Za-z"
ACCENTED_CHARS = "À-ÖØ-öø-ÿ"
LATIN_CHARS_ALL = LATIN_ALPHABET_BASIC + ACCENTED_CHARS


def _words_re(charset: str) -> re.Pattern:
    """Three alternatives per match: a word, a |literal span|, or a run of
    punctuation/whitespace (tokenizer_utils.py:24-42)."""
    return re.compile(
        rf"([{charset}]+(?:[{charset}\-']*[{charset}]+)*)"
        rf"|(\|[^|]*\|)"
        rf"|([^{charset}|]+)"
    )


_WORDS_RE_EN = _words_re(LATIN_ALPHABET_BASIC)
_WORDS_RE_ANY_LOCALE = _words_re(LATIN_CHARS_ALL)


def _word_tokenize(matches, is_lower: bool = False) -> List[Tuple[List[str], bool]]:
    """(word, |unchanged|, punct) regex groups -> [(tokens, is_unchanged)].
    Spans wrapped in `|...|` pass through G2P untouched
    (tokenizer_utils.py:121-182)."""
    out: List[Tuple[List[str], bool]] = []
    for word, unchanged, punct in matches:
        if word:
            out.append(([word.lower() if is_lower else word], False))
        elif punct:
            out.append(([punct], False))
        elif unchanged:
            out.append((unchanged[1:-1].split(" "), True))
        else:
            raise ValueError("Empty match — check the word regex")
    return out


def english_word_tokenize(text: str) -> List[Tuple[List[str], bool]]:
    return _word_tokenize(_WORDS_RE_EN.findall(text), is_lower=True)


def any_locale_word_tokenize(text: str) -> List[Tuple[List[str], bool]]:
    return _word_tokenize(_WORDS_RE_ANY_LOCALE.findall(text))


def spanish_text_preprocessing(text: str) -> str:
    return text.lower()


def chinese_text_preprocessing(text: str) -> str:
    return text


def normalize_unicode_text(text: str) -> str:
    if not unicodedata.is_normalized("NFC", text):
        text = unicodedata.normalize("NFC", text)
    return text


def any_locale_text_preprocessing(text: str) -> str:
    """NFC-normalize; map right single quotation mark to apostrophe
    (tokenizer_utils.py:73-90)."""
    return "".join(
        "'" if c == "’" else c for c in normalize_unicode_text(text)
    )


def english_text_preprocessing(text: str, lower: bool = True) -> str:
    """Strip combining marks (NFD), fold synoglyphs, lowercase
    (tokenizer_utils.py:56-70)."""
    text = "".join(
        c for c in unicodedata.normalize("NFD", text) if unicodedata.category(c) != "Mn"
    )
    text = "".join(SYNOGLYPH2ASCII.get(c, c) for c in text)
    return text.lower() if lower else text


def get_characters_from_range(start_char: str, end_char: str) -> List[str]:
    """All assigned characters in [start_char, end_char]."""
    return [
        chr(code)
        for code in range(ord(start_char), ord(end_char) + 1)
        if unicodedata.category(chr(code)) != "Cn"
    ]


class BaseTokenizer:
    """Token-list bookkeeping with dynamically-assigned pad/blank/oov ids
    (tts_tokenizers.py:21-79)."""

    PAD, BLANK, OOV = "<pad>", "<blank>", "<oov>"

    def __init__(
        self,
        tokens: Sequence[str],
        *,
        pad: str = PAD,
        blank: str = BLANK,
        oov: str = OOV,
        sep: str = "",
        add_blank_at: Optional[str] = None,
    ):
        tokens = list(tokens)
        self.pad, tokens = len(tokens), tokens + [pad]
        if add_blank_at is not None:
            self.blank, tokens = len(tokens), tokens + [blank]
        else:
            self.blank = None
        self.oov, tokens = len(tokens), tokens + [oov]
        if add_blank_at == "last":
            tokens[-1], tokens[-2] = tokens[-2], tokens[-1]
            self.oov, self.blank = self.blank, self.oov

        self.tokens = tokens
        self.sep = sep
        self._util_ids = {self.pad, self.blank, self.oov}
        self._token2id = {t: i for i, t in enumerate(tokens)}
        self._id2token = tokens

    def __len__(self) -> int:
        return len(self.tokens)

    def __call__(self, text: str) -> List[int]:
        return self.encode(text)

    def encode(self, text: str) -> List[int]:
        raise NotImplementedError

    def decode(self, ids: Sequence[int]) -> str:
        return self.sep.join(
            self._id2token[i] for i in ids if i not in self._util_ids
        )


class BaseCharsTokenizer(BaseTokenizer):
    """Char tokenizer with space handling + punctuation
    (tts_tokenizers.py:81-161)."""

    PUNCT_LIST = (
        ',', '.', '!', '?', '-',
        ':', ';', '/', '"', '(', "'",
        ')', '[', ']', '{', '}',
    )

    def __init__(
        self,
        chars: Sequence[str],
        punct: bool = True,
        apostrophe: bool = True,
        add_blank_at: Optional[str] = None,
        pad_with_space: bool = False,
        non_default_punct_list: Optional[Sequence[str]] = None,
        text_preprocessing_func=lambda x: x,
    ):
        tokens: List[str] = []
        self.space, tokens = len(tokens), tokens + [" "]
        tokens.extend(chars)
        if apostrophe:
            tokens.append("'")
        if punct:
            if non_default_punct_list is not None:
                self.PUNCT_LIST = tuple(non_default_punct_list)
            tokens.extend(self.PUNCT_LIST)
        super().__init__(tokens, add_blank_at=add_blank_at)
        self.punct = punct
        self.pad_with_space = pad_with_space
        self.text_preprocessing_func = text_preprocessing_func

    def encode(self, text: str) -> List[int]:
        cs: List[str] = []
        space = self.tokens[self.space]
        tokens = set(self.tokens)
        text = self.text_preprocessing_func(text)
        for c in text:
            if c == space and len(cs) > 0 and cs[-1] != space:
                cs.append(c)
            elif (c.isalnum() or c == "'") and c in tokens:
                cs.append(c)
            elif c in self.PUNCT_LIST and self.punct:
                cs.append(c)
            elif c != space:
                warnings.warn(
                    f"Text: [{text}] contains unknown char: [{c}]. Symbol will be skipped."
                )
        if cs:
            while cs and cs[-1] == space:
                cs.pop()
        if self.pad_with_space:
            cs = [space] + cs + [space]
        return [self._token2id[p] for p in cs]


class IndicCharsTokenizer(BaseCharsTokenizer):
    """Unicode-range Indic tokenizer with mixed-language ascii + digits
    (tts_tokenizers.py:163-263)."""

    PUNCT_LIST = (
        ',', '.', '!', '?', '-',
        ':', ';', '/', '"', '(',
        ')', '[', ']', '{', '}',
        '%', '$', '#', "'", " ",
        "–",
    )

    def __init__(
        self,
        chars: Optional[Sequence[str]] = None,
        punct: bool = True,
        apostrophe: bool = True,
        add_blank_at: Optional[str] = None,
        unicode_range: Optional[Tuple[str, str]] = None,
        pad_with_space: bool = False,
        non_default_punct_list: Optional[Sequence[str]] = None,
        process_mixed_language_chars: bool = True,
        text_preprocessing_func=any_locale_text_preprocessing,
    ):
        if chars is None and unicode_range is None:
            raise ValueError("Either chars or unicode_range must be provided.")
        if unicode_range:
            lo, hi = unicode_range
            self.in_unicode_range = lambda ch: lo <= ch <= hi
            char_list = get_characters_from_range(lo, hi)
        else:
            self.in_unicode_range = lambda ch: False
            char_list = [
                c
                for c in chars
                if c not in string.punctuation
                and c not in self.PUNCT_LIST
                and c.isprintable()
            ]
        self.process_mixed_language_chars = process_mixed_language_chars
        if process_mixed_language_chars:
            char_list.extend(string.ascii_lowercase)
        char_list.extend(map(str, range(10)))
        super().__init__(
            chars=char_list,
            punct=punct,
            apostrophe=apostrophe,
            add_blank_at=add_blank_at,
            pad_with_space=pad_with_space,
            non_default_punct_list=non_default_punct_list,
            text_preprocessing_func=text_preprocessing_func,
        )

    def encode(self, text: str) -> List[int]:
        cs: List[str] = []
        space = self.tokens[self.space]
        tokens = set(self.tokens)
        text = self.text_preprocessing_func(text)
        for c in text:
            if c == space and len(cs) > 0 and cs[-1] != space:
                cs.append(c)
            elif (self.in_unicode_range(c) or (c == "'" and c in tokens)) or c.isdigit():
                cs.append(c)
            elif self.process_mixed_language_chars and c.lower() in string.ascii_lowercase:
                cs.append(c.lower())
            elif c in self.PUNCT_LIST and self.punct:
                cs.append(c)
            elif c != space:
                warnings.warn(
                    f"Text: [{text}] contains unknown char: [{c}]. Symbol will be skipped."
                )
        if cs:
            while cs and cs[-1] == space:
                cs.pop()
        if self.pad_with_space:
            cs = [space] + cs + [space]
        return [self._token2id[p] for p in cs]


def _make_indic(name: str, lo: str, hi: str):
    def __init__(
        self,
        punct=True,
        apostrophe=True,
        add_blank_at=None,
        pad_with_space=False,
        non_default_punct_list=None,
        process_mixed_language_chars=True,
        text_preprocessing_func=any_locale_text_preprocessing,
    ):
        IndicCharsTokenizer.__init__(
            self,
            unicode_range=(lo, hi),
            punct=punct,
            apostrophe=apostrophe,
            add_blank_at=add_blank_at,
            pad_with_space=pad_with_space,
            non_default_punct_list=non_default_punct_list,
            process_mixed_language_chars=process_mixed_language_chars,
            text_preprocessing_func=text_preprocessing_func,
        )

    return type(name, (IndicCharsTokenizer,), {"UNICODE_RANGE": (lo, hi), "__init__": __init__})


# Same unicode blocks as tts_tokenizers.py:265-410.
TamilCharsTokenizer = _make_indic("TamilCharsTokenizer", "஀", "௿")
HindiCharsTokenizer = _make_indic("HindiCharsTokenizer", "ऀ", "ॿ")
BengaliCharsTokenizer = _make_indic("BengaliCharsTokenizer", "ঀ", "৿")
MalayalamCharsTokenizer = _make_indic("MalayalamCharsTokenizer", "ഀ", "ൿ")
TeluguCharsTokenizer = _make_indic("TeluguCharsTokenizer", "ఀ", "౿")
KannadaCharsTokenizer = _make_indic("KannadaCharsTokenizer", "ಀ", "೿")
GujaratiCharsTokenizer = _make_indic("GujaratiCharsTokenizer", "઀", "૿")
OdiaCharsTokenizer = _make_indic("OdiaCharsTokenizer", "଀", "୿")
GurmukhiCharsTokenizer = _make_indic("GurmukhiCharsTokenizer", "਀", "੿")


class EnglishCharsTokenizer(BaseCharsTokenizer):
    def __init__(
        self,
        punct=True,
        apostrophe=True,
        add_blank_at=None,
        pad_with_space=False,
        non_default_punct_list=None,
        text_preprocessing_func=english_text_preprocessing,
    ):
        super().__init__(
            chars=string.ascii_lowercase,
            punct=punct,
            apostrophe=apostrophe,
            add_blank_at=add_blank_at,
            pad_with_space=pad_with_space,
            non_default_punct_list=non_default_punct_list,
            text_preprocessing_func=text_preprocessing_func,
        )


class IPACharsTokenizer(BaseCharsTokenizer):
    """Char tokenizer over a locale's IPA phoneme inventory.

    The reference's IPA tokenizer variants are commented out in its tree
    (tts_tokenizers.py:7-11 imports from ipa_lexicon are disabled); this is a
    working equivalent: input text is assumed to already be IPA symbols
    (i.e. post-G2P), tokenized per codepoint against
    `ipa_lexicon.IPA_CHARACTER_SETS[locale]` plus the locale punctuation from
    `get_ipa_punctuation_list`.
    """

    def __init__(
        self,
        locale: str = "en-US",
        punct: bool = True,
        apostrophe: bool = True,
        add_blank_at: Optional[str] = None,
        pad_with_space: bool = False,
        non_default_punct_list: Optional[Sequence[str]] = None,
        text_preprocessing_func=any_locale_text_preprocessing,
    ):
        validate_locale(locale)
        self.locale = locale
        chars = sorted(get_ipa_character_set(locale))
        if non_default_punct_list is None and punct:
            non_default_punct_list = get_ipa_punctuation_list(locale)
        super().__init__(
            chars=chars,
            punct=punct,
            apostrophe=apostrophe,
            add_blank_at=add_blank_at,
            pad_with_space=pad_with_space,
            non_default_punct_list=non_default_punct_list,
            text_preprocessing_func=text_preprocessing_func,
        )

    def encode(self, text: str) -> List[int]:
        # IPA symbols are mostly non-alnum (ə, ʃ, combining marks), so the
        # base class's isalnum() gate is replaced by direct set membership.
        cs: List[str] = []
        space = self.tokens[self.space]
        tokens = set(self.tokens)
        text = self.text_preprocessing_func(text)
        for c in text:
            if c == space and len(cs) > 0 and cs[-1] != space:
                cs.append(c)
            elif c in tokens and c != space:
                cs.append(c)
            elif c in self.PUNCT_LIST and self.punct:
                cs.append(c)
            elif c != space:
                warnings.warn(
                    f"Text: [{text}] contains unknown char: [{c}]. Symbol will be skipped."
                )
        while cs and cs[-1] == space:
            cs.pop()
        if self.pad_with_space:
            cs = [space] + cs + [space]
        return [self._token2id[p] for p in cs]
