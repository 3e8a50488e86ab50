"""The port's SentencePiece shell (roar_tpu_torch/data/sentencepiece_tokenizer.py)
without the `sentencepiece` package: the clear ImportError, and, through a
stub processor put in the package's place, the legacy special-token splicing
and the reserved ids, each equal to what roar_tpu/data/sentencepiece_tokenizer.py
gives with the same stub."""

import numpy as np
import pytest

from roar_tpu.data import sentencepiece_tokenizer as jsp
from roar_tpu_torch.data import sentencepiece_tokenizer as tsp

PIECES = ["<unk>", "<s>", "</s>", "▁a", "▁b", "c", "▁", "[PAD]"]


class StubProcessor:
    """A character-level stand-in for `SentencePieceProcessor`: each word
    is `▁` + its first letter if that is a piece, then one piece a
    letter."""

    def Load(self, path):
        self.loaded = path

    def get_piece_size(self):
        return len(PIECES)

    def piece_to_id(self, piece):
        return PIECES.index(piece) if piece in PIECES else 0

    def id_to_piece(self, i):
        return PIECES[i]

    def unk_id(self):
        return 0

    def pad_id(self):
        return 7

    def bos_id(self):
        return 1

    def eos_id(self):
        return 2

    def encode_as_pieces(self, text):
        out = []
        for word in text.split():
            first = "▁" + word[0]
            out += [first] if first in PIECES else ["▁", word[0]]
            out += list(word[1:])
        return out

    def encode_as_ids(self, text):
        return [self.piece_to_id(p) for p in self.encode_as_pieces(text)]

    def decode_pieces(self, pieces):
        return "".join(pieces).replace("▁", " ").strip()

    def decode_ids(self, ids):
        return self.decode_pieces([PIECES[i] for i in ids])


class StubPackage:
    SentencePieceProcessor = StubProcessor


SPECIALS = {"cls_token": "[CLS]", "sep_token": "[SEP]", "mask_token": "[MASK]",
            "pad_token": "[PAD]", "bos_token": "<s>", "eos_token": "</s>"}


def test_without_the_package_construction_raises_a_clear_import_error(tmp_path,
                                                                       monkeypatch):
    monkeypatch.setattr(tsp, "_spm", None)
    with pytest.raises(ImportError, match="sentencepiece"):
        tsp.SentencePieceTokenizer(str(tmp_path / "m.model"))


def _pair(tmp_path, monkeypatch, **kw):
    model = tmp_path / "stub.model"
    model.write_bytes(b"stub")
    monkeypatch.setattr(tsp, "_spm", StubPackage)
    monkeypatch.setattr(jsp, "_spm", StubPackage)
    return (tsp.SentencePieceTokenizer(str(model), **kw),
            jsp.SentencePieceTokenizer(str(model), **kw))


def test_legacy_special_tokens_splice_as_the_jax_package_s(tmp_path, monkeypatch):
    tok, jtok = _pair(tmp_path, monkeypatch, special_tokens=SPECIALS, legacy=True)
    # [PAD], <s>, </s> are pieces already: only three new ids after the 8 pieces
    assert tok.vocab_size == jtok.vocab_size == 11
    assert tok.special_token_to_id == jtok.special_token_to_id == {
        "[CLS]": 8, "[SEP]": 9, "[MASK]": 10}
    text = "[CLS]ab c[SEP] b[MASK]cc"
    assert tok.text_to_tokens(text) == jtok.text_to_tokens(text)
    ids = tok.text_to_ids(text)
    assert ids == jtok.text_to_ids(text) and ids[0] == 8 and 9 in ids and 10 in ids
    assert tok.ids_to_text(np.asarray(ids)) == jtok.ids_to_text(ids)
    assert tok.ids_to_tokens(ids) == jtok.ids_to_tokens(ids)
    assert tok.tokens_to_ids("[SEP]") == [9]
    named = ("pad_id", "bos_id", "eos_id", "unk_id", "sep_id", "cls_id", "mask_id")
    assert [getattr(tok, n) for n in named] == [getattr(jtok, n) for n in named] \
        == [7, 1, 2, 0, 9, 8, 10]
    assert tok.additional_special_tokens_ids == jtok.additional_special_tokens_ids == []
    assert tok.vocab == jtok.vocab == PIECES + ["[CLS]", "[SEP]", "[MASK]"]
    assert tok.space_sensitive == jtok.space_sensitive


def test_non_legacy_mode_is_the_processor_s_own(tmp_path, monkeypatch):
    tok, jtok = _pair(tmp_path, monkeypatch)
    text = "ab b cc"
    # "b" alone is no piece: <unk>
    assert tok.text_to_ids(text) == jtok.text_to_ids(text) == [3, 0, 4, 6, 5, 5]
    assert tok.ids_to_text([3, 4]) == jtok.ids_to_text([3, 4]) == "a b"
    assert (tok.pad_id, tok.bos_id, tok.eos_id) == (7, 1, 2)
    with pytest.raises(NameError):
        tok.sep_id
    with pytest.raises(AttributeError, match="legacy"):
        tok.add_special_tokens(["[X]"])
    with pytest.raises(ValueError, match="legacy"):
        tsp.SentencePieceTokenizer(str(tmp_path / "stub.model"), special_tokens=["[X]"])
    with pytest.raises(ValueError, match="invalid"):
        tsp.SentencePieceTokenizer(str(tmp_path / "missing.model"))
