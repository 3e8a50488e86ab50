"""The port's text cleaners and character parsers against the JAX package's,
on the inputs of tests/test_parsers_cleaners.py: the same words, cleaned
strings and ids, id for id, and the same None on a normalisation failure."""

import pytest

from roar_tpu_torch.data import cleaners, parsers

EN_LABELS = list("abcdefghijklmnopqrstuvwxyz '")
NUMBERS = [0, 7, 14, 20, 42, 100, 123, 1000, 1234, 1000000, "3.5", "0.25"]
ORDINALS = [1, 2, 3, 4, 5, 9, 12, 20, 21, 100]
TEXTS = ["Dr. Smith", "Mt. St. Helens", "$5.50", "$1.00", "$1", "at 7:30pm", "at 9:00",
         "the 2nd time", "25% of A&B", "1+1", "Café naïve", "1,234 people",
         "Mr. Jones bought 2 cars.", "It's 3:15am; Prof. X paid $12.05!"]
# (labels, keyword arguments, text) of the bare CharParser
CHAR_CASES = [(["a", "b", "c"], {}, "abc"),
              (["a", "b"], {"unk_id": -1, "blank_id": -1}, "axb"),
              (["a", " ", "<sp>"], {}, "a <sp>"),
              (list("abc "), {}, "ab c"),
              (list("abc "), {"unk_id": 3, "blank_id": -1}, "abxd c"),
              (list("abc "), {"do_lowercase": False}, "AbC")]


def _outcome(fn, *args):
    """fn's result, or the type of what it raised."""
    try:
        return fn(*args)
    except Exception as e:  # the same failure on both sides is a match
        return type(e).__name__


def _jax():
    from roar_tpu.data import cleaners as jax_cleaners
    from roar_tpu.data import parsers as jax_parsers

    return jax_cleaners, jax_parsers


@pytest.mark.parametrize("n", NUMBERS)
def test_number_to_words_matches_jax(n):
    jax_cleaners, _ = _jax()
    assert cleaners.number_to_words(n) == jax_cleaners.number_to_words(n)


@pytest.mark.parametrize("n", ORDINALS)
def test_ordinals_match_jax(n):
    jax_cleaners, _ = _jax()
    assert cleaners.number_to_words(n, ordinal=True) == \
        jax_cleaners.number_to_words(n, ordinal=True)


@pytest.mark.parametrize("text", TEXTS)
@pytest.mark.parametrize("name", ["en", "ru"])
def test_clean_text_and_parser_ids_match_jax(text, name):
    _, jax_parsers = _jax()
    ours = parsers.make_parser(EN_LABELS, name)
    theirs = jax_parsers.make_parser(EN_LABELS, name)
    for version in (None, "fastpitch"):
        assert _outcome(cleaners.clean_text, text, ours._table, ours.replacements, version) == \
            _outcome(_jax()[0].clean_text, text, theirs._table, theirs.replacements, version)
    assert ours(text) == theirs(text)
    if ours(text) is not None:
        assert ours.decode(ours(text)) == theirs.decode(theirs(text))


@pytest.mark.parametrize("labels,kwargs,text", CHAR_CASES)
def test_char_parser_matches_jax(labels, kwargs, text):
    _, jax_parsers = _jax()
    ours, theirs = parsers.CharParser(labels, **kwargs), jax_parsers.CharParser(labels, **kwargs)
    assert ours(text) == theirs(text)
    assert ours.decode(ours(text) + [len(labels), len(labels) + 2]) == \
        theirs.decode(theirs(text) + [len(labels), len(labels) + 2])


def test_failures_and_the_default_labels_match_jax():
    _, jax_parsers = _jax()
    assert parsers.ENCharParser(labels=["a"], make_table=True)(None) is None
    assert jax_parsers.ENCharParser(labels=["a"], make_table=True)(None) is None
    with pytest.raises(ValueError, match="Invalid parser name"):
        parsers.make_parser(["a"], name="nope")
    assert parsers.make_parser()("Hi 5") == jax_parsers.make_parser()("Hi 5")
    assert parsers.make_parser(EN_LABELS, "en")("Mr. Jones bought 2 cars.") == \
        jax_parsers.make_parser(EN_LABELS, "en")("Mr. Jones bought 2 cars.")
    ours = parsers.make_parser(EN_LABELS, "en")
    assert ours.decode(ours("Mr. Jones bought 2 cars.")) == "mister jones bought two cars"
