"""Per-locale grapheme/IPA character inventories and punctuation sets.

A copy of roar_tpu/data/ipa_lexicon.py (host code, no jax) for the port's
tokenizers.

Capability port of the reference ipa_lexicon.py (roar/collections/common/
tokenizers/text_to_speech/ipa_lexicon.py:1-352): the same public surface
(SUPPORTED_LOCALES, DEFAULT_PUNCTUATION, VITS_PUNCTUATION,
GRAPHEME_CHARACTER_SETS, IPA_CHARACTER_SETS, validate_locale,
get_grapheme_character_set, get_ipa_character_set,
get_ipa_punctuation_list) built from compact string tables.
"""

from __future__ import annotations

import string
from typing import List, Set

SUPPORTED_LOCALES = ["en-US", "de-DE", "es-ES"]

DEFAULT_PUNCTUATION = tuple(',.!?-:;/"()[]{}')

VITS_PUNCTUATION = tuple(',.!?-:;"«»“”¡¿—…')

# Upper-case alphabets per locale: ASCII base plus locale-specific letters.
GRAPHEME_CHARACTER_SETS = {
    "en-US": tuple(string.ascii_uppercase),
    "es-ES": tuple(string.ascii_uppercase + "ÁÉÍÑÓÚÜ"),
    # https://en.wikipedia.org/wiki/German_orthography#Alphabet
    "de-DE": tuple(string.ascii_uppercase + "ÄÖÜẞ"),
}

# Phoneme inventories (post-G2P symbol sets, one codepoint per symbol —
# combining marks like the nasalization tilde count as their own symbol).
IPA_CHARACTER_SETS = {
    "en-US": tuple("abdefhijklmnoprstuvwxzæðŋɐɑɔəɚɛɜɡɪɬɹɾʃʊʌʒʔʲ̩̃θᵻ"),
    "es-ES": tuple("abdefhijklmnoprstuwxðŋɛɡɣɪɲɾʃʊʎʒʝβθ"),
    "de-DE": tuple("1abdefhijklmnoprstuvwxyzçøŋœɐɑɒɔəɛɜɡɪɹɾʃʊʌʒ̃θ"),
}

GRAPHEME_CHARACTER_CASES = ["upper", "lower", "mixed"]


def validate_locale(locale: str) -> None:
    if locale not in SUPPORTED_LOCALES:
        raise ValueError(
            f"Unsupported locale '{locale}'. Supported locales {SUPPORTED_LOCALES}"
        )


def get_grapheme_character_set(locale: str, case: str = "upper") -> str:
    """Locale alphabet as one string, in the requested case.

    `.upper()` maps 'ß' to 'SS' (https://bugs.python.org/issue30810), so the
    capital sharp-S is substituted before upper-casing, as the reference does
    (ipa_lexicon.py:287-309).
    """
    if locale not in GRAPHEME_CHARACTER_SETS:
        raise ValueError(
            f"Grapheme character set not found for locale '{locale}'. "
            f"Supported locales {list(GRAPHEME_CHARACTER_SETS)}"
        )
    base = "".join(GRAPHEME_CHARACTER_SETS[locale])
    if case == "upper":
        return base.replace("ß", "ẞ").upper()
    if case == "lower":
        return base.lower()
    if case == "mixed":
        return base.replace("ß", "ẞ").upper() + base.lower()
    raise ValueError(
        f"Grapheme character case not found: '{case}'. "
        f"Supported cases are {GRAPHEME_CHARACTER_CASES}"
    )


def get_ipa_character_set(locale: str) -> Set[str]:
    if locale not in IPA_CHARACTER_SETS:
        raise ValueError(
            f"IPA character set not found for locale '{locale}'. "
            f"Supported locales {list(IPA_CHARACTER_SETS)}"
        )
    return set(IPA_CHARACTER_SETS[locale])


def get_ipa_punctuation_list(locale: str = None) -> List[str]:
    """Sorted locale punctuation: defaults plus guillemets for de/es, German
    quote/dash marks, Spanish inverted marks (ipa_lexicon.py:322-352)."""
    if locale is None:
        return sorted(DEFAULT_PUNCTUATION)
    validate_locale(locale)
    punct = set(DEFAULT_PUNCTUATION)
    if locale in ("de-DE", "es-ES"):
        punct.update("«»‹›")
    if locale == "de-DE":
        punct.update("„“‚‘‒–—")
    elif locale == "es-ES":
        punct.update("¿¡")
    return sorted(punct)
