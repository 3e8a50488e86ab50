"""English text cleaning for char parsers (normalization-light TTS/ASR path).

The port's copy of roar_tpu/data/cleaners.py (host code, pure Python; the
same text gives the same cleaned string).  That module is a re-design of
roar/collections/common/parts/preprocessing/cleaners.py
(clean_text :131, NumberCleaner :175, abbreviation tables :16-128): same
pipeline — transliterate, lowercase, expand numbers/times/ordinals/currency,
expand abbreviations, replace punctuation — with two dependency swaps, so that
nothing needs a download: `inflect.number_to_words` is replaced by a
self-contained English number-to-words implementation, and
`text_unidecode.unidecode` by an NFKD-based transliteration fallback.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Dict, Optional

from roar_tpu_torch.utils.logging import get_logger

logging = get_logger()

NUM_CHECK = re.compile(r"([$]?)(^|\s)(\S*[0-9]\S*)(?=(\s|$)((\S*)(\s|$))?)")
TIME_CHECK = re.compile(r"([0-9]{1,2}):([0-9]{2})(am|pm)?")
CURRENCY_CHECK = re.compile(r"\$")
ORD_CHECK = re.compile(r"([0-9]+)(st|nd|rd|th)")
THREE_CHECK = re.compile(r"([0-9]{3})([.,][0-9]{1,2})?([!.?])?$")
DECIMAL_CHECK = re.compile(r"([.,][0-9]{1,2})$")

_ABBR_COMMON_SRC = [
    ("ms", "miss"), ("mrs", "misess"), ("mr", "mister"),
    ("messrs", "messeurs"), ("dr", "doctor"), ("drs", "doctors"),
    ("st", "saint"), ("co", "company"), ("jr", "junior"), ("sr", "senior"),
    ("rev", "reverend"), ("hon", "honorable"), ("sgt", "sergeant"),
    ("capt", "captain"), ("maj", "major"), ("col", "colonel"),
    ("lt", "lieutenant"), ("gen", "general"), ("prof", "professor"),
    ("lb", "pounds"), ("rep", "representative"), ("st", "street"),
    ("ave", "avenue"), ("etc", "et cetera"), ("jan", "january"),
    ("feb", "february"), ("mar", "march"), ("apr", "april"),
    ("jun", "june"), ("jul", "july"), ("aug", "august"),
    ("sep", "september"), ("oct", "october"), ("nov", "november"),
    ("dec", "december"),
]

_ABBR_EXPANDED_SRC = [
    ("ltd", "limited"), ("fig", "figure"), ("figs", "figures"),
    ("gent", "gentlemen"), ("ft", "fort"), ("esq", "esquire"),
    ("prep", "preperation"), ("bros", "brothers"), ("ind", "independent"),
    ("mme", "madame"), ("pro", "professional"), ("vs", "versus"),
    ("inc", "include"),
]

_ABBR_FASTPITCH_SRC = (
    [x for x in _ABBR_COMMON_SRC if x[0] not in ("messrs", "etc")]
    + [x for x in _ABBR_EXPANDED_SRC if x[0] != "inc"]
)


def _compile(table):
    return [(re.compile(r"\b%s\." % a), b) for a, b in table]


ABBREVIATIONS_COMMON = _compile(_ABBR_COMMON_SRC)
ABBREVIATIONS_EXPANDED = _compile(_ABBR_EXPANDED_SRC)
ABBREVIATIONS_TTS_FASTPITCH = _compile(_ABBR_FASTPITCH_SRC)


# ----------------------------------------------------------------------
# number-to-words (replaces the inflect dependency)
# ----------------------------------------------------------------------

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALES = [
    (10**12, "trillion"), (10**9, "billion"), (10**6, "million"),
    (10**3, "thousand"), (100, "hundred"),
]
_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _int_to_words(n: int) -> str:
    if n < 0:
        return "minus " + _int_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        tens, rem = divmod(n, 10)
        return _TENS[tens] + ("-" + _ONES[rem] if rem else "")
    for value, name in _SCALES:
        if n >= value:
            major, rem = divmod(n, value)
            out = _int_to_words(major) + " " + name
            if rem:
                # inflect style: "one hundred and twenty-three",
                # "one thousand, two hundred"
                joiner = " and " if value == 100 else ", "
                out += joiner + _int_to_words(rem)
            return out
    return _ONES[0]


def number_to_words(num, ordinal: bool = False) -> str:
    """English words for an int, digit string, or decimal string
    (the subset of inflect.number_to_words the cleaners use)."""
    s = str(num).replace(",", "")
    if ordinal:
        words = number_to_words(s)
        last = words.split()[-1].split("-")[-1]
        if last in _ORDINAL_IRREGULAR:
            repl = _ORDINAL_IRREGULAR[last]
        elif last.endswith("y"):
            repl = last[:-1] + "ieth"
        else:
            repl = last + "th"
        return words[: len(words) - len(last)] + repl
    if "." in s:
        whole, frac = s.split(".", 1)
        out = _int_to_words(int(whole)) if whole else "zero"
        out += " point"
        for d in frac:
            out += " " + _ONES[int(d)]
        return out
    return _int_to_words(int(s))


def unidecode_ascii(text: str) -> str:
    """NFKD-based ASCII transliteration (text_unidecode fallback)."""
    return (
        unicodedata.normalize("NFKD", text)
        .encode("ascii", "ignore")
        .decode("ascii")
    )


# ----------------------------------------------------------------------
# cleaning pipeline (cleaners.py:131-247)
# ----------------------------------------------------------------------

def warn_common_chars(string: str) -> None:
    if re.search(r"[£€]", string):
        logging.warning(
            "Your transcript contains one of '£' or '€' which we do not "
            "currently handle"
        )


def clean_numbers(string: str) -> str:
    cleaner = NumberCleaner()
    return NUM_CHECK.sub(cleaner.clean, string)


def clean_abbreviations(string: str, version: Optional[str] = None) -> str:
    abbreviations = ABBREVIATIONS_COMMON
    if version == "fastpitch":
        abbreviations = ABBREVIATIONS_TTS_FASTPITCH
    elif version == "expanded":
        abbreviations = ABBREVIATIONS_COMMON + ABBREVIATIONS_EXPANDED
    for regex, replacement in abbreviations:
        string = re.sub(regex, replacement, string)
    return string


def clean_punctuations(string: str, table, punctuation_to_replace: Dict[str, str]) -> str:
    for punc, replacement in punctuation_to_replace.items():
        string = re.sub("\\{}".format(punc), " {} ".format(replacement), string)
    if table:
        string = string.translate(table)
    return string


def clean_text(string: str, table, punctuation_to_replace,
               abbreviation_version: Optional[str] = None) -> str:
    warn_common_chars(string)
    string = unidecode_ascii(string)
    string = string.lower()
    string = re.sub(r"\s+", " ", string)
    string = clean_numbers(string)
    string = clean_abbreviations(string, version=abbreviation_version)
    string = clean_punctuations(string, table, punctuation_to_replace)
    return re.sub(r"\s+", " ", string).strip()


class NumberCleaner:
    """Stateful regex callback expanding times/ordinals/currency/grouped
    thousands (cleaners.py:175-247)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.curr_num = []
        self.currency = None

    def format_final_number(self, whole_num: str, decimal: Optional[str]) -> str:
        if self.currency:
            out = number_to_words(whole_num)
            out += " dollar" if whole_num == "1" else " dollars"
            if decimal:
                out += " and " + number_to_words(decimal)
                out += " cent" if whole_num == decimal else " cents"
            self.reset()
            return out
        self.reset()
        if decimal:
            return number_to_words(whole_num + "." + decimal)

        def convert(match):
            return " " + number_to_words(match.group(0)) + " "

        return re.sub(r"[0-9,]+", convert, whole_num)

    def clean(self, match: "re.Match") -> str:
        ws = match.group(2)
        number = match.group(3)

        time_match = TIME_CHECK.match(number)
        if time_match:
            out = ws + number_to_words(time_match.group(1)) + "{}{}"
            mins = int(time_match.group(2))
            min_string = " " + number_to_words(time_match.group(2)) if mins else ""
            ampm_string = " " + time_match.group(3) if time_match.group(3) else ""
            return out.format(min_string, ampm_string)

        ord_match = ORD_CHECK.match(number)
        if ord_match:
            return ws + number_to_words(ord_match.group(1), ordinal=True)

        if self.currency is None:
            self.currency = bool(match.group(1)) or bool(CURRENCY_CHECK.match(number))

        three_match = THREE_CHECK.match(match.group(6) or "")
        if three_match:
            self.curr_num.append(number)
            return " "
        whole_num = "".join(self.curr_num) + number
        decimal = None
        decimal_match = DECIMAL_CHECK.search(whole_num)
        if decimal_match:
            decimal = decimal_match.group(1)[1:]
            whole_num = whole_num[: -len(decimal) - 1]
        whole_num = re.sub(r"[.$]", "", whole_num)
        return ws + self.format_final_number(whole_num, decimal)
