"""WER computation + text normalization for the evaluation harnesses.

The reference evaluates with jiwer after OpenAI's EnglishTextNormalizer
(reference tests/librispeech/eval.py:30-46, normalizers/english.py — MIT).
Silent normalizer skew would poison every WER comparison: the exact
behavior of that normalizer IS the WER-comparability contract, so the
_NumberNormalizer state machine below is a branch-for-branch Python
TRANSCRIPTION of `process_words` in the MIT-licensed OpenAI original
(whisper/normalizers/english.py, Copyright (c) 2022 OpenAI — license
carried in data/LICENSE next to the spelling table), not an independent
re-derivation: filler/contraction/title rewrites, symbol+diacritic
folding, the spelled-out-number branches (currency prefixers, percent
suffixers, "double"/"triple"/"point"/"and a half", cents combining,
nominal digit chains like "one oh one" -> 101), and the 1739-entry
British->American spelling table (data/english_spellings.json, the
original's english.json re-emitted by tools/gen_spelling_map.py) —
differentially verified word-for-word against the reference's vendored
copy in tests/test_wer_normalizer.py.  WER itself is a plain
Levenshtein distance over words (jiwer's corpus WER definition).
"""

from __future__ import annotations

import json
import re
import unicodedata
from fractions import Fraction
from pathlib import Path
from typing import Iterable, Iterator, List, Optional, Tuple, Union

# ---------------------------------------------------------------------------
# symbol / diacritic folding (reference normalizers/basic.py:27-47)
# ---------------------------------------------------------------------------

# non-ASCII letters that NFKD does not decompose to base + combining mark
_DIACRITIC_FOLD = {
    "œ": "oe", "Œ": "OE", "ø": "o", "Ø": "O", "æ": "ae", "Æ": "AE",
    "ß": "ss", "ẞ": "SS", "đ": "d", "Đ": "D", "ð": "d", "Ð": "D",
    "þ": "th", "Þ": "th", "ł": "l", "Ł": "L",
}


def _fold_symbols(s: str, keep: str = "") -> str:
    """NFKD-decompose, drop combining marks, fold the special letters above,
    and replace remaining marks/symbols/punctuation with a space."""
    out = []
    for c in unicodedata.normalize("NFKD", s):
        if c in keep:
            out.append(c)
        elif c in _DIACRITIC_FOLD:
            out.append(_DIACRITIC_FOLD[c])
        else:
            cat = unicodedata.category(c)
            if cat == "Mn":
                continue
            out.append(" " if cat[0] in "MSP" else c)
    return "".join(out)


# ---------------------------------------------------------------------------
# spelled-out-number normalization (reference normalizers/english.py:12-447)
# ---------------------------------------------------------------------------

_NUM_RE = re.compile(r"^\d+(\.\d+)?$")


def _is_numeric(w: Optional[str]) -> bool:
    return w is not None and _NUM_RE.match(w) is not None


class _NumberNormalizer:
    """State machine turning spelled-out numbers into digits while keeping
    ordinal/plural suffixes, folding currency words into prefix symbols, and
    reading successive single digits as nominal chains.

    `_walk` is a branch-for-branch transcription of the MIT-licensed OpenAI
    NumberParser.process_words (whisper/normalizers/english.py; the
    reference vendors it at tests/librispeech/normalizers/english.py:165-386)
    — same branch order, same `value % 100 == 0` special cases, same
    asserts.  See data/LICENSE for the carried MIT notice."""

    def __init__(self) -> None:
        self.zeros = {"o", "oh", "zero"}
        ones_names = ["one", "two", "three", "four", "five", "six", "seven",
                      "eight", "nine", "ten", "eleven", "twelve", "thirteen",
                      "fourteen", "fifteen", "sixteen", "seventeen",
                      "eighteen", "nineteen"]
        self.ones = {w: i for i, w in enumerate(ones_names, start=1)}
        ones_plural = {("sixes" if w == "six" else w + "s"): (v, "s")
                       for w, v in self.ones.items()}
        ones_ordinal = {"zeroth": (0, "th"), "first": (1, "st"),
                        "second": (2, "nd"), "third": (3, "rd"),
                        "fifth": (5, "th"), "twelfth": (12, "th")}
        ones_ordinal.update({
            w + ("h" if w.endswith("t") else "th"): (v, "th")
            for w, v in self.ones.items() if v > 3 and v not in (5, 12)})
        self.ones_suffixed = {**ones_plural, **ones_ordinal}

        self.tens = {"twenty": 20, "thirty": 30, "forty": 40, "fifty": 50,
                     "sixty": 60, "seventy": 70, "eighty": 80, "ninety": 90}
        self.tens_suffixed = {
            **{w.replace("y", "ies"): (v, "s") for w, v in self.tens.items()},
            **{w.replace("y", "ieth"): (v, "th")
               for w, v in self.tens.items()}}

        self.multipliers = {
            "hundred": 10 ** 2, "thousand": 10 ** 3, "million": 10 ** 6,
            "billion": 10 ** 9, "trillion": 10 ** 12,
            "quadrillion": 10 ** 15, "quintillion": 10 ** 18,
            "sextillion": 10 ** 21, "septillion": 10 ** 24,
            "octillion": 10 ** 27, "nonillion": 10 ** 30,
            "decillion": 10 ** 33}
        self.multipliers_suffixed = {
            **{w + "s": (v, "s") for w, v in self.multipliers.items()},
            **{w + "th": (v, "th") for w, v in self.multipliers.items()}}

        self.decimals = self.ones.keys() | self.tens.keys() | self.zeros
        self.preceding_prefixers = {"minus": "-", "negative": "-",
                                    "plus": "+", "positive": "+"}
        self.following_prefixers = {"pound": "£", "pounds": "£",
                                    "euro": "€", "euros": "€",
                                    "dollar": "$", "dollars": "$",
                                    "cent": "¢", "cents": "¢"}
        self.prefixes = (set(self.preceding_prefixers.values())
                         | set(self.following_prefixers.values()))
        self.suffixers = {"per": {"cent": "%"}, "percent": "%"}
        self.specials = {"and", "double", "triple", "point"}
        self.words = (self.zeros | self.ones.keys()
                      | self.ones_suffixed.keys() | self.tens.keys()
                      | self.tens_suffixed.keys() | self.multipliers.keys()
                      | self.multipliers_suffixed.keys()
                      | self.preceding_prefixers.keys()
                      | self.following_prefixers.keys()
                      | self.suffixers.keys() | self.specials)

    # -- the word-stream walk (english.py:165-386) --------------------------

    def _walk(self, words: List[str]) -> Iterator[str]:
        prefix: Optional[str] = None
        value: Optional[Union[str, int]] = None
        skip = False

        def to_fraction(s) -> Optional[Fraction]:
            try:
                return Fraction(s)
            except ValueError:
                return None

        def out(result: Union[str, int]) -> str:
            nonlocal prefix, value
            result = str(result)
            if prefix is not None:
                result = prefix + result
            value = prefix = None
            return result

        for idx, cur in enumerate(words):
            if skip:
                skip = False
                continue
            prev = words[idx - 1] if idx > 0 else None
            nxt = words[idx + 1] if idx + 1 < len(words) else None

            has_prefix = cur[0] in self.prefixes
            cur_raw = cur[1:] if has_prefix else cur
            if _is_numeric(cur_raw):
                # arabic numbers, possibly signed / decimal
                f = to_fraction(cur_raw)
                assert f is not None
                if value is not None:
                    if isinstance(value, str) and value.endswith("."):
                        # decimal / IP-address continuation: "3. 14" -> 3.14
                        value = str(value) + str(cur)
                        continue
                    yield out(value)
                prefix = cur[0] if has_prefix else prefix
                value = f.numerator if f.denominator == 1 else cur_raw
            elif cur not in self.words:
                if value is not None:
                    yield out(value)
                yield out(cur)
            elif cur in self.zeros:
                value = str(value or "") + "0"
            elif cur in self.ones:
                ones = self.ones[cur]
                if value is None:
                    value = ones
                elif isinstance(value, str) or prev in self.ones:
                    if prev in self.tens and ones < 10:
                        # "twenty one": replace the trailing zero
                        assert value[-1] == "0"
                        value = value[:-1] + str(ones)
                    else:
                        value = str(value) + str(ones)
                elif ones < 10:
                    value = (value + ones if value % 10 == 0
                             else str(value) + str(ones))
                else:  # eleven..nineteen
                    value = (value + ones if value % 100 == 0
                             else str(value) + str(ones))
            elif cur in self.ones_suffixed:
                # ordinal/plural closes the number immediately
                ones, suffix = self.ones_suffixed[cur]
                if value is None:
                    yield out(str(ones) + suffix)
                elif isinstance(value, str) or prev in self.ones:
                    if prev in self.tens and ones < 10:
                        assert value[-1] == "0"
                        yield out(value[:-1] + str(ones) + suffix)
                    else:
                        yield out(str(value) + str(ones) + suffix)
                elif ones < 10:
                    yield out(str(value + ones) + suffix if value % 10 == 0
                              else str(value) + str(ones) + suffix)
                else:
                    yield out(str(value + ones) + suffix if value % 100 == 0
                              else str(value) + str(ones) + suffix)
                value = None
            elif cur in self.tens:
                tens = self.tens[cur]
                if value is None:
                    value = tens
                elif isinstance(value, str):
                    value = str(value) + str(tens)
                else:
                    value = (value + tens if value % 100 == 0
                             else str(value) + str(tens))
            elif cur in self.tens_suffixed:
                tens, suffix = self.tens_suffixed[cur]
                if value is None:
                    yield out(str(tens) + suffix)
                elif isinstance(value, str):
                    yield out(str(value) + str(tens) + suffix)
                else:
                    yield out(str(value + tens) + suffix if value % 100 == 0
                              else str(value) + str(tens) + suffix)
            elif cur in self.multipliers:
                multiplier = self.multipliers[cur]
                if value is None:
                    value = multiplier
                elif isinstance(value, str) or value == 0:
                    f = to_fraction(value)
                    p = f * multiplier if f is not None else None
                    if f is not None and p.denominator == 1:
                        value = p.numerator
                    else:
                        yield out(value)
                        value = multiplier
                else:
                    before = value // 1000 * 1000
                    value = before + value % 1000 * multiplier
            elif cur in self.multipliers_suffixed:
                multiplier, suffix = self.multipliers_suffixed[cur]
                if value is None:
                    yield out(str(multiplier) + suffix)
                elif isinstance(value, str):
                    f = to_fraction(value)
                    p = f * multiplier if f is not None else None
                    if f is not None and p.denominator == 1:
                        yield out(str(p.numerator) + suffix)
                    else:
                        yield out(value)
                        yield out(str(multiplier) + suffix)
                else:
                    before = value // 1000 * 1000
                    value = before + value % 1000 * multiplier
                    yield out(str(value) + suffix)
                value = None
            elif cur in self.preceding_prefixers:
                # "minus five" -> -5, but only before something numeric
                if value is not None:
                    yield out(value)
                if nxt in self.words or _is_numeric(nxt):
                    prefix = self.preceding_prefixers[cur]
                else:
                    yield out(cur)
            elif cur in self.following_prefixers:
                # "five dollars" -> $5 (currency symbol as prefix)
                if value is not None:
                    prefix = self.following_prefixers[cur]
                    yield out(value)
                else:
                    yield out(cur)
            elif cur in self.suffixers:
                if value is not None:
                    suffix = self.suffixers[cur]
                    if isinstance(suffix, dict):
                        if nxt in suffix:
                            yield out(str(value) + suffix[nxt])
                            skip = True
                        else:
                            yield out(value)
                            yield out(cur)
                    else:
                        yield out(str(value) + suffix)
                else:
                    yield out(cur)
            elif cur in self.specials:
                if nxt not in self.words and not _is_numeric(nxt):
                    if value is not None:
                        yield out(value)
                    yield out(cur)
                elif cur == "and":
                    # swallow "and" after hundreds/thousands/...
                    if prev not in self.multipliers:
                        if value is not None:
                            yield out(value)
                        yield out(cur)
                elif cur in ("double", "triple"):
                    if nxt in self.ones or nxt in self.zeros:
                        repeats = 2 if cur == "double" else 3
                        value = (str(value or "")
                                 + str(self.ones.get(nxt, 0)) * repeats)
                        skip = True
                    else:
                        if value is not None:
                            yield out(value)
                        yield out(cur)
                elif cur == "point":
                    if nxt in self.decimals or _is_numeric(nxt):
                        value = str(value or "") + "."
            else:  # pragma: no cover - the table above is exhaustive
                raise ValueError(f"unexpected number token: {cur}")

        if value is not None:
            yield out(value)

    def __call__(self, s: str) -> str:
        # "<number> and a half" -> "<number> point five" when it follows a
        # number word (english.py:388-406)
        parts = []
        segments = re.split(r"\band\s+a\s+half\b", s)
        for i, segment in enumerate(segments):
            if not segment.strip():
                continue
            parts.append(segment)
            if i != len(segments) - 1:
                last_word = segment.rsplit(maxsplit=2)[-1]
                parts.append("point five"
                             if last_word in self.decimals
                             or last_word in self.multipliers
                             else "and a half")
        s = " ".join(parts)

        # split number/letter boundaries, re-attach ordinal/plural suffixes
        s = re.sub(r"([a-z])([0-9])", r"\1 \2", s)
        s = re.sub(r"([0-9])([a-z])", r"\1 \2", s)
        s = re.sub(r"([0-9])\s+(st|nd|rd|th|s)\b", r"\1\2", s)

        s = " ".join(w for w in self._walk(s.split()) if w is not None)

        # "$2 and ¢7" -> "$2.07"; "$0.79" -> "¢79"; "1(s)" -> "one(s)"
        def combine_cents(m: re.Match) -> str:
            try:
                return (f"{m.group(1)}{m.group(2)}.{int(m.group(3)):02d}")
            except ValueError:  # pragma: no cover
                return m.string

        def extract_cents(m: re.Match) -> str:
            try:
                return f"¢{int(m.group(1))}"
            except ValueError:  # pragma: no cover
                return m.string

        s = re.sub(r"([€£$])([0-9]+) (?:and )?¢([0-9]{1,2})\b",
                   combine_cents, s)
        s = re.sub(r"[€£$]0.([0-9]{1,2})\b", extract_cents, s)
        s = re.sub(r"\b1(s?)\b", r"one\1", s)
        return s


# ---------------------------------------------------------------------------
# full English normalizer (reference normalizers/english.py:465-550)
# ---------------------------------------------------------------------------

_FILLERS = r"\b(hmm|mm|mhm|mmm|uh|um)\b"

# order matters: specific contractions run before the generic suffix rules
_REPLACERS = [
    (r"\bwon't\b", "will not"), (r"\bcan't\b", "can not"),
    (r"\blet's\b", "let us"), (r"\bain't\b", "aint"),
    (r"\by'all\b", "you all"), (r"\bwanna\b", "want to"),
    (r"\bgotta\b", "got to"), (r"\bgonna\b", "going to"),
    (r"\bi'ma\b", "i am going to"), (r"\bimma\b", "i am going to"),
    (r"\bwoulda\b", "would have"), (r"\bcoulda\b", "could have"),
    (r"\bshoulda\b", "should have"), (r"\bma'am\b", "madam"),
    # title abbreviations (the trailing space splices into the next word's
    # leading space after punctuation folding)
    (r"\bmr\b", "mister "), (r"\bmrs\b", "missus "), (r"\bst\b", "saint "),
    (r"\bdr\b", "doctor "), (r"\bprof\b", "professor "),
    (r"\bcapt\b", "captain "), (r"\bgov\b", "governor "),
    (r"\bald\b", "alderman "), (r"\bgen\b", "general "),
    (r"\bsen\b", "senator "), (r"\brep\b", "representative "),
    (r"\bpres\b", "president "), (r"\brev\b", "reverend "),
    (r"\bhon\b", "honorable "), (r"\basst\b", "assistant "),
    (r"\bassoc\b", "associate "), (r"\blt\b", "lieutenant "),
    (r"\bcol\b", "colonel "), (r"\bjr\b", "junior "), (r"\bsr\b", "senior "),
    (r"\besq\b", "esquire "),
    # perfect tenses before the generic 'd/'s rules
    (r"'d been\b", " had been"), (r"'s been\b", " has been"),
    (r"'d gone\b", " had gone"), (r"'s gone\b", " has gone"),
    (r"'d done\b", " had done"), (r"'s got\b", " has got"),
    # general contractions
    (r"n't\b", " not"), (r"'re\b", " are"), (r"'s\b", " is"),
    (r"'d\b", " would"), (r"'ll\b", " will"), (r"'t\b", " not"),
    (r"'ve\b", " have"), (r"'m\b", " am"),
]

_number_normalizer: Optional[_NumberNormalizer] = None
_spellings: Optional[dict] = None


def _get_spellings() -> dict:
    global _spellings
    if _spellings is None:
        path = Path(__file__).parent / "data" / "english_spellings.json"
        _spellings = json.loads(path.read_text())
    return _spellings


def normalize_english(text: str) -> str:
    """OpenAI EnglishTextNormalizer semantics, re-derived (see module
    docstring); output is whitespace-collapsed and stripped."""
    global _number_normalizer
    if _number_normalizer is None:
        _number_normalizer = _NumberNormalizer()

    s = text.lower()
    s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)   # bracketed annotations
    s = re.sub(r"\(([^)]+?)\)", "", s)        # parenthesized asides
    s = re.sub(_FILLERS, "", s)
    s = re.sub(r"\s+'", "'", s)               # "it 's" -> "it's"
    for pattern, replacement in _REPLACERS:
        s = re.sub(pattern, replacement, s)
    s = re.sub(r"(\d),(\d)", r"\1\2", s)      # 1,000 -> 1000
    s = re.sub(r"\.([^0-9]|$)", r" \1", s)    # keep only decimal points
    s = _fold_symbols(s, keep=".%$¢€£")       # keep numeric symbols

    s = _number_normalizer(s)
    spellings = _get_spellings()
    s = " ".join(spellings.get(w, w) for w in s.split())

    # strip numeric symbols not attached to digits
    s = re.sub(r"[.$¢€£]([^0-9])", r" \1", s)
    s = re.sub(r"([^0-9])%", r"\1 ", s)
    s = re.sub(r"\s+", " ", s)
    return s.strip()


def _edit_ops(ref: List[str], hyp: List[str]) -> Tuple[int, int, int]:
    """(substitutions, deletions, insertions) of the minimal alignment."""
    n, m = len(ref), len(hyp)
    # dp over (cost, subs, dels, ins)
    import numpy as np

    cost = np.zeros((n + 1, m + 1), np.int32)
    cost[:, 0] = np.arange(n + 1)
    cost[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        prev = cost[i - 1]
        cur = cost[i]
        for j in range(1, m + 1):
            sub = prev[j - 1] + (ref[i - 1] != hyp[j - 1])
            cur[j] = min(sub, prev[j] + 1, cur[j - 1] + 1)
    # backtrace for op counts
    i, j = n, m
    subs = dels = ins = 0
    while i > 0 or j > 0:
        if i > 0 and j > 0 and cost[i, j] == cost[i - 1, j - 1] + \
                (ref[i - 1] != hyp[j - 1]):
            subs += ref[i - 1] != hyp[j - 1]
            i, j = i - 1, j - 1
        elif i > 0 and cost[i, j] == cost[i - 1, j] + 1:
            dels += 1
            i -= 1
        else:
            ins += 1
            j -= 1
    return subs, dels, ins


def wer(references: Iterable[str], hypotheses: Iterable[str],
        normalize: bool = True) -> float:
    """Corpus-level word error rate."""
    total_err = 0
    total_ref = 0
    for ref, hyp in zip(references, hypotheses):
        if normalize:
            ref, hyp = normalize_english(ref), normalize_english(hyp)
        r, h = ref.split(), hyp.split()
        s, d, i = _edit_ops(r, h)
        total_err += s + d + i
        total_ref += len(r)
    return total_err / max(1, total_ref)
