"""ROUGE-1, ROUGE-2 and ROUGE-L F-measures with Porter stemming, as
``rouge_score.rouge_scorer.RougeScorer(["rouge1", "rouge2", "rougeL"],
use_stemmer=True)`` computes them, for the free-form answer reward
(``rewards.py:_rouge_avg_f``).

The card's machine has neither ``rouge_score`` nor ``nltk``, and a free-form
answer must score the same there as in the JAX package, so this module
reproduces exactly what that scorer runs:

- rouge_score's tokenizer (``rouge_score/tokenize.py``): lowercase, every run
  of characters outside ``[a-z0-9]`` becomes a space, split on whitespace,
  stem only tokens longer than 3 characters, drop empty tokens;
- nltk's ``PorterStemmer()`` in its default ``NLTK_EXTENSIONS`` mode
  (``nltk/stem/porter.py``), with its pool of irregular forms;
- n-gram F (counts clipped per n-gram, precision and recall over
  ``max(count, 1)``) and LCS F (``rouge_scorer._score_ngrams``,
  ``_score_lcs``), F = 2PR / (P + R), 0 when P + R = 0.

Both sources are under the Apache License 2.0: rouge_score (Copyright 2022
The rouge_score Authors) and nltk (Copyright (C) 2001-2024 NLTK Project).
This file follows their code rule by rule; ``tests/test_torch_rewards.py``
holds it equal to rouge_score to 1e-12.
"""

from __future__ import annotations

import collections
import re

_NON_ALPHANUM_RE = re.compile(r"[^a-z0-9]+")
_SPACES_RE = re.compile(r"\s+")
_VALID_TOKEN_RE = re.compile(r"^[a-z0-9]+$")


class PorterStemmer:
    """nltk's ``PorterStemmer`` in ``NLTK_EXTENSIONS`` mode (the only mode
    kept): Porter's algorithm with Martin Porter's and NLTK's extensions."""

    _IRREGULAR_FORMS = {
        "sky": ["sky", "skies"],
        "die": ["dying"],
        "lie": ["lying"],
        "tie": ["tying"],
        "news": ["news"],
        "inning": ["innings", "inning"],
        "outing": ["outings", "outing"],
        "canning": ["cannings", "canning"],
        "howe": ["howe"],
        "proceed": ["proceed"],
        "exceed": ["exceed"],
        "succeed": ["succeed"],
    }

    def __init__(self):
        self.pool = {form: key for key, forms in self._IRREGULAR_FORMS.items() for form in forms}
        self.vowels = frozenset("aeiou")

    def _is_consonant(self, word: str, i: int) -> bool:
        """A letter other than a vowel, and other than a y preceded by a
        consonant; a run of y's alternates (resolved without recursion)."""
        if word[i] in self.vowels:
            return False
        if word[i] == "y":
            negate = False
            while i > 0 and word[i] == "y":
                negate = not negate
                i -= 1
            return (word[i] not in self.vowels) != negate
        return True

    def _measure(self, stem: str) -> int:
        """m in [C](VC){m}[V]: the number of vowel-consonant transitions."""
        cv = "".join("c" if self._is_consonant(stem, i) else "v" for i in range(len(stem)))
        return cv.count("vc")

    def _has_positive_measure(self, stem: str) -> bool:
        return self._measure(stem) > 0

    def _contains_vowel(self, stem: str) -> bool:
        return any(not self._is_consonant(stem, i) for i in range(len(stem)))

    def _ends_double_consonant(self, word: str) -> bool:
        return len(word) >= 2 and word[-1] == word[-2] and self._is_consonant(word, len(word) - 1)

    def _ends_cvc(self, word: str) -> bool:
        return (
            len(word) >= 3
            and self._is_consonant(word, len(word) - 3)
            and not self._is_consonant(word, len(word) - 2)
            and self._is_consonant(word, len(word) - 1)
            and word[-1] not in ("w", "x", "y")
        ) or (
            len(word) == 2
            and not self._is_consonant(word, 0)
            and self._is_consonant(word, 1)
        )

    @staticmethod
    def _replace_suffix(word: str, suffix: str, replacement: str) -> str:
        if suffix == "":
            return word + replacement
        return word[: -len(suffix)] + replacement

    def _apply_rule_list(self, word: str, rules) -> str:
        """The first rule whose suffix matches decides: its replacement if
        its condition holds on the stem, else the word unchanged."""
        for suffix, replacement, condition in rules:
            if suffix == "*d" and self._ends_double_consonant(word):
                stem = word[:-2]
                if condition is None or condition(stem):
                    return stem + replacement
                return word
            if word.endswith(suffix):
                stem = self._replace_suffix(word, suffix, "")
                if condition is None or condition(stem):
                    return stem + replacement
                return word
        return word

    def _step1a(self, word: str) -> str:
        if word.endswith("ies") and len(word) == 4:
            return self._replace_suffix(word, "ies", "ie")
        return self._apply_rule_list(
            word, [("sses", "ss", None), ("ies", "i", None), ("ss", "ss", None), ("s", "", None)]
        )

    def _step1b(self, word: str) -> str:
        if word.endswith("ied"):
            return self._replace_suffix(word, "ied", "ie" if len(word) == 4 else "i")
        if word.endswith("eed"):
            stem = self._replace_suffix(word, "eed", "")
            return stem + "ee" if self._measure(stem) > 0 else word
        for suffix in ("ed", "ing"):
            if word.endswith(suffix):
                intermediate = self._replace_suffix(word, suffix, "")
                if self._contains_vowel(intermediate):
                    break
        else:
            return word
        return self._apply_rule_list(
            intermediate,
            [
                ("at", "ate", None),
                ("bl", "ble", None),
                ("iz", "ize", None),
                ("*d", intermediate[-1], lambda stem: intermediate[-1] not in ("l", "s", "z")),
                ("", "e", lambda stem: self._measure(stem) == 1 and self._ends_cvc(stem)),
            ],
        )

    def _step1c(self, word: str) -> str:
        return self._apply_rule_list(
            word,
            [("y", "i", lambda stem: len(stem) > 1 and self._is_consonant(stem, len(stem) - 1))],
        )

    def _step2(self, word: str) -> str:
        if word.endswith("alli") and self._has_positive_measure(
            self._replace_suffix(word, "alli", "")
        ):
            return self._step2(self._replace_suffix(word, "alli", "al"))
        pos = self._has_positive_measure
        rules = [
            ("ational", "ate", pos),
            ("tional", "tion", pos),
            ("enci", "ence", pos),
            ("anci", "ance", pos),
            ("izer", "ize", pos),
            ("bli", "ble", pos),
            ("alli", "al", pos),
            ("entli", "ent", pos),
            ("eli", "e", pos),
            ("ousli", "ous", pos),
            ("ization", "ize", pos),
            ("ation", "ate", pos),
            ("ator", "ate", pos),
            ("alism", "al", pos),
            ("iveness", "ive", pos),
            ("fulness", "ful", pos),
            ("ousness", "ous", pos),
            ("aliti", "al", pos),
            ("iviti", "ive", pos),
            ("biliti", "ble", pos),
            ("fulli", "ful", pos),
            # the 'l' of 'logi' stays with the stem ('geo', 'theo' ...)
            ("logi", "log", lambda stem: self._has_positive_measure(word[:-3])),
        ]
        return self._apply_rule_list(word, rules)

    def _step3(self, word: str) -> str:
        pos = self._has_positive_measure
        return self._apply_rule_list(
            word,
            [
                ("icate", "ic", pos),
                ("ative", "", pos),
                ("alize", "al", pos),
                ("iciti", "ic", pos),
                ("ical", "ic", pos),
                ("ful", "", pos),
                ("ness", "", pos),
            ],
        )

    def _step4(self, word: str) -> str:
        def gt1(stem):
            return self._measure(stem) > 1

        return self._apply_rule_list(
            word,
            [
                ("al", "", gt1),
                ("ance", "", gt1),
                ("ence", "", gt1),
                ("er", "", gt1),
                ("ic", "", gt1),
                ("able", "", gt1),
                ("ible", "", gt1),
                ("ant", "", gt1),
                ("ement", "", gt1),
                ("ment", "", gt1),
                ("ent", "", gt1),
                ("ion", "", lambda stem: self._measure(stem) > 1 and stem[-1] in ("s", "t")),
                ("ou", "", gt1),
                ("ism", "", gt1),
                ("ate", "", gt1),
                ("iti", "", gt1),
                ("ous", "", gt1),
                ("ive", "", gt1),
                ("ize", "", gt1),
            ],
        )

    def _step5a(self, word: str) -> str:
        # both rules on a final 'e' are tried (not _apply_rule_list)
        if word.endswith("e"):
            stem = self._replace_suffix(word, "e", "")
            if self._measure(stem) > 1:
                return stem
            if self._measure(stem) == 1 and not self._ends_cvc(stem):
                return stem
        return word

    def _step5b(self, word: str) -> str:
        return self._apply_rule_list(word, [("ll", "l", lambda stem: self._measure(word[:-1]) > 1)])

    def stem(self, word: str) -> str:
        stem = word.lower()
        if stem in self.pool:
            return self.pool[stem]
        if len(word) <= 2:
            return stem
        for step in (self._step1a, self._step1b, self._step1c, self._step2, self._step3,
                     self._step4, self._step5a, self._step5b):
            stem = step(stem)
        return stem


_STEMMER = PorterStemmer()


def tokenize(text: str, stem: bool = True) -> list[str]:
    """rouge_score's tokenizer (``DefaultTokenizer(use_stemmer=stem)``)."""
    tokens = _SPACES_RE.split(_NON_ALPHANUM_RE.sub(" ", text.lower()))
    if stem:
        tokens = [_STEMMER.stem(x) if len(x) > 3 else x for x in tokens]
    return [x for x in tokens if _VALID_TOKEN_RE.match(x)]


def _fmeasure(precision: float, recall: float) -> float:
    if precision + recall > 0:
        return 2 * precision * recall / (precision + recall)
    return 0.0


def _ngrams(tokens: list[str], n: int) -> collections.Counter:
    return collections.Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def rouge_n(target: list[str], prediction: list[str], n: int) -> float:
    """ROUGE-N F-measure of two token lists."""
    t, p = _ngrams(target, n), _ngrams(prediction, n)
    overlap = 0
    for gram in t:
        overlap += min(t[gram], p[gram])
    precision = overlap / max(sum(p.values()), 1)
    recall = overlap / max(sum(t.values()), 1)
    return _fmeasure(precision, recall)


def rouge_l(target: list[str], prediction: list[str]) -> float:
    """ROUGE-L F-measure (longest common subsequence) of two token lists."""
    if not target or not prediction:
        return 0
    prev = [0] * (len(prediction) + 1)
    for t in target:
        row = [0]
        for j, p in enumerate(prediction, 1):
            row.append(prev[j - 1] + 1 if t == p else max(prev[j], row[j - 1]))
        prev = row
    lcs = prev[-1]
    return _fmeasure(lcs / len(prediction), lcs / len(target))


def rouge_scores(target: str, prediction: str) -> dict[str, float]:
    """{"rouge1", "rouge2", "rougeL"} F-measures, as ``RougeScorer.score(
    target, prediction)[k].fmeasure`` with stemming."""
    t, p = tokenize(target), tokenize(prediction)
    return {"rouge1": rouge_n(t, p, 1), "rouge2": rouge_n(t, p, 2), "rougeL": rouge_l(t, p)}


def rouge_avg_f(target: str, prediction: str) -> float:
    """The mean of the three F-measures, summed in rouge_score's order."""
    s = rouge_scores(target, prediction)
    return (s["rouge1"] + s["rouge2"] + s["rougeL"]) / 3
