"""Heuristic caption scoring and best-of-N selection.

Behavior parity with the reference ranker (core/postprocessing/
candidate_ranker.py:7-36): Gaussian length prior (mu=12, sigma=4 words),
bonuses for progressive verbs / copulas / terminal punctuation, penalties
for acronyms, spam phrases, very short outputs, and known fallback strings.
Scores must match exactly — caption selection parity depends on them.
"""
from __future__ import annotations

import re
from typing import Iterable, Tuple

_LEN_MU = 12.0
_LEN_SIGMA = 4.0
_FALLBACK_SENTENCES = frozenset({"someone is sitting.", "someone is in the scene."})
_ING_RE = re.compile(r"\b\w+ing\b")
_COPULA_RE = re.compile(r"\b(?:is|are|was|were)\b")
_ACRONYM_RE = re.compile(r"\b(?:[A-Z]\.){2,}\b")
_SPAM_RE = re.compile(r"(?i)\b(click here|subscribe|report abuse|sign up|pastebin)\b")


def score_sentence(text: str) -> float:
    if not text:
        return -1e9
    n_words = len(text.split())
    score = -((n_words - _LEN_MU) ** 2) / (2 * _LEN_SIGMA * _LEN_SIGMA)
    if _ING_RE.search(text):
        score += 1.0
    if _COPULA_RE.search(text):
        score += 0.5
    if text.endswith((".", "!", "?")):
        score += 0.3
    if _ACRONYM_RE.search(text):
        score -= 1.5
    if _SPAM_RE.search(text):
        score -= 1.5
    if n_words < 4:
        score -= 2.0
    if text.strip().lower() in _FALLBACK_SENTENCES:
        score -= 0.8
    return score


def select_best(candidates: Iterable[Tuple[str, str]]) -> Tuple[str, str, float]:
    """[(key, text), ...] -> (best_key, best_text, best_score)."""
    scored = [(key, text, score_sentence(text)) for key, text in candidates]
    return sorted(scored, key=lambda item: item[2], reverse=True)[0]
