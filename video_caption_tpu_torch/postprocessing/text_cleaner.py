"""Caption cleanup: raw GPT-2 output -> one subtitle-like sentence.

Behavior parity with the reference cleaner (core/postprocessing/
text_cleaner.py:77-122). The pipeline, in order:

1. reject pure decoration / URL / copyright / quoted-only / boilerplate leads,
2. strip spam phrases and country acronyms, collapse preposition chains,
3. truncate long sentences at the first "noise" token (digits, dotted
   acronyms, codes, short ALL-CAPS),
4. prune interrogative tails (fallback: "Someone is in the scene."),
5. sit-complement heuristic, word-dedup, capitalization + final period,
6. if multiple sentences remain, keep the best-scoring one.

Pure string processing — backend-agnostic by design, shared by the XLA and
any future compiled path.
"""
from __future__ import annotations

import re

from video_caption_tpu_torch.postprocessing.candidate_ranker import score_sentence

_DECORATION_ONLY = re.compile(r"[-_= \t]{6,}\.?")
_DECORATION_LEAD = re.compile(r"^\s*[-_= \t]{2,}\s*")
_URLISH_LEAD = re.compile(r"^\s*(https?://|www\.|<a\b|&lt;a\b)", re.I)
_COPYRIGHT_LEAD = re.compile(r"^\s*(copyright\b)", re.I)
_QUOTED_ONLY = re.compile(r'"\s*[^"]+\s*"\.?')
_BAD_LEADS = re.compile(
    r"^\s*(?:you are about to\b|click here\b|subscribe\b|available on youtube\b"
    r"|watch live\b|find out\b|the video will\b|on the road\b)",
    re.I,
)
_MARKUPISH = re.compile(r"(</?\w+>|reddit\.com|pastebin|mailto:)", re.I)
_SPAM_PHRASE = re.compile(
    r"(?i)\b(click here|subscribe|report abuse|pastebin|official facebook|video will be)\b"
)
_SPAM_TAIL = re.compile(
    r"(?i)\b(click here|subscribe|report abuse|pastebin|official facebook|video will be.*)$"
)
_MULTISPACE = re.compile(r"\s{2,}")
_DUP_WORD = re.compile(r"(?i)\b(\w+)\b(?:\s+\1\b)+")
_SENTENCE_SPLIT = re.compile(r"\s*(?<=\.|\!|\?)\s+")
_FALLBACK = "Someone is in the scene."

_COUNTRY_PATTERNS = (
    re.compile(r"\bU\.S\.A?\.?\b", re.I),
    re.compile(r"\bUSA\b", re.I),
    re.compile(r"\bUnited States of America\b", re.I),
    re.compile(r"\bUnited States\b", re.I),
    re.compile(r"\bAmerica\b", re.I),
)

_PREP_FIXES = (
    (re.compile(r"(?i)\bin\s+the\s+front\s+of\b"), "in front of"),
    (re.compile(r"(?i)\bin\s+the\s+middle\s+of\b"), "in the middle of"),
    (re.compile(r"(?i)\bat\s+the\s+side\s+of\b"), "at the side of"),
)

_NOISE_TOKEN_CHECKS = (
    re.compile(r"[0-9/\\]"),                       # digits / path separators
    re.compile(r"^(?:[A-Za-z]\.){2,}$"),           # dotted acronym
    re.compile(r"^[A-Z]{1,3}-[A-Za-z0-9]{1,6}$"),  # code-like token
)

_TAIL_PRUNES = (
    re.compile(r"(?i)\b(?:how|why|what|that|which)\b.*$"),
    re.compile(r"(?i)\bA\s+wonders\b.*$"),
)


def _strip_countries(text: str) -> str:
    for pat in _COUNTRY_PATTERNS:
        text = pat.sub("", text)
    return _MULTISPACE.sub(" ", text).strip()


def _fix_prepositions(text: str) -> str:
    for pat, repl in _PREP_FIXES:
        text = pat.sub(repl, text)
    return _MULTISPACE.sub(" ", text)


def _is_noise_token(raw: str) -> bool:
    if _NOISE_TOKEN_CHECKS[0].search(raw):
        return True
    if _NOISE_TOKEN_CHECKS[1].match(raw) or _NOISE_TOKEN_CHECKS[2].match(raw):
        return True
    return len(raw) <= 3 and raw.isupper()


def _truncate_on_noise(text: str) -> str:
    if not text:
        return text
    tokens = text.split()
    cut = len(tokens)
    for index, token in enumerate(tokens):
        raw = token.strip(",.;:!?()[]{}\"'`")
        if raw and _is_noise_token(raw):
            cut = index
            break
    trimmed = " ".join(tokens[:cut] if cut < len(tokens) else tokens).strip()
    if trimmed and trimmed[-1] not in ".!?":
        trimmed += "."
    return trimmed


def _prune_tails(text: str) -> str:
    for pat in _TAIL_PRUNES:
        text = pat.sub("", text).strip()
    return text or _FALLBACK


def _sit_complement(text: str) -> str:
    # Parity note: the reference (text_cleaner.py:24-32) early-returns on
    # "^someone is\b" BEFORE its sitting-specific branches, which makes those
    # branches unreachable — the function is observably the identity. The
    # unreachable branches are reproduced below the early return so the
    # intended spec stays documented without changing behavior.
    lowered = text.strip().lower()
    if re.match(r"^someone\s+is\b", lowered):
        return text
    if re.match(r"^someone\s+is\s+sitting\s*\.?$", lowered):  # pragma: no cover
        return "Someone is sitting on a chair."
    if re.match(r"^someone\s+is\s+sitting\b", lowered) and not re.search(  # pragma: no cover
        r"\b(in|on|at|by|with|near)\b", lowered
    ):
        return text.rstrip(". ") + " on a chair."
    return text


def _finalize(text: str) -> str:
    text = text.strip()
    if text and text[0].isalpha():
        text = text[0].upper() + text[1:]
    if text and text[-1] not in ".!?":
        text += "."
    return text


def clean_text(raw: str) -> str:
    text = (raw or "").strip()
    if _DECORATION_ONLY.fullmatch(text):
        return ""
    text = _DECORATION_LEAD.sub("", text)
    if (
        _URLISH_LEAD.match(text)
        or _COPYRIGHT_LEAD.match(text)
        or _QUOTED_ONLY.fullmatch(text)
    ):
        return ""
    if _BAD_LEADS.match(text) or _MARKUPISH.search(text):
        return ""

    flagged = bool(_SPAM_PHRASE.search(text))
    text = _SPAM_TAIL.sub("", text).strip()
    text = _strip_countries(text)
    text = _fix_prepositions(text)
    if len(text.split()) >= 10:
        text = _truncate_on_noise(text)
    text = _prune_tails(text)
    if flagged and len(text.split()) <= 2:
        text = _FALLBACK
    text = _sit_complement(text)
    text = _DUP_WORD.sub(r"\1", text)
    text = _finalize(_MULTISPACE.sub(" ", text).strip())

    parts = [chunk.strip() for chunk in _SENTENCE_SPLIT.split(text) if chunk.strip()]
    if len(parts) > 1:
        text = max(parts, key=score_sentence)
    return parts[0] if parts and parts[0] else text
