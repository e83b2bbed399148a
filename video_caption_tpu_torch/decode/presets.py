"""Decode-policy registry (reference: core/inference.py:4-17).

Each preset maps to kwargs for decode/generate.py; same names, same values,
so benchmark and serving requests are comparable with the reference.
"""
from __future__ import annotations

_PRESETS = {
    "precise": dict(
        num_beams=3, max_new_tokens=24, temperature=1.0, top_p=1.0,
        no_repeat_ngram_size=3, repetition_penalty=1.1,
    ),
    "detailed": dict(
        num_beams=4, max_new_tokens=40, temperature=1.0, top_p=1.0,
        no_repeat_ngram_size=3, repetition_penalty=1.1,
    ),
    # Sampled presets carry top_k=50: the reference calls HF generate without
    # top_k, which applies GenerationConfig's DEFAULT TopKLogitsWarper(50)
    # (core/inference.py:13-16 + transformers GenerationConfig.top_k=50), so
    # matching its sampling distribution requires the warper here too.
    "natural": dict(
        num_beams=1, max_new_tokens=24, temperature=0.9, top_p=0.9, top_k=50,
        no_repeat_ngram_size=3, repetition_penalty=1.05,
    ),
    "safe_sample": dict(
        num_beams=1, max_new_tokens=22, temperature=0.8, top_p=0.85, top_k=50,
        no_repeat_ngram_size=3, repetition_penalty=1.1,
    ),
}


def preset_to_kwargs(name: str) -> dict:
    return dict(_PRESETS.get((name or "precise").lower(), _PRESETS["precise"]))


def preset_names() -> tuple:
    return tuple(_PRESETS)
