"""Result datatypes for the three-preset caption pipeline
(API parity: core/datatypes.py:7-30 — same field names, same
``to_api_dict`` payload shape consumed by server schemas and batch tools).
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Dict, Iterator, List, Tuple

CANDIDATE_KEYS: Tuple[str, ...] = ("S1", "S2", "S3")


@dataclass(frozen=True)
class CaptionCandidates:
    """The three candidate captions one video produces (one per preset)."""

    s1: str
    s2: str
    s3: str

    @classmethod
    def from_texts(cls, texts: List[str]) -> "CaptionCandidates":
        return cls(*texts[:3])

    def items(self) -> Iterator[Tuple[str, str]]:
        """(API key, caption) pairs in preset order — feeds select_best."""
        for key, field in zip(CANDIDATE_KEYS, fields(self)):
            yield key, getattr(self, field.name)


@dataclass(frozen=True)
class InferenceResult:
    """Candidates plus the heuristically ranked winner."""

    candidates: CaptionCandidates
    best_key: str
    best_text: str

    @classmethod
    def from_candidates(cls, candidates: CaptionCandidates) -> "InferenceResult":
        from video_caption_tpu_torch.postprocessing.candidate_ranker import select_best

        key, text, _ = select_best(list(candidates.items()))
        return cls(candidates=candidates, best_key=key, best_text=text)

    def to_api_dict(self) -> Dict[str, object]:
        payload: Dict[str, object] = dict(self.candidates.items())
        payload["BEST"] = {"key": self.best_key, "text": self.best_text}
        return payload
