"""Inner-product retrieval index with caption metadata
(reference: scripts/build_index.py, build_index_with_captions.py:33-45).

faiss IndexFlatIP when faiss is importable; otherwise an exact numpy
inner-product index with identical semantics (features are L2-normalized, so
IP == cosine). meta.json carries video_id + first caption per row.
"""
from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger(__name__)


class VectorIndex:
    """Exact IP index: numpy fallback API-compatible with the faiss path."""

    def __init__(self, dim: int):
        self.dim = dim
        self._faiss = None
        try:
            import faiss

            self._faiss = faiss.IndexFlatIP(dim)
        except ImportError:
            self._vectors = np.zeros((0, dim), np.float32)

    @property
    def backend(self) -> str:
        return "faiss" if self._faiss is not None else "numpy"

    @property
    def ntotal(self) -> int:
        return self._faiss.ntotal if self._faiss is not None else len(self._vectors)

    def add(self, vectors: np.ndarray) -> None:
        vectors = np.ascontiguousarray(vectors, np.float32)
        if self._faiss is not None:
            self._faiss.add(vectors)
        else:
            self._vectors = np.concatenate([self._vectors, vectors])

    def search(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        queries = np.ascontiguousarray(queries, np.float32)
        if self._faiss is not None:
            return self._faiss.search(queries, k)
        scores = queries @ self._vectors.T                     # [Q, N]
        k = min(k, scores.shape[1])
        idx = np.argpartition(-scores, kth=k - 1, axis=1)[:, :k]
        part = np.take_along_axis(scores, idx, axis=1)
        order = np.argsort(-part, axis=1)
        return np.take_along_axis(part, order, 1), np.take_along_axis(idx, order, 1)


def build_index(
    features: np.ndarray,
    video_ids: Sequence[str],
    out_dir: str,
    captions: Optional[Dict[str, str]] = None,
) -> VectorIndex:
    """Builds the index + meta.json (video_id, caption per row)."""
    index = VectorIndex(features.shape[1])
    index.add(features)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    np.save(out / "index_vectors.npy", features.astype(np.float32))
    meta = [
        {"video_id": vid, "caption": (captions or {}).get(vid, "")}
        for vid in video_ids
    ]
    (out / "meta.json").write_text(json.dumps(meta, indent=1))
    log.info("built %s index with %d vectors", index.backend, index.ntotal)
    return index


def load_index(out_dir: str) -> Tuple[VectorIndex, List[Dict]]:
    out = Path(out_dir)
    vectors = np.load(out / "index_vectors.npy")
    meta = json.loads((out / "meta.json").read_text())
    index = VectorIndex(vectors.shape[1])
    index.add(vectors)
    return index, meta
