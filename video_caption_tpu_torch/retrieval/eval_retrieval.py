"""Retrieval evaluation: Recall@1 / Recall@5 / MRR of video self-retrieval
(counterpart of video_caption_tpu/retrieval/eval_retrieval.py; reference:
scripts/eval_retrieval.py:33-52). Query features against the index; a hit
is the query's own video id.

Usage: python -m video_caption_tpu_torch.retrieval.eval_retrieval --features_dir D
"""
from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

from video_caption_tpu_torch.retrieval.index import VectorIndex

log = logging.getLogger(__name__)


def evaluate_retrieval(
    query_feats: np.ndarray,
    query_ids: Sequence[str],
    index: VectorIndex,
    index_ids: Sequence[str],
    ks: Sequence[int] = (1, 5),
) -> Dict[str, float]:
    max_k = max(max(ks), 10)
    _, nbrs = index.search(query_feats, max_k)
    ranks: List[int] = []
    for qid, row in zip(query_ids, nbrs):
        rank = 0
        for j, idx in enumerate(row):
            if index_ids[int(idx)] == qid:
                rank = j + 1
                break
        ranks.append(rank)

    out: Dict[str, float] = {}
    for k in ks:
        out[f"recall@{k}"] = sum(1 for r in ranks if 0 < r <= k) / max(len(ranks), 1)
    out["mrr"] = sum(1.0 / r for r in ranks if r > 0) / max(len(ranks), 1)
    out["num_queries"] = len(ranks)
    return out


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser()
    p.add_argument("--features_dir", required=True,
                   help="dir from retrieval.features.extract_features")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    feats = np.load(Path(args.features_dir) / "features.npy")
    ids = json.loads((Path(args.features_dir) / "ids.json").read_text())
    index = VectorIndex(feats.shape[1])
    index.add(feats)
    metrics = evaluate_retrieval(feats, ids, index, ids)
    print(json.dumps(metrics, indent=1))
    if args.out:
        Path(args.out).write_text(json.dumps(metrics, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
