"""Best-of batch inference with content filtering for human evaluation
(counterpart of video_caption_tpu/tools/batch_bestof.py; reference:
tools/batch_bestof.py): candidates are screened by a content-safety/spam
regex, then scored with a 13-word-peak length prior plus verb/noun/place
lexicon bonuses; the best surviving candidate per video goes into the
human-eval CSV. The scoring is host code, the JAX module's own.

    python -m video_caption_tpu_torch.tools.batch_bestof --ann_path A.json \\
        --out bestof.csv [--device cuda]
"""
from __future__ import annotations

import argparse
import csv
import logging
import re
from pathlib import Path
from typing import Dict, List, Sequence

log = logging.getLogger(__name__)

BAD_REGEX = re.compile(
    r"(http[s]?://\S+|www\.\S+|youtube|facebook|subscribe|channel|report abuse|menu|fullscreen|"
    r"the video (will|begins|shows)|one sentence|the first sentence|"
    r"\bi am\b|\bi'm\b|\bmy\b|\bour\b|"
    r"killed|shot|gun|blood|dead|murder|naked|unclothed|nudity)",
    re.I,
)
START_TEMPLATE_RE = re.compile(r"^(this|that|it)\s+is\s+(the|a)\s+", re.I)

VERB_HINTS = frozenset("""is are was were be being been am has have having had
walk walks walking walked run runs running ran talk talks talking talked
look looks looking looked hold holds holding held sit sits sitting sat
stand stands standing stood play plays playing played cook cooks cooking cooked
drive drives driving drove ride rides riding rode cut cuts cutting
pour pours pouring poured open opens opening opened close closes closing closed
throw throws throwing threw catch catches catching caught read reads reading""".split())
NOUN_HINTS = frozenset("""man woman boy girl person people player child baby dog cat
car ball food phone camera street room kitchen table water animal""".split())
PLACE_HINTS = frozenset("in on at under with near inside outside into around over by".split())

_LEN_PEAK = 13  # words (reference: batch_bestof.py:94)


def score_sentence(s: str) -> float:
    if not s:
        return -1e9
    if BAD_REGEX.search(s):
        return -100.0
    txt = s.strip()
    pen = -2.0 if START_TEMPLATE_RE.match(txt) else 0.0
    words = txt.split()
    len_score = -abs(len(words) - _LEN_PEAK)
    lower = [w.lower() for w in words]
    bonus = (
        (1.2 if any(w in VERB_HINTS for w in lower) else 0.0)
        + (1.0 if any(w in NOUN_HINTS for w in lower) else 0.0)
        + (0.5 if any(w in PLACE_HINTS for w in lower) else 0.0)
    )
    if txt.endswith((".", "!", "?")):
        bonus += 0.5
    return len_score + bonus + pen


def pick_best(candidates: Sequence[str]) -> str:
    scored = sorted(((score_sentence(c), c) for c in candidates), reverse=True)
    return scored[0][1] if scored else ""


def bestof_from_rows(rows: List[Dict]) -> List[Dict]:
    """Rows from tools/batch_infer.batch_infer -> human-eval rows."""
    out = []
    for row in rows:
        best = pick_best([row.get("S1", ""), row.get("S2", ""), row.get("S3", "")])
        out.append({"video_id": row.get("video_id", ""), "caption": best})
    return out


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser()
    p.add_argument("--ann_path", required=True)
    p.add_argument("--out", default="outputs/bestof.csv")
    p.add_argument("--ckpt", default="")
    p.add_argument("--num_frames", type=int, default=8)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from video_caption_tpu_torch.tools.batch_infer import batch_infer

    rows = batch_infer(args.ann_path, str(Path(args.out).with_suffix(".raw.csv")),
                       args.ckpt, args.num_frames, args.limit, device=args.device)
    best_rows = bestof_from_rows(rows)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=["video_id", "caption"])
        writer.writeheader()
        writer.writerows(best_rows)
    log.info("wrote %d best-of rows to %s", len(best_rows), out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
