"""Human-evaluation questionnaire generation + ratings chart (counterpart of
video_caption_tpu/tools/human_eval.py; reference:
experiments/generate_human_eval.py:43-50, tools/human_val_image.py): samples
captions into length buckets for a balanced questionnaire CSV, and renders
the Fluency/Relevance/Specificity/Overall ratings bar chart. Its input is
the CSV that tools/batch_infer.py writes.

    python -m video_caption_tpu_torch.tools.human_eval --results_csv rows.csv \\
        --out questionnaire.csv
"""
from __future__ import annotations

import argparse
import csv
import logging
import random
from pathlib import Path
from typing import Dict, List, Sequence

log = logging.getLogger(__name__)

LENGTH_BUCKETS = ((0, 7), (8, 13), (14, 100))  # short / medium / long (words)
RATING_AXES = ("Fluency", "Relevance", "Specificity", "Overall")


def bucket_of(caption: str) -> int:
    n = len(caption.split())
    for i, (lo, hi) in enumerate(LENGTH_BUCKETS):
        if lo <= n <= hi:
            return i
    return len(LENGTH_BUCKETS) - 1


def sample_questionnaire(
    rows: Sequence[Dict], n_samples: int = 30, seed: int = 0,
) -> List[Dict]:
    """Balanced sampling across length buckets (generate_human_eval.py:43-50)."""
    rng = random.Random(seed)
    buckets: Dict[int, List[Dict]] = {i: [] for i in range(len(LENGTH_BUCKETS))}
    for row in rows:
        caption = row.get("best_text") or row.get("caption", "")
        if caption:
            buckets[bucket_of(caption)].append(row)
    per_bucket = max(n_samples // len(LENGTH_BUCKETS), 1)
    picked: List[Dict] = []
    for items in buckets.values():
        rng.shuffle(items)
        picked.extend(items[:per_bucket])
    rng.shuffle(picked)
    return picked[:n_samples]


def write_questionnaire(rows: Sequence[Dict], out_csv: str) -> str:
    out = Path(out_csv)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("w", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow(["video_id", "caption", *RATING_AXES])
        for row in rows:
            caption = row.get("best_text") or row.get("caption", "")
            writer.writerow([row.get("video_id", ""), caption, "", "", "", ""])
    log.info("questionnaire with %d rows -> %s", len(rows), out)
    return str(out)


def plot_ratings(ratings_csv: str, out_png: str = "outputs/human_eval_ratings.png") -> str:
    """Percent-per-score bar chart (tools/human_val_image.py:10-17)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(ratings_csv) as fh:
        rows = list(csv.DictReader(fh))
    fig, axes = plt.subplots(1, len(RATING_AXES), figsize=(4 * len(RATING_AXES), 3.5))
    for ax, axis in zip(axes, RATING_AXES):
        scores = [int(r[axis]) for r in rows if r.get(axis, "").strip().isdigit()]
        counts = [scores.count(s) for s in range(1, 6)]
        total = max(sum(counts), 1)
        ax.bar(range(1, 6), [100 * c / total for c in counts])
        ax.set_title(axis)
        ax.set_xlabel("rating")
        ax.set_ylabel("%")
    Path(out_png).parent.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return out_png


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser()
    p.add_argument("--results_csv", required=True, help="batch_infer output")
    p.add_argument("--out", default="outputs/human_eval_questionnaire.csv")
    p.add_argument("--n", type=int, default=30)
    p.add_argument("--plot_ratings", default="")
    args = p.parse_args(argv)
    with open(args.results_csv) as fh:
        rows = list(csv.DictReader(fh))
    write_questionnaire(sample_questionnaire(rows, args.n), args.out)
    if args.plot_ratings:
        plot_ratings(args.plot_ratings)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
