"""Result plotting (counterpart of video_caption_tpu/scripts/plot_results.py;
reference: scripts/plot_loss.py, experiments/plot_results*.py):
training-loss curves from events.csv/val.csv, BLEU comparison bars from
eval_compare output, decode-ablation heat table. Headless matplotlib (Agg);
every function returns the output path.

    python -m video_caption_tpu_torch.scripts.plot_results --run_dir RUN
"""
from __future__ import annotations

import argparse
import csv
import logging
from pathlib import Path
from typing import List, Optional

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

log = logging.getLogger(__name__)


def _read_csv(path: Path) -> List[dict]:
    with path.open() as fh:
        return list(csv.DictReader(fh))


def plot_loss(run_dir: str, out_path: Optional[str] = None) -> str:
    run = Path(run_dir)
    out_path = out_path or str(run / "loss.png")
    fig, ax = plt.subplots(figsize=(7, 4))
    events = run / "events.csv"
    if events.is_file():
        rows = _read_csv(events)
        ax.plot([int(r["step"]) for r in rows], [float(r["loss"]) for r in rows],
                label="train", lw=1)
    val = run / "val.csv"
    if val.is_file():
        rows = _read_csv(val)
        if rows:
            ax.plot([int(r["step"]) for r in rows], [float(r["val_loss"]) for r in rows],
                    "o-", label="val")
    ax.set_xlabel("step")
    ax.set_ylabel("loss")
    ax.legend()
    ax.set_title(run.name)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    log.info("wrote %s", out_path)
    return out_path


def plot_bleu_compare(summary: dict, out_path: str = "outputs/bleu_compare.png") -> str:
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.bar(["A", "B"], [summary.get("corpus_bleu_a", 0), summary.get("corpus_bleu_b", 0)])
    ax.set_ylabel("corpus BLEU")
    ax.set_title(f"A/B BLEU over {summary.get('num_samples', 0)} samples")
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_benchmark_stages(summary_json: str, out_path: str = "reports/stages.png") -> str:
    import json

    summary = json.loads(Path(summary_json).read_text())
    stages = ["Preprocess_Latency", "ViT_Latency", "Cross_Modal_Alignment", "GPT2_Latency"]
    means = [summary[s]["mean"] for s in stages]
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.bar([s.replace("_Latency", "") for s in stages], means)
    ax.set_ylabel("mean ms")
    ax.set_title("Per-stage latency")
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser()
    p.add_argument("--run_dir", default="")
    p.add_argument("--bench_summary", default="")
    args = p.parse_args(argv)
    if args.run_dir:
        plot_loss(args.run_dir)
    if args.bench_summary:
        plot_benchmark_stages(args.bench_summary)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
