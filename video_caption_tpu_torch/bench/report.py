"""Report writers reproducing the reference benchmark artifact shapes
(core/scripts/benchmark_baseline.py:352-454): per-iteration CSV, batch-size
comparison CSV, and the summary JSON with mean/std/p99/max/min per stage.

Key names are kept verbatim (including ``Preprocess_CUDA_Latency`` — here it
measures the host->device transfer+commit time on TPU) so downstream parsers
of the reference's reports work unchanged.
"""
from __future__ import annotations

import csv
import json
import statistics
from pathlib import Path
from typing import Dict, List, Optional, Sequence


def stage_stats(samples_ms: Sequence[float]) -> Dict[str, float]:
    if not samples_ms:
        return {"mean": 0.0, "std": 0.0, "p99": 0.0, "max": 0.0, "min": 0.0}
    ordered = sorted(samples_ms)
    p99_idx = min(len(ordered) - 1, int(round(0.99 * (len(ordered) - 1))))
    return {
        "mean": statistics.fmean(samples_ms),
        "std": statistics.pstdev(samples_ms) if len(samples_ms) > 1 else 0.0,
        "p99": ordered[p99_idx],
        "max": ordered[-1],
        "min": ordered[0],
    }


ITERATION_COLUMNS = [
    "iteration", "preprocess_ms", "preprocess_device_ms", "vit_ms",
    "cross_modal_ms", "gpt2_ms", "gpt2_token_step_ms", "end_to_end_ms",
    "throughput_samples_s", "generated_tokens", "peak_memory_mb",
    "peak_memory_vit_mb", "peak_memory_gpt2_mb", "batch_size",
    "num_frames", "max_new_tokens", "dtype", "caption_preview",
]


def write_iteration_csv(path: Path, rows: List[Dict]) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=ITERATION_COLUMNS)
        writer.writeheader()
        for row in rows:
            writer.writerow({col: row.get(col, "") for col in ITERATION_COLUMNS})


def build_summary(
    stages: Dict[str, List[float]],
    throughput: List[float],
    env: Dict,
    config: Dict,
    generated_tokens: List[int],
    caption_preview: str = "",
    peak_memory_mb: Optional[Dict[str, float]] = None,
) -> Dict:
    """Summary JSON matching benchmark_baseline.py:352-385."""
    e2e = stage_stats(stages.get("end_to_end", []))
    summary = {
        "Preprocess_Latency": stage_stats(stages.get("preprocess", [])),
        "Preprocess_CUDA_Latency": stage_stats(stages.get("preprocess_device", [])),
        "ViT_Latency": stage_stats(stages.get("vit", [])),
        "Cross_Modal_Alignment": stage_stats(stages.get("cross_modal", [])),
        "GPT2_Latency": stage_stats(stages.get("gpt2", [])),
        "GPT2_token_step": stage_stats(stages.get("gpt2_token_step", [])),
        "End_to_end_Latency": e2e,
        "Throughput": {
            **{k: v for k, v in stage_stats(throughput).items() if k != "p99"},
            "from_mean_latency": (
                config.get("batch_size", 1) / (e2e["mean"] / 1000.0) if e2e["mean"] else 0.0
            ),
        },
        "generated_tokens": {
            "count": len(generated_tokens),
            "mean": statistics.fmean(generated_tokens) if generated_tokens else 0.0,
            "max": max(generated_tokens) if generated_tokens else 0,
        },
        "caption_preview": caption_preview,
        "peak_memory_mb": peak_memory_mb or {},
        "environment": env,
        "config": config,
    }
    return summary


BS_COLUMNS = [
    "batch_size", "status", "end_to_end_mean_ms", "end_to_end_std_ms",
    "vit_mean_ms", "cross_modal_mean_ms", "gpt2_mean_ms",
    "gpt2_token_step_mean_ms", "throughput_mean", "throughput_std",
    "peak_memory_mb",
]


def write_bs_comparison(path: Path, per_bs: List[Dict]) -> None:
    """Batch-sweep CSV (benchmark_baseline.py:424-448), incl. OOM rows."""
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=BS_COLUMNS)
        writer.writeheader()
        for row in per_bs:
            writer.writerow({col: row.get(col, "") for col in BS_COLUMNS})


def write_json(path: Path, payload: Dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=2) + "\n")
