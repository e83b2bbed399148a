"""Profiler capture (counterpart of video_caption_tpu/bench/profile.py).

One ``StageBench`` iteration under ``torch.profiler`` (host and CUDA
activity), inside an ``Inference_Once`` range that holds the benchmark's
Preprocessing / ViT_Encoder / Cross_Modal_Alignment / GPT2_Decoder_Step
ranges; the timeline goes to a chrome trace (``torch_trace/trace.json``,
readable in chrome://tracing or Perfetto), and ``profile_once.json``
holds the iteration's per-stage times.

Usage: python -m video_caption_tpu_torch.bench.profile --frames_dir PATH
"""
from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from video_caption_tpu_torch.bench.benchmark import StageBench, _make_synth_frames
from video_caption_tpu_torch.bench.report import write_json
from video_caption_tpu_torch.config import default_inference_config
from video_caption_tpu_torch.env import device_summary

log = logging.getLogger(__name__)


def run_one_profile(frames_dir: str, out_dir: Path, warmup: int = 3,
                    num_frames: int = 16, max_new_tokens: int = 24, device="cuda",
                    **bench_kw) -> dict:
    """``bench_kw``: StageBench's params, model_cfg, seed."""
    config = default_inference_config(num_frames=num_frames)
    bench = StageBench(config, batch_size=1, max_new_tokens=max_new_tokens, device=device,
                       **bench_kw)
    for _ in range(warmup):
        bench.run_iteration(frames_dir)

    trace_dir = out_dir / "torch_trace"
    trace_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if bench.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        with record_function("Inference_Once"):
            row = bench.run_iteration(frames_dir)
    wall = time.perf_counter() - t0
    prof.export_chrome_trace(str(trace_dir / "trace.json"))

    meta = {
        "stages_ms": {k: row[k] for k in (
            "preprocess_ms", "preprocess_device_ms", "vit_ms",
            "cross_modal_ms", "gpt2_ms", "gpt2_token_step_ms", "end_to_end_ms",
        )},
        "trace_dir": str(trace_dir),
        "profile_wall_s": wall,
        "environment": device_summary(bench.device),
    }
    write_json(out_dir / "profile_once.json", meta)
    log.info("profile written to %s (trace in %s)", out_dir / "profile_once.json", trace_dir)
    return meta


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser()
    p.add_argument("--frames_dir", default="")
    p.add_argument("--out_dir", default="reports/torch")
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--num_frames", type=int, default=16)
    args = p.parse_args(argv)
    frames = args.frames_dir or _make_synth_frames()
    run_one_profile(frames, Path(args.out_dir), args.warmup, args.num_frames)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
