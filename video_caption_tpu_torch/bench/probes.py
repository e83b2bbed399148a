"""Small benchmark and memory probes (counterpart of
video_caption_tpu/bench/probes.py), thin drivers over the instrumented
paths, on the card:

    python -m video_caption_tpu_torch.bench.probes latency    [--iters N]
    python -m video_caption_tpu_torch.bench.probes throughput [--requests N]
    python -m video_caption_tpu_torch.bench.probes memory

- ``latency``: per-stage latency of one inference (preprocess / encoder /
  cross-modal / decoder / end-to-end) through bench.benchmark.StageBench;
- ``throughput``: serial single-request throughput through the engine;
- ``memory``: device memory at load / warmup / after an inference through
  memory.MemoryManager (bytes in use, the card's total, the peak).
"""
from __future__ import annotations

import argparse
import json
import logging
import statistics
import time

log = logging.getLogger(__name__)


def probe_latency(iters: int = 10, num_frames: int = 16, device="cuda") -> dict:
    from video_caption_tpu_torch.bench.benchmark import StageBench, _make_synth_frames
    from video_caption_tpu_torch.config import default_inference_config

    bench = StageBench(default_inference_config(num_frames=num_frames), batch_size=1,
                       device=device)
    frames = _make_synth_frames()
    bench.run_iteration(frames)  # kernel build, graph captures
    rows = [bench.run_iteration(frames) for _ in range(iters)]
    keys = ("preprocess_ms", "vit_ms", "cross_modal_ms", "gpt2_ms",
            "gpt2_token_step_ms", "end_to_end_ms")
    return {k: {
        "mean": statistics.mean(r[k] for r in rows),
        "p50": statistics.median(r[k] for r in rows),
    } for k in keys}


def probe_throughput(requests: int = 20, num_frames: int = 16, device="cuda") -> dict:
    from video_caption_tpu_torch.bench.benchmark import _make_synth_frames
    from video_caption_tpu_torch.config import default_inference_config
    from video_caption_tpu_torch.engine import InferenceEngine

    engine = InferenceEngine(default_inference_config(num_frames=num_frames), device=device)
    frames = _make_synth_frames()
    engine.infer(frames)  # kernel build, graph capture
    t0 = time.perf_counter()
    for _ in range(requests):
        engine.infer(frames)
    wall = time.perf_counter() - t0
    return {"requests": requests, "wall_s": wall,
            "serial_requests_per_sec": requests / wall}


def probe_memory(num_frames: int = 16, device="cuda") -> dict:
    from video_caption_tpu_torch.bench.benchmark import _make_synth_frames
    from video_caption_tpu_torch.config import default_inference_config
    from video_caption_tpu_torch.engine import InferenceEngine
    from video_caption_tpu_torch.memory import MemoryManager

    mm = MemoryManager(device=device)

    def snap():
        s = mm.snapshot()
        mb = lambda b: b / 1e6 if b is not None else None
        return {"in_use_mb": s.mb_in_use, "limit_mb": mb(s.bytes_limit),
                "peak_mb": mb(s.peak_bytes_in_use)}

    out = {"baseline": snap()}
    engine = InferenceEngine(default_inference_config(num_frames=num_frames), device=device)
    out["after_load"] = snap()
    frames = _make_synth_frames()
    engine.infer(frames)
    out["after_warmup"] = snap()
    engine.infer(frames)
    out["after_inference"] = snap()
    return out


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("probe", choices=["latency", "throughput", "memory"])
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--requests", type=int, default=20)
    p.add_argument("--num_frames", type=int, default=16)
    args = p.parse_args(argv)
    if args.probe == "latency":
        result = probe_latency(args.iters, args.num_frames)
    elif args.probe == "throughput":
        result = probe_throughput(args.requests, args.num_frames)
    else:
        result = probe_memory(args.num_frames)
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
