"""Driver benchmark: captions/s and p50 video -> caption latency on
16-frame clips, on one card (counterpart of the root bench.py, which
stays as the JAX package's driver).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.

Runs the full product path: JPEG frames dir -> frame loader -> ViT-B/16
encode -> three decode presets -> text cleaning -> best-of-3. Weights are
seeded random where the checkpoint is absent (latency does not depend on
them).

- throughput: k-deep pipelining (k batches in flight, dispatched with
  ``infer_batch_dispatch`` before the oldest is collected) over distinct
  frame dirs with the device video cache off, median of the trials; then
  the same with the cache on (``warm_cache_caps_per_sec``);
- ``device_p50_ms``: the replay time of the request graph on a resident
  video (CUDA events), ``link_MBps`` the host -> device copy rate of a
  16 MB buffer;
- the roofline of the batch (bench/roofline.py): ``device_caps_per_sec``
  and the share of the bf16 peak per stage;
- ``kernel_launches``: each kernel's launches over the run;
- the workload: "core" (the engine's defaults) or "serving" (the
  "detailed" preset2), argv[4] or BENCH_WORKLOAD.

Any failure raises: there is no fallback line. The history of the
records is kept in reports/torch/bench_history.json.

Usage: python -m video_caption_tpu_torch.bench.driver [warmup] [iters] [batch] [workload]
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import time
from collections import deque
from pathlib import Path
from typing import Optional

import numpy as np
import torch

PIPELINE_DEPTH = int(os.environ.get("BENCH_PIPELINE_DEPTH", "4"))
TRIALS = int(os.environ.get("BENCH_TRIALS", "5"))
N_DISTINCT_DIRS = 64  # >= the default batch: every request in a batch is a distinct video
HISTORY = Path("reports/torch/bench_history.json")


def make_frames_dirs(n_dirs: int, num_frames: int = 40, size=(224, 224),
                     root: Optional[str] = None) -> list:
    """n_dirs distinct dirs of distinct JPEG content at 224x224 (under
    ``root``, else each a new temporary directory)."""
    from PIL import Image

    dirs = []
    for d_idx in range(n_dirs):
        d = tempfile.mkdtemp(prefix=f"vct_bench_{d_idx}_", dir=root)
        rng = np.random.RandomState(d_idx)
        for i in range(num_frames):
            Image.fromarray(rng.randint(0, 255, (*size, 3), np.uint8)).save(
                f"{d}/frame_{i:05d}.jpg", quality=95
            )
        dirs.append(d)
    return dirs


def pipelined_throughput(engine, dirs: list, batch: int, n_batches: int,
                         depth: int) -> float:
    """captions/s with ``depth`` batches in flight: dispatch (JPEG decode,
    upload, the program's replay) runs ahead of collect, so the host and
    the card work at once.

    The clock starts when the first batch is collected: the pipeline is
    full then, and the card has done no work that is credited. The
    ``n_batches`` batches collected after it are credited; the last
    ``depth`` batches, dispatched in the window, are collected after it
    and are not. (The root bench.py starts the clock after the first
    ``depth`` dispatches, while the card already runs them: with few timed
    batches the rate reads high.)"""
    total = n_batches + depth + 1
    batches = [
        [dirs[(b * batch + i) % len(dirs)] for i in range(batch)]
        for b in range(total)
    ]
    inflight = deque(engine.infer_batch_dispatch(batches[i]) for i in range(depth))
    next_dispatch, collected, t0 = depth, 0, None
    while next_dispatch < total:
        inflight.append(engine.infer_batch_dispatch(batches[next_dispatch]))
        next_dispatch += 1
        engine.infer_batch_collect(inflight.popleft())
        if t0 is None:
            t0 = time.perf_counter()
        else:
            collected += 1
    elapsed = time.perf_counter() - t0
    while inflight:  # drain, uncredited
        engine.infer_batch_collect(inflight.popleft())
    return batch * collected / elapsed


def _replay_ms(graph, video, runs: int) -> list:
    """Device ms of ``runs`` replays of a request graph, each between two
    CUDA events."""
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay(video)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def _link_mbps(device) -> float:
    """Host -> device MB/s of a 16 MB pageable buffer, median of 5."""
    buf = torch.from_numpy(np.zeros((16, 1024, 1024), np.uint8))
    buf.to(device)
    torch.cuda.synchronize(device)
    xfer = []
    for _ in range(5):
        t0 = time.perf_counter()
        buf.to(device)
        torch.cuda.synchronize(device)
        xfer.append(time.perf_counter() - t0)
    return buf.numel() / (1 << 20) / statistics.median(xfer)


def run(warmup: int, iters: int, batch: int, workload: str, root: str) -> dict:
    """The driver's record (see the module docstring); frame dirs under ``root``."""
    from video_caption_tpu_torch.aot import launch_counts
    from video_caption_tpu_torch.bench.roofline import measure_roofline
    from video_caption_tpu_torch.config import InferenceConfig, serving_inference_config
    from video_caption_tpu_torch.engine import InferenceEngine

    ckpt = "checkpoints/msvd_mapper_finetune_v2.pt"
    if workload == "serving":
        cfg = serving_inference_config(ckpt=ckpt, num_frames=16)
    else:
        workload = "core"
        cfg = InferenceConfig(ckpt=ckpt, num_frames=16)
    before = launch_counts()
    engine = InferenceEngine(cfg)
    # the headline is cold: every request pays JPEG decode and upload; the
    # device video cache would serve the cycled dirs from memory after one
    # lap, measured apart as warm_cache_caps_per_sec
    cache_budget = engine._video_cache_bytes
    engine._video_cache_bytes = 0
    dirs = make_frames_dirs(N_DISTINCT_DIRS, root=root)

    # single-stream latency (p50 video -> caption)
    for _ in range(warmup):
        engine.infer(dirs[0])
    lat = []
    for i in range(iters):
        t0 = time.perf_counter()
        engine.infer(dirs[i % len(dirs)])
        lat.append(time.perf_counter() - t0)
    p50 = statistics.median(lat)

    # the request graph alone on a resident video, and the upload rate
    vid1 = torch.zeros((1, cfg.num_frames, 3, cfg.image_size, cfg.image_size),
                       dtype=torch.uint8, device=engine.device)
    device_p50_ms = statistics.median(_replay_ms(engine.request_graph(vid1), vid1,
                                                 max(iters, 10)))
    link_mbps = _link_mbps(engine.device)

    # throughput: k-deep pipelined batches, median of TRIALS
    engine.infer_batch(dirs[:1] * batch)  # the batch size's graph
    n_batches = max(iters // 3, 3)
    trials = [pipelined_throughput(engine, dirs, batch, n_batches, PIPELINE_DEPTH)
              for _ in range(TRIALS)]
    caps_per_sec = statistics.median(trials)
    # warm cache: repeated content served from the device video cache;
    # skipped where the operator turned the cache off
    warm_caps = None
    if cache_budget > 0:
        engine._video_cache_bytes = max(cache_budget, 512 * 1024 * 1024)
        fill_batches = -(-len(dirs) // batch) + 1  # every dir once
        pipelined_throughput(engine, dirs, batch, fill_batches, 1)
        warm_caps = pipelined_throughput(engine, dirs, batch, n_batches, PIPELINE_DEPTH)
        engine._video_cache_bytes = 0
        engine._video_cache.clear()
        engine._video_cache_total = 0
    roofline = measure_roofline(engine, batch=batch, trials=5)
    launches = {m.__name__.rsplit(".", 1)[1]: n - before[m] for m, n in launch_counts().items()}

    record = {
        "metric": "captions_per_sec_per_chip",
        "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "value": caps_per_sec,
        "unit": "captions/s",
        "p50_latency_ms": p50 * 1000,
        "batch_size": batch,
        "iters": iters,
        "workload": workload,
        "pipeline_depth": PIPELINE_DEPTH,
        "throughput_trials": trials,
        "device_p50_ms": device_p50_ms,
        "link_MBps": link_mbps,
        "device_kind": torch.cuda.get_device_name(engine.device),
        "device_caps_per_sec": roofline["device_caps_per_sec"],
        "device_total_ms": roofline["device_total_ms"],
        "mfu_per_stage": {s["stage"]: s.get("pct_peak_flops") for s in roofline["stages"]},
        "kernel_launches": launches,
    }
    if len(trials) > 1:
        record["throughput_stddev"] = statistics.stdev(trials)
    if warm_caps is not None:
        record["warm_cache_caps_per_sec"] = warm_caps
    return record


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    warmup = int(argv[0]) if len(argv) > 0 else 3
    iters = int(argv[1]) if len(argv) > 1 else 15
    batch = int(argv[2]) if len(argv) > 2 else 64
    workload = (argv[3] if len(argv) > 3
                else os.environ.get("BENCH_WORKLOAD", "core")).lower()
    with tempfile.TemporaryDirectory(prefix="vct_bench_") as root:
        record = run(warmup, iters, batch, workload, root)

    history = json.loads(HISTORY.read_text()) if HISTORY.is_file() else []
    # no published baseline: the first record kept is the baseline, so
    # vs_baseline tracks the gain since then
    first = history[0]["value"] if history else None
    record["vs_baseline"] = record["value"] / first if first else 1.0
    history.append(record)
    HISTORY.parent.mkdir(parents=True, exist_ok=True)
    HISTORY.write_text(json.dumps(history, indent=1) + "\n")

    extra = {k: record[k] for k in (
        "device_caps_per_sec", "warm_cache_caps_per_sec", "p50_latency_ms",
        "device_p50_ms", "link_MBps", "batch_size", "workload", "device_kind",
        "kernel_launches",
    ) if k in record}
    print(json.dumps({**{k: record[k] for k in ("metric", "value", "unit", "vs_baseline")},
                      **extra}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
