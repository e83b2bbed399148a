"""Concurrent-serving load benchmark (counterpart of
video_caption_tpu/bench/serving_load.py): concurrent video uploads,
batched encode + decode at a fixed offered QPS.

Boots the port's stdlib HTTP server in-process over an engine on the card,
fires concurrent POST /infer requests at a fixed offered QPS from worker
threads, and reports achieved QPS and latency percentiles. The coalescing
queue turns co-arriving requests into batched programs, one CUDA graph per
batch size.

Usage:
    python -m video_caption_tpu_torch.bench.serving_load --qps 8 --duration 20
    python -m video_caption_tpu_torch.bench.serving_load --sweep
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import logging
import statistics
import threading
import time
import urllib.request
from pathlib import Path
from typing import List

log = logging.getLogger(__name__)


def _boot_server(frames_dir: str, num_frames: int = 16, max_batch: int = 8,
                 port: int = 0):
    """Build and warm the serving stack once (the engine, the graph of
    every batch size the queue can form, the HTTP server); returns (config,
    srv, url, payload) for one or many load runs."""
    import os

    from video_caption_tpu_torch.config import serving_inference_config
    from video_caption_tpu_torch.server.services.model_registry import MODEL_REGISTRY
    from video_caption_tpu_torch.server.stdlib_server import StdlibServer

    # the coalescing queue reads its cap from the environment when it is
    # created (inference_service.py): the benched cap matches the captured sizes
    os.environ["VIDEO_CAPTION_SERVE_MAX_BATCH"] = str(max_batch)
    # the serving presets, with the heavier "detailed" preset2
    config = serving_inference_config(num_frames=num_frames)
    engine = MODEL_REGISTRY.get_engine(config)
    engine.warmup()
    # capture every batch size the queue can dispatch (1, 2, 4, ..., max):
    # a size first met under load waits for its capture in the queue's worker
    b = 1
    while b <= max_batch:
        engine.infer_batch([frames_dir] * b)
        b *= 2

    srv = StdlibServer("127.0.0.1", port).start()
    url = f"http://127.0.0.1:{srv.port}/api/v1/infer"
    payload = json.dumps({"frames_dir": frames_dir, "num_frames": num_frames}).encode()
    return config, srv, url, payload


def run_load(
    frames_dir: str, qps: float, duration_s: float, port: int = 0,
    num_frames: int = 16, max_batch: int = 8, _booted=None,
) -> dict:
    if _booted is None:
        config, srv, url, payload = _boot_server(
            frames_dir, num_frames, max_batch, port)
        own_server = True
    else:
        config, srv, url, payload = _booted
        own_server = False

    latencies: List[float] = []
    errors: List[str] = []
    lock = threading.Lock()

    def fire():
        t0 = time.perf_counter()
        try:
            req = urllib.request.Request(
                url, data=payload, headers={"Content-Type": "application/json"},
                method="POST",
            )
            with urllib.request.urlopen(req, timeout=120) as resp:
                resp.read()
            with lock:
                latencies.append(time.perf_counter() - t0)
        except OSError as exc:      # HTTP errors, refused and reset connections
            with lock:
                errors.append(str(exc))

    threads: List[threading.Thread] = []
    interval = 1.0 / qps
    start = time.perf_counter()
    n_sent = 0
    while time.perf_counter() - start < duration_s:
        t = threading.Thread(target=fire)
        t.start()
        threads.append(t)
        n_sent += 1
        next_at = start + n_sent * interval
        sleep = next_at - time.perf_counter()
        if sleep > 0:
            time.sleep(sleep)
    for t in threads:
        t.join(timeout=180)
    wall = time.perf_counter() - start
    if own_server:
        srv.stop()

    lat_sorted = sorted(latencies)
    result = {
        "server": "stdlib_server",
        "fastapi_available": importlib.util.find_spec("fastapi") is not None,
        "workload_presets": [config.preset1, config.preset2, config.preset3],
        "offered_qps": qps,
        # completed / full wall (send window + straggler drain);
        # send_window_qps is the sustained-load gate's input, the p99 gate
        # bounding how much drain after the window it can hide
        "achieved_qps": len(latencies) / wall,
        "send_window_qps": len(latencies) / duration_s,
        "requests_sent": n_sent,
        "requests_ok": len(latencies),
        # every request sent and not answered: failed, or still open after its join
        "errors": n_sent - len(latencies),
        "error_samples": errors[:3],
        "duration_s": wall,
        "latency_ms": {
            "p50": statistics.median(lat_sorted) * 1000 if lat_sorted else None,
            "p90": lat_sorted[int(0.9 * (len(lat_sorted) - 1))] * 1000 if lat_sorted else None,
            "p99": lat_sorted[int(0.99 * (len(lat_sorted) - 1))] * 1000 if lat_sorted else None,
            "max": lat_sorted[-1] * 1000 if lat_sorted else None,
        },
    }
    return result


def run_sweep(
    frames_dir: str, qps_levels=None, duration_s: float = 25.0,
    num_frames: int = 16, max_batch: int = 8,
    p99_limit_ms: float = 2000.0, achieved_ratio: float = 0.97,
) -> dict:
    """Offered-QPS sweep to the saturation knee.

    Climbs offered QPS over one warmed server until either achieved QPS
    falls below ``achieved_ratio`` x offered (the queue cannot keep up) or
    p99 exceeds ``p99_limit_ms`` (the latency knee), then stops. "Max
    sustainable" is the last level that passed both gates; the first level
    past the knee stays in the curve. A ladder passed to its end keeps
    climbing by 1.5x until it degrades. Then the cache-off row: a fresh
    server with the device video cache off, at the measured capacity.
    """
    booted = _boot_server(frames_dir, num_frames, max_batch)
    if qps_levels is None:
        qps_levels = ([8, 12, 16, 20, 24, 28, 32, 40, 48, 64]
                      if max_batch <= 8 else
                      [32, 64, 96, 112, 128, 144, 160, 176, 192])
    curve, max_ok = [], None
    knee_found = False
    try:
        q_iter = list(qps_levels)
        while q_iter:
            q = q_iter.pop(0)
            r = run_load(frames_dir, q, duration_s, num_frames=num_frames,
                         _booted=booted)
            ok = (r["errors"] == 0
                  and r["send_window_qps"] >= achieved_ratio * q
                  and (r["latency_ms"]["p99"] or 1e9) <= p99_limit_ms)
            r["sustained"] = ok
            curve.append(r)
            log.info("qps %s -> achieved %.2f p50 %s p99 %s %s", q,
                     r["achieved_qps"], r["latency_ms"]["p50"],
                     r["latency_ms"]["p99"], "OK" if ok else "KNEE")
            if ok:
                max_ok = r
                if not q_iter:
                    q_iter.append(int(q * 1.5))
            else:
                knee_found = True
                break
    finally:
        booted[1].stop()
    cache_off = None
    if max_ok is not None:
        # every request decodes and uploads its frames again; a fresh
        # engine, since the cache budget is read when an engine is built
        import os

        from video_caption_tpu_torch.server.services.model_registry import MODEL_REGISTRY

        old = os.environ.get("VIDEO_CAPTION_VIDEO_CACHE_MB")
        os.environ["VIDEO_CAPTION_VIDEO_CACHE_MB"] = "0"
        MODEL_REGISTRY.clear()
        try:
            booted2 = _boot_server(frames_dir, num_frames, max_batch)
            try:
                cache_off = run_load(frames_dir, max_ok["offered_qps"],
                                     duration_s, num_frames=num_frames,
                                     _booted=booted2)
            finally:
                booted2[1].stop()
        finally:
            if old is None:
                os.environ.pop("VIDEO_CAPTION_VIDEO_CACHE_MB", None)
            else:
                os.environ["VIDEO_CAPTION_VIDEO_CACHE_MB"] = old
            MODEL_REGISTRY.clear()
    return {
        "workload_presets": curve[0]["workload_presets"] if curve else None,
        "duration_s_per_level": duration_s,
        "gates": {"p99_limit_ms": p99_limit_ms, "achieved_ratio": achieved_ratio},
        "max_sustainable_qps": max_ok["offered_qps"] if max_ok else 0,
        "knee_found": knee_found,
        "at_max": {k: max_ok[k] for k in ("achieved_qps", "latency_ms")} if max_ok else None,
        "cache_off_at_max": cache_off,
        "curve": curve,
    }


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser()
    p.add_argument("--frames_dir", default="")
    p.add_argument("--qps", type=float, default=8.0)
    p.add_argument("--duration", type=float, default=20.0)
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--sweep", action="store_true",
                   help="offered-QPS sweep to the saturation knee")
    p.add_argument("--max_batch", type=int, default=8,
                   help="coalescing-queue cap (every batch size captured at boot)")
    p.add_argument("--out", default="reports/torch/serving_load.json")
    args = p.parse_args(argv)

    frames = args.frames_dir
    if not frames:
        from video_caption_tpu_torch.bench.benchmark import _make_synth_frames

        frames = _make_synth_frames()
    if args.sweep:
        if args.out == "reports/torch/serving_load.json":
            args.out = "reports/torch/serving_load_sweep.json"
        result = run_sweep(frames, duration_s=args.duration,
                           num_frames=args.num_frames,
                           max_batch=args.max_batch)
    else:
        result = run_load(frames, args.qps, args.duration,
                          num_frames=args.num_frames, max_batch=args.max_batch)
    print(json.dumps(result, indent=1))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1) + "\n")
    # a fixed-rate run fails on any unanswered request; the sweep reads
    # errors as its knee
    return 1 if not args.sweep and result["errors"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
