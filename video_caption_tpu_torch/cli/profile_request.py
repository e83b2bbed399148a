"""Where one request's time goes on the GPU, for each decode configuration
of the port, on the request graph (the default) or eagerly.

    python -m video_caption_tpu_torch.cli.profile_request [--eager] [--requests 6] [--trace-dir DIR]

Builds the full-width engine (ViT-B/16 + GPT-2 124M, seeded random bf16
weights, 16 frames of 224x224 JPEGs, core presets) once per configuration
(``CONFIGS``): the default (the request's groups in one unified loop),
``grouped`` (``compile.unified_fused_request`` off),
``compile.use_pallas_decode_attention`` (with the unified loop off, which
never reaches that kernel), ``compile.use_pallas_decode_layer`` and
``compile.deferred_decode_cache_write``, all on the same weights. Requests
cycle over 3 frame directories, so from the fourth on the frames come from
the engine's video cache (``frame_load`` is then a cache hit). By
default each engine serves a request by replaying its captured request
graph (``compile.aot_request_program``, on by default); ``--eager`` builds
them with it off, so the request runs op by op. For each:

1. ``--requests`` requests through ``InferenceEngine.infer``, each
   synchronised (host clock): the latencies, their median (p50) and
   captions/s of the sequential loop; on the graph, the seconds of the
   capture and of the run before it;
2. stage times, the median over ``--requests`` requests with a synchronise
   after each stage (host clock): frame load and upload, then eagerly the
   visual branch (ViT, prefix norm, mapper) and each decode group alone,
   or on the graph one replay with the copy of the ids to the host;
3. one whole request under ``torch.profiler`` (CPU and CUDA activity): the
   number of device kernels, their summed device time, the device busy
   share (the union of kernel intervals over the profiled span), the
   device time by kernel name (the 12 largest) and that of every one of the
   port's own kernels, and the launches of each kernel wrapper that those
   show;
4. eagerly, each decode group alone under ``torch.profiler``; on the graph,
   one replay alone: its kernels, device time and busy share.

Prints one JSON object per configuration; with ``--trace-dir`` also writes
a Chrome trace per configuration. Needs an NVIDIA GPU: without one it exits
with an error and measures nothing.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import statistics
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from video_caption_tpu_torch.ops import build

CONFIGS = {
    "default": {},
    "grouped": {"unified_fused_request": False},
    # the unified request runs beam steps only: decode_attention serves the
    # grouped sampled group
    "use_pallas_decode_attention": {"use_pallas_decode_attention": True,
                                    "unified_fused_request": False},
    "use_pallas_decode_layer": {"use_pallas_decode_layer": True},
    "deferred_decode_cache_write": {"deferred_decode_cache_write": True},
}
"""Each configuration's compile switches over the default."""
LAUNCH_KERNELS = {
    "attention_bf16_kernel": "encoder_attention", "attention_f32_kernel": "encoder_attention",
    "prefix_projector_kernel": "prefix_projector", "lm_head_row_stats_kernel": "lm_head",
    "beam_attention_kernel": "beam_attention", "decode_attention_kernel": "decode_attention",
    "decode_layer_kernel": "decode_layer", "fused_pool_kernel": "fused_pool",
    "layer_norm_vec_kernel": "norm_act", "layer_norm_kernel": "norm_act",
    "gelu_kernel": "norm_act",
}
"""Kernels that one counted launch of a wrapper (``ops/<wrapper>.py``)
runs exactly once: lm_head's launch also runs one window kernel for every
256 rows before its row statistics."""


def make_videos(root: Path, count: int, frames: int, size: int, seed: int):
    """JPEG frame directories: a moving gradient plus noise."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    dirs = []
    for v in range(count):
        d = root / f"video_{v}"
        d.mkdir()
        for i in range(frames):
            base = np.stack([(xx + 7 * i + 40 * v) % 256, (yy + 3 * i) % 256,
                             (xx + yy + 11 * v) % 256], axis=-1)
            img = np.clip(base + rng.randint(0, 48, base.shape), 0, 255).astype(np.uint8)
            Image.fromarray(img).save(d / f"frame_{i:05d}.jpg", quality=90)
        dirs.append(str(d))
    return dirs


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1000


def decode_groups(engine) -> dict:
    """{name: the (preset, prompt) pairs of one decode group} of the
    engine's three presets (presets with the same policy decode together)."""
    from video_caption_tpu_torch.decode.presets import preset_to_kwargs

    c = engine.config
    pairs = [(c.preset1, c.prompt1), (c.preset2, c.prompt2), (c.preset3, c.prompt3)]
    groups = defaultdict(list)
    for preset, prompt in pairs:
        groups[json.dumps(preset_to_kwargs(preset), sort_keys=True)].append((preset, prompt))
    return {f"group {m[0][0]} x{len(m)}": m for m in groups.values()}


def stage_times(engine, frames_dir: str, eager: bool) -> dict:
    """ms of each stage of one request, run stage by stage: eagerly the
    visual branch and each decode group, on the graph one replay (with the
    ids' copy to the host)."""
    video, ms = _timed(lambda: engine.load_video(frames_dir))
    out = {"frame_load": ms}
    if eager:
        prefix, out["visual"] = _timed(lambda: engine.compute_prefix(video))
        for name, members in decode_groups(engine).items():
            _, out[name] = _timed(lambda: engine.generate_presets(prefix, members))
    else:
        _, out["graph replay"] = _timed(lambda: engine.request_ids(video))
    out["total"] = sum(out.values())
    return out


def timed_requests(engine, dirs, count: int) -> dict:
    """Latencies (ms, host clock, each request synchronised), p50 and
    captions/s of ``count`` sequential ``engine.infer`` calls."""
    ms = [_timed(lambda: engine.infer(dirs[i % len(dirs)]))[1] for i in range(count)]
    return {"latency_ms": ms, "p50_ms": statistics.median(ms),
            "captions_per_s": 1000.0 / statistics.mean(ms)}


def group_profiles(engine, frames_dir: str) -> dict:
    """Kernels, device ms and busy share of each decode group alone."""
    prefix = engine.compute_prefix(engine.load_video(frames_dir))
    out = {}
    for name, members in decode_groups(engine).items():
        prof = profile_call(lambda: engine.generate_presets(prefix, members))
        out[name] = {k: prof[k] for k in ("kernels", "device_ms", "busy_share", "port_kernels")}
    return out


def device_profile(engine, frames_dir: str, trace: Path = None) -> dict:
    """Kernel count, device time, busy share and time by kernel name of one
    request under torch.profiler."""
    return profile_call(lambda: engine.infer(frames_dir), trace)


def profile_call(fn, trace: Path = None, count: tuple = ()) -> dict:
    """Kernel count, device time, busy share (the union of kernel intervals
    over the profiled span) and time by kernel name of one synchronised
    call of ``fn`` under torch.profiler; ``counted`` gives, for each
    substring in ``count``, the launches and ms of the kernels whose names
    hold it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    starts = [e.time_range.start for e in events]
    ends = [e.time_range.end for e in events]
    wall_us = max(ends) - min(starts)
    by_name = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    if trace is not None:
        prof.export_chrome_trace(str(trace))
    own = [kv for kv in ranked if is_port_kernel(kv[0])]
    wrappers = defaultdict(int)
    for n, (c, _) in own:
        if port_kernel(n) in LAUNCH_KERNELS:
            wrappers[LAUNCH_KERNELS[port_kernel(n)]] += c
    return {"kernels": len(kernels), "device_ms": sum(v[1] for v in by_name.values()) / 1000,
            "busy_ms": busy / 1000, "profiled_wall_ms": wall_us / 1000,
            "busy_share": busy / wall_us if wall_us else 0.0,
            "top": [{"name": n[:90], "launches": c, "ms": t / 1000} for n, (c, t) in ranked[:12]],
            "port_kernels": [{"name": n[:90], "launches": c, "ms": t / 1000} for n, (c, t) in own],
            "wrapper_launches": dict(wrappers),
            "counted": {sub: {"launches": sum(c for n, (c, _) in ranked if sub in n),
                              "ms": sum(t for n, (_, t) in ranked if sub in n) / 1000}
                        for sub in count}}


def port_kernel(name: str):
    """The function name of a profiled kernel of ops/csrc/*.cu
    (``build.KERNELS``, each in an anonymous namespace), or None."""
    prefix = "(anonymous namespace)::"
    rest = name.removeprefix("void ")
    ident = re.match(r"\w+", rest[len(prefix):]) if rest.startswith(prefix) else None
    return ident.group(0) if ident is not None and ident.group(0) in build.KERNELS else None


def is_port_kernel(name: str) -> bool:
    """Whether a profiled kernel is one of ops/csrc/*.cu."""
    return port_kernel(name) is not None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--requests", type=int, default=6)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trace-dir", default=None)
    p.add_argument("--eager", action="store_true",
                   help="serve each request op by op (compile.aot_request_program off)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_request: needs an NVIDIA GPU (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    from video_caption_tpu_torch.config import default_inference_config
    from video_caption_tpu_torch.engine import InferenceEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    trace_dir = Path(args.trace_dir) if args.trace_dir else None
    if trace_dir:
        trace_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        dirs = make_videos(Path(tmp), 3, args.frames + 8, 224, args.seed)
        base = default_inference_config(ckpt=str(Path(tmp) / "absent.pt"),
                                        num_frames=args.frames, image_size=224)
        base = dataclasses.replace(base, compile=dataclasses.replace(
            base.compile, aot_request_program=not args.eager))
        mode = "eager" if args.eager else "graph"
        params = None
        for name in CONFIGS:
            cfg = dataclasses.replace(base, compile=dataclasses.replace(base.compile,
                                                                      **CONFIGS[name]))
            engine = InferenceEngine(cfg, params=params, seed=args.seed, device="cuda")
            params = engine.params
            _, warmup_ms = _timed(engine.warmup)
            requests = timed_requests(engine, dirs, args.requests)
            runs = [stage_times(engine, dirs[i % len(dirs)], args.eager)
                    for i in range(args.requests)]
            stages = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
            prof = device_profile(engine, dirs[0],
                                  trace_dir / f"{name}_{mode}.json" if trace_dir else None)
            out = {"config": name, "mode": mode, "device": torch.cuda.get_device_name(0),
                   "requests": args.requests, "warmup_ms": warmup_ms, **requests,
                   "stage_ms_median": stages, "profile": prof}
            if args.eager:
                out["groups"] = group_profiles(engine, dirs[0])
            else:
                video = engine.load_video(dirs[0])
                graph = engine.request_graph(video)
                out["capture_s"], out["capture_warmup_s"] = graph.capture_s, graph.warmup_s
                replay = profile_call(lambda: graph.replay(video))
                out["replay"] = {k: replay[k] for k in ("kernels", "device_ms", "busy_share",
                                                        "profiled_wall_ms", "wrapper_launches")}
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
