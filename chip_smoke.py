"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--report PATH]

Phases (any failure ends the run with a traceback and a non-zero exit):

1. environment: requires CUDA; prints the torch/CUDA versions and the card's
   name and power limit (nvidia-smi);
2. build: compiles the four hand-written kernels (ops/csrc/*.cu) with nvcc;
3. kernels: each kernel against its plain PyTorch version on the card at the
   main path's shapes (error beside its tolerance, median times);
4. engine: a full-width ViT-B/16 + GPT-2 (124M) engine with seeded random
   bf16 weights, 16 frames of 224x224 JPEGs per request: a warm-up request,
   then timed requests through ``InferenceEngine.infer`` with the core
   presets, with the kernels' launch counts read around them; one request
   with the serving presets; the prefix and the prefill logits against the
   plain path in f32 on the CPU on a 2-frame input;
5. the kernel table as one JSON line, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

With ``--report PATH`` every check, latency and result is also written to
PATH as JSON.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
NUM_FRAMES = 16
IMAGE_SIZE = 224
TIMED_REQUESTS = 6
# bf16 on the card vs f32 on the CPU through 12 ViT layers (or 12 GPT-2
# layers): the deployment bf16-vs-f32 bound, relative to the largest value
REL_TOL = 5e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def make_videos(root: Path, count: int, frames: int, rng: np.random.RandomState):
    """JPEG frame directories: a moving gradient plus noise, so neighbouring
    frames differ the way video frames do."""
    from PIL import Image

    yy, xx = np.mgrid[0:IMAGE_SIZE, 0:IMAGE_SIZE]
    dirs = []
    for v in range(count):
        d = root / f"video_{v}"
        d.mkdir()
        for i in range(frames):
            base = np.stack([(xx + 7 * i + 40 * v) % 256, (yy + 3 * i) % 256,
                             (xx + yy + 11 * v) % 256], axis=-1)
            noise = rng.randint(0, 48, base.shape)
            img = np.clip(base + noise, 0, 255).astype(np.uint8)
            Image.fromarray(img).save(d / f"frame_{i:05d}.jpg", quality=90)
        dirs.append(str(d))
    return dirs


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / want.abs().max())


def main() -> int:
    parser = argparse.ArgumentParser(description="Smoke run of the port on one GPU")
    parser.add_argument("--report", help="write the details as JSON to this path")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from video_caption_tpu_torch.config import default_inference_config, serving_inference_config
    from video_caption_tpu_torch.engine import InferenceEngine
    from video_caption_tpu_torch.models import caption_model as cm
    from video_caption_tpu_torch.ops import build, selfcheck

    report = {}
    # ---- 1. environment
    smi = nvidia_smi()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(f"device: {torch.cuda.get_device_name(0)} ({smi}); count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report["nvidia_smi"] = smi

    # ---- 2. build
    t0 = time.perf_counter()
    build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {build.build_seconds or 0:.1f} s) "
        f"-> {build.library_path()}")
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas {line.strip()}")

    # ---- 3. kernels against their plain versions
    checks = selfcheck.main_path_checks()
    torch.cuda.synchronize()
    report["kernel_checks"] = [c.as_dict() for c in checks]
    for c in checks:
        log(f"kernel {c.name:18s} {c.shape:52s} max_abs_err {c.max_abs_err:.3e} "
            f"(atol {c.atol:g} rtol {c.rtol:g}) {'ok' if c.ok else 'FAIL'} "
            f"kernel {c.ms:.4f} ms plain {c.plain_ms:.4f} ms")
    bad = [c for c in checks if not c.ok]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")

    # ---- 4. engine on the main path
    rng = np.random.RandomState(SEED)
    with tempfile.TemporaryDirectory() as tmp:
        dirs = make_videos(Path(tmp), 3, 24, rng)
        ckpt = str(Path(tmp) / "no-checkpoint.pt")      # absent: seeded random weights
        core_cfg = default_inference_config(ckpt=ckpt, num_frames=NUM_FRAMES,
                                            image_size=IMAGE_SIZE)
        t0 = time.perf_counter()
        engine = InferenceEngine(core_cfg, seed=SEED, device="cuda")
        torch.cuda.synchronize()
        log(f"engine: built in {time.perf_counter() - t0:.2f} s, "
            f"{sum(p.numel() for p in _leaves(engine.params)) / 1e6:.1f} M parameters bf16")
        t0 = time.perf_counter()
        engine.warmup()
        torch.cuda.synchronize()
        log(f"engine: warm-up request {time.perf_counter() - t0:.2f} s")

        modules = {name: spec[3] for name, spec in selfcheck.KERNELS.items()}
        for mod in modules.values():
            mod.launches = 0
        torch.cuda.reset_peak_memory_stats()
        latencies, results = [], []
        for i in range(TIMED_REQUESTS):
            t0 = time.perf_counter()
            res = engine.infer(dirs[i % len(dirs)])
            torch.cuda.synchronize()
            latencies.append(time.perf_counter() - t0)
            results.append(res.to_api_dict())
        launches = {name: mod.launches for name, mod in modules.items()}
        peak = torch.cuda.max_memory_allocated()
        for r in results:
            _check_result(r)
        missing = [n for n, c in launches.items() if c == 0]
        if missing:
            raise AssertionError(f"the main path never launched {missing}: {launches}")
        p50 = statistics.median(latencies)
        log(f"engine core presets: {len(latencies)} requests, latencies "
            f"{[round(x * 1000, 1) for x in latencies]} ms, p50 {p50 * 1000:.1f} ms, "
            f"{1.0 / statistics.mean(latencies):.2f} captions/s (sequential), "
            f"peak device memory {peak / 2**20:.0f} MiB")
        log(f"engine launches during the timed requests: {launches}")
        log(f"engine result: {json.dumps(results[0])}")
        report["engine"] = {"presets": "core", "frames": NUM_FRAMES, "latencies_s": latencies,
                            "p50_s": p50, "captions_per_s": 1.0 / statistics.mean(latencies),
                            "peak_bytes": peak, "launches": launches, "results": results}

        serving = InferenceEngine(serving_inference_config(ckpt=ckpt, num_frames=NUM_FRAMES,
                                                           image_size=IMAGE_SIZE),
                                  params=engine.params, seed=SEED, device="cuda")
        t0 = time.perf_counter()
        served = serving.infer(dirs[0]).to_api_dict()
        torch.cuda.synchronize()
        s_lat = time.perf_counter() - t0
        _check_result(served)
        log(f"engine serving presets (beam-4 x 40): first request {s_lat * 1000:.1f} ms, "
            f"result {json.dumps(served)}")
        report["serving"] = {"latency_s": s_lat, "result": served}

        # ---- correctness against the plain path in f32 on the CPU (2 frames)
        video = engine.load_video(dirs[1])[:, :2]
        cpu_cfg = _f32(engine.model_cfg)
        cpu_params = _f32_cpu(engine.params)
        with torch.inference_mode():
            pre_gpu = engine.compute_prefix(video)
            pre_cpu = cm.video_to_prefix(cpu_params, video.cpu(), cpu_cfg)
            prefix_err = rel_err(pre_gpu, pre_cpu)
            ids = torch.tensor([[32, 65, 32, 109, 97, 110]], device="cuda")
            emb_gpu = cm.build_decoder_inputs(engine.params, pre_gpu, ids, engine.model_cfg)
            emb_cpu = cm.build_decoder_inputs(cpu_params, pre_cpu, ids.cpu(), cpu_cfg)
            logits_gpu = _prefill_logits(engine.params["decoder"], engine.model_cfg.gpt2, emb_gpu)
            logits_cpu = _prefill_logits(cpu_params["decoder"], cpu_cfg.gpt2, emb_cpu)
        v = cpu_cfg.gpt2.vocab_size
        logits_err = rel_err(logits_gpu[:, :v], logits_cpu[:, :v])
        finite = bool(torch.isfinite(pre_gpu).all() and torch.isfinite(logits_gpu[:, :v]).all())
        log(f"reference: prefix {tuple(pre_gpu.shape)} rel err {prefix_err:.3e}, prefill logits "
            f"{tuple(logits_gpu.shape)} rel err {logits_err:.3e} (bound {REL_TOL:g}), finite {finite}")
        report["reference"] = {"prefix_rel_err": prefix_err, "logits_rel_err": logits_err}
        if not (finite and prefix_err < REL_TOL and logits_err < REL_TOL
                and pre_gpu.shape == (1, 4, 768)):
            raise AssertionError("the GPU path disagrees with the f32 plain path")

    # ---- 5. summary
    by_name = {}
    for c in checks:
        entry = by_name.setdefault(c.name, {"name": c.name, "max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], c.max_abs_err)
        if "ms" not in entry:      # the first check of a kernel is its single-request shape
            entry.update(ms=c.ms, plain_ms=c.plain_ms, shape=c.shape)
    kernels = []
    for name, (route, source, replaces, _) in selfcheck.KERNELS.items():
        e = by_name[name]
        kernels.append({"name": name, "route": route, "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": e["max_abs_err"],
                        "ms": e["ms"], "plain_ms": e["plain_ms"]})
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps(report, indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _f32_cpu(tree):
    return {k: _f32_cpu(v) if isinstance(v, dict) else v.float().cpu() for k, v in tree.items()}


def _f32(model_cfg):
    import dataclasses

    return dataclasses.replace(model_cfg, vit=dataclasses.replace(model_cfg.vit, dtype=torch.float32),
                               gpt2=dataclasses.replace(model_cfg.gpt2, dtype=torch.float32))


def _prefill_logits(params, cfg, embeds):
    from video_caption_tpu_torch.models import gpt2 as g2

    b, s, _ = embeds.shape
    cache = g2.init_cache(cfg, b, s, embeds.device)
    valid = torch.ones((b, s), dtype=torch.int32, device=embeds.device)
    pos = torch.arange(s, device=embeds.device)[None].expand(b, s)
    (logits, _, _, _), _ = g2.gpt2_forward(params, embeds, pos, valid, cache, 0, cfg,
                                           wte_t=g2.lm_head_t(params, cfg), last_only=True,
                                           return_stats=True)
    return logits


def _check_result(result: dict) -> None:
    for key in ("S1", "S2", "S3"):
        if not isinstance(result.get(key), str) or not result[key]:
            raise AssertionError(f"result has no caption {key}: {result}")
    if result["BEST"]["key"] not in ("S1", "S2", "S3"):
        raise AssertionError(f"best_key not in S1-S3: {result}")


if __name__ == "__main__":
    sys.exit(main())
