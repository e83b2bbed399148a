"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--report PATH]

Phases (any failure ends the run with a traceback and a non-zero exit):

1. environment: requires CUDA; prints the torch/CUDA versions and the card's
   name and power limit (nvidia-smi);
2. build: compiles the six hand-written kernels (ops/csrc/*.cu), one nvcc
   per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card at the
   main path's shapes (error beside its tolerance, median times of the
   kernel, the plain version and, where there is one, a single PyTorch call
   of the same function, beside the bound);
4. engine: a full-width ViT-B/16 + GPT-2 (124M) engine with seeded random
   bf16 weights, 16 frames of 224x224 JPEGs per request: a warm-up request,
   then timed requests through ``InferenceEngine.infer`` with the core
   presets, with the kernels' launch counts read around them (the default
   configuration launches the four kernels of the default path and neither
   fused-decode kernel); one request with the serving presets;
5. fused decode: one engine with ``compile.use_pallas_decode_attention`` and
   one with ``compile.use_pallas_decode_layer`` (the default engine's
   parameters), each with a warm-up and timed core-preset requests, launch
   counts read around them, and the sampled (``natural``) group timed alone
   beside the default engine's;
6. reference: the prefix and the prefill logits against the plain path in
   f32 on the CPU on a 2-frame input, and for each fused-decode engine the
   logits of 4 K=1 decode steps against the same steps in f32 on the CPU;
7. the kernel table as one JSON line, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

With ``--report PATH`` every check, latency and result is also written to
PATH as JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

SEED = 0
NUM_FRAMES = 16
IMAGE_SIZE = 224
TIMED_REQUESTS = 6
FUSED_REQUESTS = 3
DECODE_STEPS = 4
NATURAL = ("natural", "Write a short, natural caption:")   # the core set's sampled preset
SWITCHES = {"decode_attention": "use_pallas_decode_attention",
            "decode_layer": "use_pallas_decode_layer"}
# bf16 on the card vs f32 on the CPU through 12 ViT layers (or 12 GPT-2
# layers): the deployment bf16-vs-f32 bound, relative to the largest value
REL_TOL = 5e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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
    from video_caption_tpu_torch.cli.profile_request import make_videos
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
        lib = "none" if c.library_ms is None else f"{c.library_ms:.4f} ms"
        atol = f"{c.atol:g}{' x max|plain|' if c.atol_of_max else ''}"
        log(f"kernel {c.name:18s} {c.shape:52s} max_abs_err {c.max_abs_err:.3e} "
            f"(atol {atol} rtol {c.rtol:g}) {'ok' if c.ok else 'FAIL'} "
            f"kernel {c.ms:.4f} ms plain {c.plain_ms:.4f} ms library {lib} "
            f"bound {c.bound_ms:.4f} ms ({c.bound_by})")
    bad = [c for c in checks if not c.ok]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")

    # ---- 4. engine on the main path
    with tempfile.TemporaryDirectory() as tmp:
        dirs = make_videos(Path(tmp), 3, 24, IMAGE_SIZE, SEED)
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

        torch.cuda.reset_peak_memory_stats()
        latencies, results, launches = _timed_requests(engine, dirs, TIMED_REQUESTS)
        peak = torch.cuda.max_memory_allocated()
        for r in results:
            _check_result(r)
        _require_launches(launches, selfcheck.DEFAULT_PATH, "the default main path")
        if any(launches[n] for n in SWITCHES):
            raise AssertionError(f"the default configuration launched a fused-decode kernel: "
                                 f"{launches}")
        p50 = statistics.median(latencies)
        log(f"engine core presets: {len(latencies)} requests, latencies "
            f"{[round(x * 1000, 1) for x in latencies]} ms, p50 {p50 * 1000:.1f} ms, "
            f"{1.0 / statistics.mean(latencies):.2f} captions/s (sequential), "
            f"peak device memory {peak / 2**20:.0f} MiB")
        log(f"engine launches during the timed requests: {launches}")
        log(f"engine result: {json.dumps(results[0])}")
        report["engine"] = {"presets": "core", "frames": NUM_FRAMES, "latencies_s": latencies,
                            "p50_s": p50, "captions_per_s": 1.0 / statistics.mean(latencies),
                            "peak_bytes": peak, "launches": dict(launches), "results": results}

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

        # ---- 5. the fused K=1 decode configurations
        natural_ms = {"default": _natural_group_ms(engine, dirs[0])}
        log(f"engine default: natural group alone {natural_ms['default']:.1f} ms (median of 3)")
        fused = {}
        for kernel, switch in SWITCHES.items():
            cfg = dataclasses.replace(core_cfg, compile=dataclasses.replace(
                core_cfg.compile, **{switch: True}))
            eng = InferenceEngine(cfg, params=engine.params, seed=SEED, device="cuda")
            eng.warmup()
            torch.cuda.synchronize()
            lat, res, counts = _timed_requests(eng, dirs, FUSED_REQUESTS)
            for r in res:
                _check_result(r)
            _require_launches(counts, selfcheck.DEFAULT_PATH + (kernel,), f"the {switch} path")
            launches[kernel] = counts[kernel]     # the fused kernel's count is its path's
            natural_ms[kernel] = _natural_group_ms(eng, dirs[0])
            fused[kernel] = eng
            log(f"engine {switch}=True: {len(lat)} requests, latencies "
                f"{[round(x * 1000, 1) for x in lat]} ms, p50 {statistics.median(lat) * 1000:.1f} ms "
                f"(default {p50 * 1000:.1f} ms); natural group alone {natural_ms[kernel]:.1f} ms "
                f"(default {natural_ms['default']:.1f} ms); {kernel} launches "
                f"{counts[kernel]} ({counts[kernel] / len(lat):g} per request); all {counts}")
            log(f"engine {switch}=True result: {json.dumps(res[0])}")
            report[f"engine_{kernel}"] = {"latencies_s": lat, "p50_s": statistics.median(lat),
                                          "natural_group_ms": natural_ms[kernel],
                                          "launches": counts, "results": res}
        report["natural_group_ms"] = natural_ms

        # ---- 6. correctness against the plain path in f32 on the CPU (2 frames)
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
        for kernel, eng in fused.items():
            with torch.inference_mode():
                steps_gpu = _decode_logits(eng.params["decoder"], eng.model_cfg.gpt2, emb_gpu)
                steps_cpu = _decode_logits(cpu_params["decoder"], _f32(eng.model_cfg).gpt2,
                                           emb_cpu)
            err = rel_err(steps_gpu[..., :v], steps_cpu[..., :v])
            finite = bool(torch.isfinite(steps_gpu[..., :v]).all())
            log(f"reference {SWITCHES[kernel]}: {DECODE_STEPS} K=1 decode steps, logits "
                f"{tuple(steps_gpu.shape)} rel err {err:.3e} (bound {REL_TOL:g}), finite {finite}")
            report["reference"][f"{kernel}_steps_rel_err"] = err
            if not (finite and err < REL_TOL):
                raise AssertionError(f"the {SWITCHES[kernel]} decode steps disagree with the "
                                     "f32 plain path")

    # ---- 7. summary: launches of each kernel's path (the default engine's
    # requests; the fused-decode kernels', their engines' requests); times
    # and bound of the first check of each kernel, its single-request shape
    by_name = {}
    for c in checks:
        entry = by_name.setdefault(c.name, {"max_abs_err": 0.0, "first": c})
        entry["max_abs_err"] = max(entry["max_abs_err"], c.max_abs_err)
    kernels = []
    for name, (route, source, replaces, _) in selfcheck.KERNELS.items():
        first = by_name[name]["first"]
        kernels.append({"name": name, "route": route, "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": by_name[name]["max_abs_err"],
                        "ms": first.ms, "plain_ms": first.plain_ms, "bound_ms": first.bound_ms,
                        "bound_by": first.bound_by, "library_ms": first.library_ms,
                        "shape": first.shape})
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps(report, indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def _timed_requests(engine, dirs, count):
    """(latencies s, results, launches of every kernel) of ``count``
    sequential requests; the counts are set to 0 just before and read just
    after."""
    from video_caption_tpu_torch.ops import selfcheck

    modules = {name: spec[3] for name, spec in selfcheck.KERNELS.items()}
    for mod in modules.values():
        mod.launches = 0
    latencies, results = [], []
    for i in range(count):
        t0 = time.perf_counter()
        res = engine.infer(dirs[i % len(dirs)])
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        results.append(res.to_api_dict())
    return latencies, results, {name: mod.launches for name, mod in modules.items()}


def _require_launches(launches, names, path):
    missing = [n for n in names if launches[n] == 0]
    if missing:
        raise AssertionError(f"{path} never launched {missing}: {launches}")


def _natural_group_ms(engine, frames_dir, runs=3):
    """Median ms of the sampled group alone (``generate_presets`` with the
    natural preset only, synchronised), on one video's prefix."""
    prefix = engine.compute_prefix(engine.load_video(frames_dir))
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.generate_presets(prefix, [NATURAL])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000)
    return statistics.median(times)


def _decode_logits(params, cfg, embeds):
    """Logits [DECODE_STEPS, B, Vp] of K=1 decode steps after a prefill of
    ``embeds``, feeding fixed tokens, through gpt2_forward with ``cfg``'s
    decode configuration."""
    from video_caption_tpu_torch.models import gpt2 as g2

    b, s0, _ = embeds.shape
    dev = embeds.device
    if cfg.use_pallas_decode_layer:
        params = g2.prepare_decode_params(params, cfg)
    wte_t = g2.lm_head_t(params, cfg)
    cache = g2.init_cache(cfg, b, s0 + DECODE_STEPS, dev)
    valid = torch.zeros((b, s0 + DECODE_STEPS), dtype=torch.int32, device=dev)
    valid[:, :s0] = 1
    pos = torch.arange(s0, device=dev)[None].expand(b, s0)
    _, cache = g2.gpt2_forward(params, embeds, pos, valid, cache, 0, cfg, wte_t=wte_t,
                               last_only=True, return_stats=True, row_stats=False)
    out = []
    for t, token in enumerate((32, 97, 32, 109)[:DECODE_STEPS]):
        valid[:, s0 + t] = 1
        ids = torch.full((b,), token, device=dev)
        (logits, _, _, _), cache = g2.gpt2_forward(
            params, params["wte"][ids][:, None], torch.full((b, 1), s0 + t, device=dev), valid,
            cache, s0 + t, cfg, wte_t=wte_t, return_stats=True, row_stats=False)
        out.append(logits)
    return torch.stack(out)


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
