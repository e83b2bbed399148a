"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--report PATH]

Phases (any failure ends the run with a traceback and a non-zero exit):

1. environment: requires CUDA; prints the torch/CUDA versions and the card's
   name and power limit (nvidia-smi);
2. build: compiles the seven hand-written kernels (ops/csrc/*.cu), one nvcc
   per source, all started together; prints nvcc's register and spill
   report of every kernel and the counts of tensor-core instructions (HMMA,
   HGMMA), 16-byte global loads, generic loads (fused_pool's reads of a
   cluster peer's shared memory), cluster barriers and cp.async copies
   (LDGSTS) in its SASS (cuobjdump);
3. kernels: each kernel against its plain PyTorch version on the card at the
   main path's and the trainers' shapes (error beside its tolerance, median
   device times of the kernel, the plain version and, where there is one, a
   single PyTorch call of the same function, beside the bound); then the input
   gradients of the three differentiable kernels (kernel forward,
   closed-form backward) against autograd through their plain versions;
4. engine: a full-width ViT-B/16 + GPT-2 (124M) engine with seeded random
   bf16 weights, 16 frames of 224x224 JPEGs per request, serving each
   request as the default configuration does: one replay of the request
   program captured into a CUDA graph (``aot.RequestGraph``), which
   decodes the three presets in one unified beam-step loop
   (``compile.unified_fused_request``). Beside it its eager twin
   (``compile.aot_request_program`` off: group by group, op by op; the same
   seed and parameters). Each takes a warm-up request (the graph's
   capture) and then the same timed requests through
   ``InferenceEngine.infer`` with the core presets; the token ids of one
   more request must be identical (the graph's replay against the same
   program run op by op), and so must the results where both decode group
   by group (else the share of identical captions is printed). One replay
   runs under torch.profiler: its count of the port's kernels must equal
   the wrappers' counters' delta. The kernels' launch counts are read
   around the graph's requests: 24 lm_head and 276 beam_attention launches
   a request and neither fused-decode kernel. Then the same pair with
   ``unified_fused_request`` off (48 lm_head launches a request): kernels,
   device ms, replay ms, p50 and captions/s of both programs side by side;
   one request with the serving presets (its first: the capture included);
5. decode configurations, each as in 4 (graph beside its eager twin): one
   engine with ``compile.use_pallas_decode_attention`` (and
   ``unified_fused_request`` off: the unified loop runs beam steps only and
   never reaches that kernel) and one with ``compile.use_pallas_decode_layer``
   (the default engine's parameters), launch counts read around the
   graph's requests, and the sampled (``natural``) group timed alone,
   eagerly, beside the default engine's; then one with
   ``compile.deferred_decode_cache_write``, which must launch
   beam_attention (in its deferred mode) as often per request as the
   default engine and neither fused-decode kernel;
6. reference: the prefix and the prefill logits against the plain path in
   f32 on the CPU on a 2-frame input; for each fused-decode engine and the
   deferred engine the logits of 4 K=1 decode steps, and for the default and
   the deferred engine the logits of 4 beam-3 steps (a fixed ancestry with
   reordered beams), against the same steps in f32 on the CPU; the logits
   of 4 steps of the unified layout (9 rows) against the grouped programs'
   (6 beam rows, one K=1 row) on the card;
7. batches: ``infer_batch`` of 1, 2, 4 and 8 videos on the graph (one graph
   per batch size, captured on first use) beside an eager twin: ms a batch,
   captions/s, capture s, and the ids of one more batch identical;
8. mapper trainer: ``cli/train_caption_mapper.main`` on a synthetic
   annotations file over the same JPEG directories, full-width ViT-B/16 +
   GPT-2 with seeded random weights, bf16 compute, 4 videos x 8 frames, 5
   steps (each synchronised and timed), then a validation pass and a
   best-val checkpoint; the losses must be finite, the mapper must move and
   every other weight stay bit-equal (their rate is 0), and the step must
   launch encoder_attention (frozen forward) and prefix_projector;
9. joint step: ``training/loop.run_training`` with the stage-1 alignment
   loss of ``cli/train_full.py --model vit`` and ``adamw(1e-4)``, the ViT
   with ``pool="gap"``, f32 and remat, 4 videos x 8 frames, 5 steps; the step
   must launch fused_pool once and encoder_attention twice per layer
   (forward and remat recompute); then the loss and global gradient norm of
   one step at 1 video x 2 frames on the card against the same step in f32
   on the CPU (plain versions);
10. server: the port's stdlib HTTP server on 127.0.0.1:0, the registry
   building the serving-preset engine (absent checkpoint: seeded random
   weights), 16 concurrent clients POST /infer, twice: every answer 200 and
   well formed, at least one batch of more than one formed by the queue and
   no request retried alone; batch sizes, client p50/p99, captions/s;
11. bench: the port's measurement stack (``bench/``) over the default
   engine's parameters: ``StageBench`` at batch 1 (2 warm-ups, 5
   iterations, the four report files in a temporary directory; stage
   means); ``measure_roofline`` of the default engine at batch 1 and 8 and
   of one with ``compile.unified_decode`` at batch 1 (device ms, GFLOP,
   GB and the shares of the H100's peaks per stage; a share over 100%
   fails); the driver (``bench/driver.py``, batch 8, depth 2), which prints
   its JSON line; one ``serving_load.run_load`` at 8 QPS for 10 s (no
   error allowed); the accuracy gate (``check_alignment`` at 224x224:
   72 videos x 4 beams on the card against f32 on the CPU, ``all_ok``
   required). The kernel counts are read around the phase: the default
   path's four kernels must launch;
12. the kernel table as one JSON line (launches of each kernel's path: the
   default engine's requests, each fused-decode engine's, the joint steps'
   for fused_pool), the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

With ``--report PATH`` every check, latency and result is also written to
PATH as JSON.
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import math
import statistics
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
DEFERRED = "deferred_decode_cache_write"
GROUPED = "unified_fused_request"          # off: the request decodes group by group
# launches a request of the default engine (core presets, one unified loop:
# a prefill and 23 beam steps of 12 layers) and of the grouped program
UNIFIED_LAUNCHES = {"lm_head": 24, "beam_attention": 276}
GROUPED_LAUNCHES = {"lm_head": 48, "beam_attention": 276}
BUCKETS = (1, 2, 4, 8)
BENCH_WARMUP, BENCH_ITERS = 2, 5
ROOFLINE_BATCHES = (1, 8)
LOAD_QPS, LOAD_SECONDS = 8.0, 10.0
BATCH_REPEATS = 3
SERVER_CLIENTS = 16
BEAMS = 3
# bf16 on the card vs f32 on the CPU through 12 ViT layers (or 12 GPT-2
# layers): the deployment bf16-vs-f32 bound, relative to the largest value
REL_TOL = 5e-2
TRAIN_BATCH, TRAIN_FRAMES, TRAIN_STEPS = 4, 8, 5
# f32 on the card (kernels) vs f32 on the CPU (plain versions): one step's
# loss and global gradient norm through 12 ViT layers and back
TRAIN_REL_TOL = 1e-3
CAPTIONS = ("a man is riding a horse", "a woman is slicing a tomato",
            "two dogs are playing in the snow", "a child is playing the guitar",
            "a cat is sleeping on a sofa", "a car is driving down the road",
            "people are dancing on a stage", "a man is cooking in a kitchen")


def log(msg: str) -> None:
    print(msg, flush=True)


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
    from video_caption_tpu_torch.env import nvidia_smi
    from video_caption_tpu_torch.models import caption_model as cm
    from video_caption_tpu_torch.ops import build, selfcheck

    report = {}
    # ---- 1. environment
    smi = nvidia_smi()
    if smi is None:
        raise RuntimeError("nvidia-smi is not on PATH: the card's name and power limit are unknown")
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
    report["sass_instructions"] = build.count_instructions(build.sass(), build.SASS_PATTERNS)
    for fn, counts in report["sass_instructions"].items():
        log(f"  sass {fn}: " + ", ".join(f"{n} {name}" for name, n in counts.items()))

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
    backward = selfcheck.backward_checks()
    report["backward_checks"] = [c.as_dict() for c in backward]
    for c in backward:
        lib = "none" if c.library_ms is None else f"{c.library_ms:.4f} ms"
        log(f"backward {c.name:18s} {c.shape:36s} max_abs_err {c.max_abs_err:.3e} of max "
            f"{c.max_abs_grad:.3e} (tol {c.rel_tol:g} x max) {'ok' if c.ok else 'FAIL'} "
            f"fwd+bwd {c.ms:.4f} ms plain fwd+bwd {c.plain_ms:.4f} ms bwd alone "
            f"{c.bwd_ms:.4f} ms library fwd+bwd {lib}")
    bad = [c for c in backward if not c.ok]
    if bad:
        raise AssertionError(f"backward passes disagree with autograd of the plain versions: "
                             f"{bad}")

    # ---- 4. engine on the main path
    with tempfile.TemporaryDirectory() as tmp:
        all_dirs = make_videos(Path(tmp), max(BUCKETS), 24, IMAGE_SIZE, SEED)
        dirs = all_dirs[:3]
        ckpt = str(Path(tmp) / "no-checkpoint.pt")      # absent: seeded random weights
        core_cfg = default_inference_config(ckpt=ckpt, num_frames=NUM_FRAMES,
                                            image_size=IMAGE_SIZE)
        t0 = time.perf_counter()
        engine = InferenceEngine(core_cfg, seed=SEED, device="cuda")
        torch.cuda.synchronize()
        log(f"engine: built in {time.perf_counter() - t0:.2f} s, "
            f"{sum(p.numel() for p in _leaves(engine.params)) / 1e6:.1f} M parameters bf16")
        pair = _graph_and_eager("default", engine, dirs, TIMED_REQUESTS)
        launches = dict(pair["graph"]["launches"])
        _require_launches(launches, selfcheck.DEFAULT_PATH, "the default main path")
        if any(launches[n] for n in SWITCHES):
            raise AssertionError(f"the default configuration launched a fused-decode kernel: "
                                 f"{launches}")
        _require_per_request(launches, UNIFIED_LAUNCHES, TIMED_REQUESTS, "the unified request")
        latencies = pair["graph"]["latencies_s"]
        log(f"engine result: {json.dumps(pair['graph']['results'][0])}")
        report["engine"] = {"presets": "core", "frames": NUM_FRAMES, **pair}

        # the same engine with the unified decode off: the grouped request
        cfg = dataclasses.replace(core_cfg, compile=dataclasses.replace(
            core_cfg.compile, **{GROUPED: False}))
        grouped = InferenceEngine(cfg, params=engine.params, seed=SEED, device="cuda")
        gpair = _graph_and_eager(f"{GROUPED}=False", grouped, dirs, TIMED_REQUESTS)
        _require_per_request(gpair["graph"]["launches"], GROUPED_LAUNCHES, TIMED_REQUESTS,
                             "the grouped request")
        u, g = pair["graph"], gpair["graph"]
        same = _identical_share(u["results"], g["results"])
        # both engines have served the same calls, so their generators
        # stand at the same offset: one more request's ids, row by row
        video = engine.load_video(dirs[2])
        rows = [(a == b).all(axis=1) for a, b in zip(engine.request_ids(video),
                                                     grouped.request_ids(video))]
        same_rows = float(sum(r.sum() for r in rows)) / sum(r.size for r in rows)
        by_group = ", ".join(f"{dp.num_beams}-beam {int(r.sum())}/{r.size}" if dp.num_beams > 1
                             else f"sampled {int(r.sum())}/{r.size}"
                             for (dp, *_), r in zip(engine._decode_groups(), rows))
        log(f"unified vs grouped request (graph, one call): kernels {u['replay_kernels']} vs "
            f"{g['replay_kernels']}, device {u['replay_device_ms']:.2f} vs "
            f"{g['replay_device_ms']:.2f} ms, replay {u['replay_ms']:.2f} vs "
            f"{g['replay_ms']:.2f} ms, p50 {u['p50_s'] * 1000:.1f} vs {g['p50_s'] * 1000:.1f} ms, "
            f"{u['captions_per_s']:.2f} vs {g['captions_per_s']:.2f} captions/s; captions "
            f"identical {same:.1%}, id rows identical {same_rows:.1%} ({by_group})")
        report["engine_grouped"] = {**gpair, "identical_captions_vs_unified": same,
                                    "identical_id_rows_vs_unified": same_rows}

        serving = InferenceEngine(serving_inference_config(ckpt=ckpt, num_frames=NUM_FRAMES,
                                                           image_size=IMAGE_SIZE),
                                  params=engine.params, seed=SEED, device="cuda")
        t0 = time.perf_counter()
        served = serving.infer(dirs[0]).to_api_dict()
        torch.cuda.synchronize()
        s_lat = time.perf_counter() - t0
        _check_result(served)
        s_capture = serving.request_graph(serving.load_video(dirs[0])).capture_s
        log(f"engine serving presets (beam-4 x 40): first request {s_lat * 1000:.1f} ms "
            f"(the graph's capture {s_capture:.2f} s of it), result {json.dumps(served)}")
        report["serving"] = {"latency_s": s_lat, "capture_s": s_capture, "result": served}

        # ---- 5. the fused K=1 decode configurations and the deferred cache write
        natural_ms = {"default": _natural_group_ms(engine, dirs[0])}
        log(f"engine default: natural group alone {natural_ms['default']:.1f} ms (median of 3)")
        fused = {}
        for kernel, switch in SWITCHES.items():
            # decode_attention serves the K=1 steps of the grouped sampled
            # group; the unified loop runs every group through beam steps,
            # so its engine decodes group by group (decode_layer's engine
            # does anyway: the unified loop does not take its flat cache)
            off = {GROUPED: False} if kernel == "decode_attention" else {}
            cfg = dataclasses.replace(core_cfg, compile=dataclasses.replace(
                core_cfg.compile, **{switch: True}, **off))
            if off:
                log(f"engine {switch}=True with {GROUPED}=False: the unified request never "
                    f"reaches {kernel} (beam steps only)")
            eng = InferenceEngine(cfg, params=engine.params, seed=SEED, device="cuda")
            pair = _graph_and_eager(switch, eng, dirs, FUSED_REQUESTS)
            counts = pair["graph"]["launches"]
            _require_launches(counts, selfcheck.DEFAULT_PATH + (kernel,), f"the {switch} path")
            launches[kernel] = counts[kernel]     # the fused kernel's count is its path's
            natural_ms[kernel] = _natural_group_ms(eng, dirs[0])
            fused[kernel] = eng
            log(f"engine {switch}=True: natural group alone {natural_ms[kernel]:.1f} ms "
                f"(default {natural_ms['default']:.1f} ms); {kernel} launches {counts[kernel]} "
                f"({counts[kernel] / FUSED_REQUESTS:g} per request)")
            report[f"engine_{kernel}"] = {"natural_group_ms": natural_ms[kernel], **pair}
        report["natural_group_ms"] = natural_ms

        cfg = dataclasses.replace(core_cfg, compile=dataclasses.replace(
            core_cfg.compile, **{DEFERRED: True}))
        deferred = InferenceEngine(cfg, params=engine.params, seed=SEED, device="cuda")
        pair = _graph_and_eager(DEFERRED, deferred, dirs, FUSED_REQUESTS)
        counts = pair["graph"]["launches"]
        _require_launches(counts, selfcheck.DEFAULT_PATH, f"the {DEFERRED} path")
        per_request = counts["beam_attention"] / FUSED_REQUESTS
        default_per_request = launches["beam_attention"] / len(latencies)
        log(f"engine {DEFERRED}=True: beam_attention launches {per_request:g} per request "
            f"(default {default_per_request:g})")
        if per_request != default_per_request or any(counts[n] for n in SWITCHES):
            raise AssertionError(f"the {DEFERRED} path must launch beam_attention as the default "
                                 f"path does and no fused-decode kernel: {counts}")
        report["engine_deferred"] = pair

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
        steps = [(SWITCHES[k], e, _decode_logits, "K=1 decode") for k, e in fused.items()]
        steps += [(DEFERRED, deferred, _decode_logits, "K=1 decode"),
                  ("default", engine, _beam_decode_logits, f"beam-{BEAMS}"),
                  (DEFERRED, deferred, _beam_decode_logits, f"beam-{BEAMS}")]
        for name, eng, run, kind in steps:
            with torch.inference_mode():
                steps_gpu = run(eng.params["decoder"], eng.model_cfg.gpt2, emb_gpu)
                steps_cpu = run(cpu_params["decoder"], _f32(eng.model_cfg).gpt2, emb_cpu)
            err = rel_err(steps_gpu[..., :v], steps_cpu[..., :v])
            finite = bool(torch.isfinite(steps_gpu[..., :v]).all())
            log(f"reference {name}: {DECODE_STEPS} {kind} steps, logits "
                f"{tuple(steps_gpu.shape)} rel err {err:.3e} (bound {REL_TOL:g}), finite {finite}")
            report["reference"][f"{name} {kind} steps_rel_err"] = err
            if not (finite and err < REL_TOL):
                raise AssertionError(f"the {name} {kind} steps disagree with the f32 plain path")
        report["reference"]["unified_vs_grouped"] = _unified_vs_grouped(engine, pre_gpu, v)

        # ---- infer_batch at every bucket, graph beside eager
        report["batches"] = _batch_phase(engine, all_dirs)

        # ---- 7. and 8. the two trainers
        ann = Path(tmp) / "annotations.json"
        ann.write_text(json.dumps([
            {"video_id": f"video{v}", "frames_dir": d,
             "captions": [CAPTIONS[(v + i) % len(CAPTIONS)] for i in range(len(CAPTIONS))]}
            for v, d in enumerate(dirs)]))
        report["mapper_trainer"] = _mapper_trainer_phase(Path(tmp), ann)
        report["joint_step"] = _joint_step_phase(Path(tmp), ann)
        launches["fused_pool"] = report["joint_step"]["launches"]["fused_pool"]

        # ---- the HTTP server with its batch queue
        report["server"] = _server_phase(all_dirs, ckpt)

        # ---- the measurement stack
        report["bench"] = _bench_phase(engine, all_dirs, Path(tmp))

    # ---- 9. summary: launches of each kernel's path (the default engine's
    # requests; the fused-decode kernels', their engines' requests;
    # fused_pool's, the joint steps'); times and bound of the first check of
    # each kernel, its single-request (fused_pool: joint-step) shape
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


def _graph_and_eager(label, engine, dirs, count):
    """Phases 4 and 5 for one configuration: ``engine`` on the request
    graph (its configuration's default) and its eager twin (the same
    configuration with ``aot_request_program`` off, the same seed and
    parameters: it serves a request group by group, ``generate_presets``),
    each warmed up, serving the same ``count`` requests; then the ids of
    one more request on each (the eager engine runs the same request
    program op by op), the host-clock time of 5 replays with the ids' copy
    back, and one replay under torch.profiler. Fails unless the ids are
    identical, the results too where the request program decodes group by
    group as the eager path does (else their share of identical captions
    is printed: a unified loop runs other row counts, and bf16 products on
    random weights may then pick another token), and the profiler's count
    of the port's kernels in the replay equals the wrappers' counters'
    delta. The graph's ``launches`` are its timed requests'."""
    from video_caption_tpu_torch.cli.profile_request import profile_call
    from video_caption_tpu_torch.engine import InferenceEngine

    cfg = engine.config
    eager = InferenceEngine(dataclasses.replace(cfg, compile=dataclasses.replace(
        cfg.compile, aot_request_program=False)), params=engine.params, seed=SEED, device="cuda")
    out = {}
    for mode, eng in (("graph", engine), ("eager", eager)):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng.warmup()
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0
        lat, res, counts = _timed_requests(eng, dirs, count)
        for r in res:
            _check_result(r)
        out[mode] = {"warmup_s": warmup_s, "latencies_s": lat, "p50_s": statistics.median(lat),
                     "captions_per_s": 1.0 / statistics.mean(lat),
                     "peak_added_bytes": torch.cuda.max_memory_allocated() - before,
                     "launches": counts, "results": res}
    _, groups = engine._fused_infer_program()
    unified = engine._unified_eligible(groups, fused_program=True)
    same = _identical_share(out["graph"]["results"], out["eager"]["results"])
    if not unified and same != 1.0:
        raise AssertionError(f"{label}: the graph's results differ from the eager path's: "
                             f"{out['graph']['results']} vs {out['eager']['results']}")
    video = engine.load_video(dirs[0])
    ids = [engine.request_ids(video), eager.request_ids(video)]
    same_ids = all(a.shape == b.shape and (a == b).all() for a, b in zip(*ids))
    if not same_ids:
        raise AssertionError(f"{label}: the graph's ids differ from the program's run op by op: "
                             f"{ids}")
    graph = engine.request_graph(video)
    replays = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.request_ids(video)
        replays.append((time.perf_counter() - t0) * 1000)
    before = _kernel_counts()
    prof = profile_call(lambda: graph.replay(video))
    delta = {n: c - before[n] for n, c in _kernel_counts().items() if c != before[n]}
    if prof["wrapper_launches"] != delta:
        raise AssertionError(f"{label}: the profiler saw {prof['wrapper_launches']} launches in "
                             f"one replay, the counters {delta}")
    out["graph"].update(capture_s=graph.capture_s, capture_warmup_s=graph.warmup_s,
                        replay_ms=statistics.median(replays), replay_kernels=prof["kernels"],
                        replay_device_ms=prof["device_ms"], replay_busy_share=prof["busy_share"],
                        replay_launches=delta)
    g, e = out["graph"], out["eager"]
    log(f"engine {label}: graph {count} requests {[round(x * 1000, 1) for x in g['latencies_s']]} "
        f"ms, p50 {g['p50_s'] * 1000:.1f} ms, {g['captions_per_s']:.2f} captions/s, capture "
        f"{graph.capture_s:.2f} s (after a {graph.warmup_s:.2f} s run), peak "
        f"+{g['peak_added_bytes'] / 2**20:.0f} MiB; eager "
        f"{[round(x * 1000, 1) for x in e['latencies_s']]} ms, p50 {e['p50_s'] * 1000:.1f} ms, "
        f"{e['captions_per_s']:.2f} captions/s, peak +{e['peak_added_bytes'] / 2**20:.0f} MiB")
    log(f"engine {label}: request program {'unified' if unified else 'grouped'}, eager "
        f"grouped; captions identical {same:.1%} over {count} requests, ids identical "
        f"({[a.shape for a in ids[0]]}); replay with the ids' copy {g['replay_ms']:.2f} ms "
        f"(median of 5); one replay: {prof['kernels']} kernels, {prof['device_ms']:.2f} ms "
        f"device, busy {prof['busy_share']:.1%}, the port's kernels "
        f"{prof['wrapper_launches']} = counters' delta; launches over the graph's requests "
        f"{g['launches']}")
    return {**out, "ids_identical": same_ids, "unified": unified, "identical_captions": same}


def _identical_share(a, b) -> float:
    """Share of the captions (S1-S3 of each result) two result lists agree on."""
    pairs = [(x[k], y[k]) for x, y in zip(a, b) for k in ("S1", "S2", "S3")]
    return sum(p == q for p, q in pairs) / len(pairs)


def _require_per_request(launches, want, requests, path):
    got = {name: launches[name] / requests for name in want}
    if got != want:
        raise AssertionError(f"{path} launched {got} per request, not {want}")


def _timed_requests(engine, dirs, count):
    """(latencies s, results, launches of every kernel) of ``count``
    sequential requests; the counts are set to 0 just before and read just
    after."""
    _reset_kernel_counts()
    latencies, results = [], []
    for i in range(count):
        t0 = time.perf_counter()
        res = engine.infer(dirs[i % len(dirs)])
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        results.append(res.to_api_dict())
    return latencies, results, _kernel_counts()


def _kernel_counts():
    from video_caption_tpu_torch.ops import selfcheck

    return {name: spec[3].launches for name, spec in selfcheck.KERNELS.items()}


def _reset_kernel_counts():
    from video_caption_tpu_torch.ops import selfcheck

    for spec in selfcheck.KERNELS.values():
        spec[3].launches = 0


class _StepTimer:
    """Wraps a step function: synchronises after each call and keeps its end
    time and the kernels' counts there."""

    def __init__(self, fn):
        self.fn, self.ends, self.counts = fn, [], []

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        torch.cuda.synchronize()
        self.ends.append(time.perf_counter())
        self.counts.append(_kernel_counts())
        return out

    def summary(self, batch):
        """Median ms of steps 2.. (end to end, the next batch's wait
        included), samples/s, and launches per step over those steps."""
        gaps = [(b - a) * 1000 for a, b in zip(self.ends, self.ends[1:])]
        ms = statistics.median(gaps)
        n = len(gaps)
        per_step = {k: (self.counts[-1][k] - self.counts[0][k]) / n for k in self.counts[0]}
        return {"step_ms": gaps, "median_step_ms": ms, "samples_per_s": batch * 1000 / ms,
                "launches_per_step": per_step}


def _losses(events: Path):
    with events.open() as fh:
        return [float(r["loss"]) for r in csv.DictReader(fh)]


def _mapper_trainer_phase(root: Path, ann: Path) -> dict:
    """Phase 7: the mapper trainer through its CLI."""
    from video_caption_tpu_torch.cli import train_caption_mapper
    from video_caption_tpu_torch.config import default_inference_config
    from video_caption_tpu_torch.engine import load_params, model_config_from_inference
    from video_caption_tpu_torch.ops import selfcheck
    from video_caption_tpu_torch.training import mapper_trainer as mt
    from video_caption_tpu_torch.training.optim import leaves

    run_step = mt.MapperTrainer.run_step
    timer, trainers = _StepTimer(run_step), []

    def timed_step(self, batch, sync=True):
        trainers[:] = [self]
        return timer(self, batch, sync)

    out_dir, ckpt = root / "mapper_run", root / "mapper_ckpt"
    _reset_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mt.MapperTrainer.run_step = timed_step
    try:
        rc = train_caption_mapper.main([
            "--ann_path", str(ann), "--val_ann_path", str(ann),
            "--batch_size", str(TRAIN_BATCH), "--num_frame", str(TRAIN_FRAMES),
            "--image_size", str(IMAGE_SIZE), "--max_len", "32",
            "--max_steps", str(TRAIN_STEPS), "--out_dir", str(out_dir),
            "--ckpt_path", str(ckpt), "--device", "cuda"])
    finally:
        mt.MapperTrainer.run_step = run_step
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = _kernel_counts()
    losses = _losses(out_dir / "events.csv")
    stats = timer.summary(TRAIN_BATCH)
    # the same seeded init the CLI started from: the mapper moved, every
    # other leaf (rate 0) is bit-equal
    inf_cfg = default_inference_config(num_frames=TRAIN_FRAMES, image_size=IMAGE_SIZE)
    start = dict(leaves(load_params(inf_cfg, model_config_from_inference(inf_cfg), seed=0,
                                    device="cuda")))
    moved = [p for p, t in leaves(trainers[0].params) if not torch.equal(t, start[p])]
    log(f"mapper trainer: rc {rc}, {len(losses)} steps in {wall:.1f} s (CLI, data, validation and "
        f"checkpoint included); steps 2-{TRAIN_STEPS} "
        f"{[round(x, 1) for x in stats['step_ms']]} ms, median {stats['median_step_ms']:.1f} ms/step, "
        f"{stats['samples_per_s']:.2f} samples/s; peak device memory {peak / 2**20:.0f} MiB")
    log(f"mapper trainer: losses {losses}; leaves moved {moved}; launches {launches}, per step "
        f"{stats['launches_per_step']}; checkpoint {(ckpt / 'model.pt').is_file()}")
    _require_launches(launches, selfcheck.MAPPER_TRAINING_PATH, "the mapper trainer")
    if not (rc == 0 and len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses))):
        raise AssertionError(f"the mapper trainer did not take {TRAIN_STEPS} finite steps")
    if sorted(moved) != ["/mapper/b", "/mapper/w"]:
        raise AssertionError(f"the mapper trainer must move the mapper and nothing else: {moved}")
    if not (ckpt / "model.pt").is_file():
        raise AssertionError("the mapper trainer wrote no best-val checkpoint")
    return {"losses": losses, "wall_s": wall, "peak_bytes": peak, "launches": launches,
            "moved": moved, **stats}


def _joint_step_phase(root: Path, ann: Path) -> dict:
    """Phase 8: the stage-1 joint step with pool="gap", and one step against
    the CPU."""
    from video_caption_tpu_torch.cli.train_full import align_loss
    from video_caption_tpu_torch.data import build_dataloader
    from video_caption_tpu_torch.decode.tokenizer import get_tokenizer
    from video_caption_tpu_torch.models import align as al
    from video_caption_tpu_torch.models import vit as vt
    from video_caption_tpu_torch.ops import selfcheck
    from video_caption_tpu_torch.training import loop
    from video_caption_tpu_torch.training.optim import adamw, global_norm, leaves

    tokenizer = get_tokenizer()
    cfg = al.AlignConfig(vit=vt.ViTConfig(pool="gap", dtype=torch.float32, remat=True),
                         temporal_mode="mean", vocab_size=tokenizer.vocab_size)
    params = al.init_align_params(torch.Generator(device="cuda").manual_seed(SEED), cfg, "cuda")
    start = {p: t.clone() for p, t in leaves(params)}
    loader = build_dataloader(str(ann), tokenizer, batch_size=TRAIN_BATCH, max_len=16,
                              num_frame=TRAIN_FRAMES, image_size=IMAGE_SIZE, num_workers=1)
    loss_fn = align_loss(cfg)

    # one step at 1 video x 2 frames: kernels on the card against the plain
    # versions on the CPU, f32 both, the same initial parameters
    first = next(iter(build_dataloader(str(ann), tokenizer, batch_size=1, max_len=16,
                                       num_frame=2, image_size=IMAGE_SIZE, shuffle=False)))
    small = {k: v for k, v in first.items() if k != "video_id"}
    loss_gpu, grads_gpu = loop.value_and_grad(loss_fn, params, loop.to_device(small, "cuda"))
    cpu_params = _f32_cpu(params)
    loss_cpu, grads_cpu = loop.value_and_grad(loss_fn, cpu_params, loop.to_device(small, "cpu"))
    norm_gpu = float(global_norm(list(grads_gpu.values())))
    norm_cpu = float(global_norm(list(grads_cpu.values())))
    loss_err = abs(float(loss_gpu) - float(loss_cpu)) / abs(float(loss_cpu))
    norm_err = abs(norm_gpu - norm_cpu) / norm_cpu
    log(f"joint step, 1 video x 2 frames: loss {float(loss_gpu):.7f} (card) vs "
        f"{float(loss_cpu):.7f} (CPU), rel err {loss_err:.3e}; gradient norm {norm_gpu:.7f} vs "
        f"{norm_cpu:.7f}, rel err {norm_err:.3e} (bound {TRAIN_REL_TOL:g})")
    if not (loss_err < TRAIN_REL_TOL and norm_err < TRAIN_REL_TOL and math.isfinite(norm_gpu)):
        raise AssertionError("the joint step on the card disagrees with the f32 CPU path")

    timer = _StepTimer(loop.sgd_step)
    out_dir = root / "joint_run"
    _reset_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loop.sgd_step = timer
    try:
        result = loop.run_training(
            params, loss_fn, adamw(params, 1e-4), loader,
            cfg=loop.LoopConfig(max_steps=TRAIN_STEPS, out_dir=str(out_dir)),
            batch_transform=lambda b: {k: v for k, v in b.items() if k != "video_id"})
    finally:
        loop.sgd_step = timer.fn
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = _kernel_counts()
    losses = _losses(out_dir / "events.csv")
    stats = timer.summary(TRAIN_BATCH)
    moved = sum(not torch.equal(t, start[p]) for p, t in leaves(params))
    log(f"joint step (gap, f32, remat): {result['steps']} steps in {wall:.1f} s; steps "
        f"2-{TRAIN_STEPS} {[round(x, 1) for x in stats['step_ms']]} ms, median "
        f"{stats['median_step_ms']:.1f} ms/step, {stats['samples_per_s']:.2f} samples/s; peak "
        f"device memory {peak / 2**20:.0f} MiB")
    log(f"joint step: losses {losses}; {moved} of {len(start)} leaves moved; launches "
        f"{launches}, per step {stats['launches_per_step']}")
    _require_launches(launches, selfcheck.JOINT_TRAINING_PATH, "the joint step")
    per_step = stats["launches_per_step"]
    if per_step["fused_pool"] != 1 or per_step["encoder_attention"] != 2 * cfg.vit.depth:
        raise AssertionError(f"a joint step must launch fused_pool once and encoder_attention "
                             f"twice per layer (forward, remat recompute): {per_step}")
    if not (len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses))
            and moved == len(start)):
        raise AssertionError("the joint step did not take finite steps that move every leaf")
    return {"losses": losses, "wall_s": wall, "peak_bytes": peak, "launches": launches,
            "one_step": {"loss_gpu": float(loss_gpu), "loss_cpu": float(loss_cpu),
                         "loss_rel_err": loss_err, "grad_norm_gpu": norm_gpu,
                         "grad_norm_cpu": norm_cpu, "grad_norm_rel_err": norm_err},
            **stats}


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


def _beam_decode_logits(params, cfg, embeds, sampled=()):
    """Logits [DECODE_STEPS, B*BEAMS, Vp] of beam steps through
    gpt2_beam_step with ``cfg``'s decode configuration after a prefill of
    ``embeds``: each step's beams descend from beams 0, 0, 1 of the last
    step (the ancestry reorders) and feed fixed tokens. The blocks listed
    in ``sampled`` take the unified decode's sampled layout instead: every
    row keeps identity ancestry, its k=0 row live."""
    from video_caption_tpu_torch.decode import generate as gen
    from video_caption_tpu_torch.models import gpt2 as g2

    b, s0, _ = embeds.shape
    dev, r = embeds.device, b * BEAMS
    wte_t = g2.lm_head_t(params, cfg)
    _, pcache, pvalid, row_len = gen._prefill(params, cfg, embeds, s0, None, wte_t, split=True,
                                              row_stats=True)
    gen_cache = g2.init_cache(cfg, r, DECODE_STEPS, dev, layout="beam_gen")
    rows = torch.arange(r, dtype=torch.int32, device=dev)
    first = (rows // BEAMS) * BEAMS
    parent = first + torch.tensor([0, 0, 1], device=dev).repeat(b)
    for block in sampled:
        parent[block * BEAMS:(block + 1) * BEAMS] = rows[block * BEAMS:(block + 1) * BEAMS]
    anc = torch.zeros((r, DECODE_STEPS), dtype=torch.int32, device=dev)
    out = []
    for t, token in enumerate((32, 97, 32, 109)[:DECODE_STEPS]):
        if t:
            anc = anc[parent]
        anc[:, t] = rows
        ids = token + rows.long() % BEAMS
        (logits, _, _, _), gen_cache = g2.gpt2_beam_step(
            params, params["wte"][ids], row_len.repeat_interleave(BEAMS) + t, pcache, pvalid,
            gen_cache, anc, t, BEAMS, cfg, wte_t)
        out.append(logits)
    return torch.stack(out)


def _unified_vs_grouped(engine, prefix, vocab):
    """The first DECODE_STEPS decode steps' logits of the two programs on
    the card, on the same inputs (three instances of one prefix with
    prompts of the core presets' longest length, 44 tokens, so the prefill
    is 48 columns wide as in a request; fixed tokens and ancestry): the
    unified layout (9 rows: two beam-3 blocks and a sampled block) against
    the grouped beam-3 group (6 rows) and the K=1 steps of the sampled row.
    Fails unless each is within REL_TOL of the other."""
    from video_caption_tpu_torch.models import caption_model as cm

    ids = torch.randint(32, 127, (3, 44), generator=torch.Generator("cuda").manual_seed(SEED),
                        device="cuda")
    params, mc = engine.params, engine.model_cfg
    with torch.inference_mode():
        embeds = cm.build_decoder_inputs(params, prefix.repeat(3, 1, 1), ids, mc)
        uni = _beam_decode_logits(params["decoder"], mc.gpt2, embeds, sampled=(2,))
        beam = _beam_decode_logits(params["decoder"], mc.gpt2, embeds[:2])
        k1 = _decode_logits(params["decoder"], mc.gpt2, embeds[2:])
    beam_err = rel_err(uni[:, :6, :vocab], beam[..., :vocab])
    sampled_err = rel_err(uni[:, 6, :vocab], k1[:, 0, :vocab])
    log(f"unified vs grouped: {DECODE_STEPS} steps' logits after a 48-column prefill, of the beam "
        f"rows (R=9 vs R=6) rel err "
        f"{beam_err:.3e}, of the sampled row (beam step vs K=1 step) {sampled_err:.3e} (bound "
        f"{REL_TOL:g})")
    if not (beam_err < REL_TOL and sampled_err < REL_TOL):
        raise AssertionError("the unified program's logits disagree with the grouped program's")
    return {"beam_rows_rel_err": beam_err, "sampled_row_rel_err": sampled_err}


def _batch_phase(engine, dirs):
    """infer_batch at every bucket of the serving queue on a graph engine and
    its eager twin (the default configuration, the same parameters and
    seed, each its own video cache): one batch each (the graph's capture
    for that size), BATCH_REPEATS timed batches (their videos from the
    cache), then the ids of one more on each, which must be identical."""
    from video_caption_tpu_torch.engine import InferenceEngine

    cfg = engine.config
    engines = {"graph": InferenceEngine(cfg, params=engine.params, seed=SEED, device="cuda"),
               "eager": InferenceEngine(dataclasses.replace(cfg, compile=dataclasses.replace(
                   cfg.compile, aot_request_program=False)), params=engine.params, seed=SEED,
                   device="cuda")}
    out = {}
    for v in BUCKETS:
        batch, row = dirs[:v], {"videos": v}
        for mode, eng in engines.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = eng.infer_batch(batch)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            times = []
            for _ in range(BATCH_REPEATS):
                t0 = time.perf_counter()
                results = eng.infer_batch(batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            for r in results:
                _check_result(r.to_api_dict())
            video = eng._load_videos(batch)
            row[mode] = {"first_batch_s": first_s, "batch_ms": [t * 1000 for t in times],
                         "median_batch_ms": statistics.median(times) * 1000,
                         "captions_per_s": v / statistics.median(times),
                         "ids": eng.request_ids(video),
                         "results": [r.to_api_dict() for r in results]}
        graph = engines["graph"].request_graph(video)
        row["graph"]["capture_s"] = graph.capture_s
        same = all(a.shape == b.shape and (a == b).all()
                   for a, b in zip(row["graph"].pop("ids"), row["eager"].pop("ids")))
        if not same:
            raise AssertionError(f"infer_batch of {v}: the graph's ids differ from the eager ids")
        g, e = row["graph"], row["eager"]
        log(f"infer_batch V={v}: graph {g['median_batch_ms']:.1f} ms a batch "
            f"{[round(x, 1) for x in g['batch_ms']]}, {g['captions_per_s']:.2f} captions/s, "
            f"capture {g['capture_s']:.2f} s (first batch {g['first_batch_s']:.2f} s); eager "
            f"{e['median_batch_ms']:.1f} ms, {e['captions_per_s']:.2f} captions/s; ids identical")
        out[v] = row
    return out


def _server_phase(dirs, ckpt):
    """The port's stdlib server on 127.0.0.1:0 with the registry building
    the serving engine (serving presets, 16 frames, an absent checkpoint:
    seeded random weights) and warming it as ``cli/serve.py --warmup``
    does; then two rounds of SERVER_CLIENTS concurrent POST /infer (the
    first captures each batch size's graph as the queue forms it). Every
    response must be 200 and well formed; fails unless a batch of more
    than one formed and no request was retried alone."""
    import concurrent.futures
    import urllib.request

    from video_caption_tpu_torch.server.schemas import InferRequest
    from video_caption_tpu_torch.server.services import batching_queue
    from video_caption_tpu_torch.server.services.inference_service import request_to_config
    from video_caption_tpu_torch.server.services.model_registry import MODEL_REGISTRY
    from video_caption_tpu_torch.server.stdlib_server import StdlibServer

    def payload(d):
        return {"frames_dir": d, "ckpt": ckpt, "num_frames": NUM_FRAMES, "image_size": IMAGE_SIZE}

    t0 = time.perf_counter()
    engine = MODEL_REGISTRY.get_engine(request_to_config(InferRequest.from_payload(
        payload(dirs[0]))))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    warm_s = engine.warmup()
    sizes, retries = [], []
    bucket, infer = batching_queue.BatchingQueue._bucket_size, engine.infer
    batching_queue.BatchingQueue._bucket_size = staticmethod(
        lambda n: (sizes.append(n), bucket(n))[1])
    engine.infer = lambda d: (retries.append(d), infer(d))[1]
    server = StdlibServer("127.0.0.1", 0).start()

    def post(d):
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}/infer",
                                     data=json.dumps(payload(d)).encode(),
                                     headers={"Content-Type": "application/json"}, method="POST")
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read()), time.perf_counter() - t

    rounds, warmed = [], []
    try:
        with concurrent.futures.ThreadPoolExecutor(SERVER_CLIENTS) as pool:
            for i in range(2):
                if i:
                    # the batch sizes the first round did not form, captured
                    # here while the queue is idle: the second round is warm
                    warmed = [v for v in BUCKETS if v not in {k[0] for k in engine._graphs}]
                    for v in warmed:
                        engine.infer_batch(dirs[:v])
                before = len(sizes)
                t0 = time.perf_counter()
                answers = list(pool.map(post, [dirs[i % len(dirs)]
                                               for i in range(SERVER_CLIENTS)]))
                wall = time.perf_counter() - t0
                for status, body, _ in answers:
                    if status != 200:
                        raise AssertionError(f"the server answered {status}: {body}")
                    _check_result(body)
                lat = sorted(a[2] * 1000 for a in answers)
                rounds.append({"batch_sizes": sizes[before:], "latency_ms": lat,
                               "p50_ms": statistics.median(lat),
                               "p99_ms": lat[min(len(lat) - 1, math.ceil(0.99 * len(lat)) - 1)],
                               "captions_per_s": SERVER_CLIENTS / wall, "wall_s": wall})
    finally:
        server.stop()
        batching_queue.get_queue(engine).stop()
        batching_queue.BatchingQueue._bucket_size = staticmethod(bucket)
        engine.infer = infer
    for i, r in enumerate(rounds):
        kind = "graph captures" if i == 0 else f"warm: {warmed} captured before it"
        log(f"server round {i + 1} ({kind}): "
            f"{SERVER_CLIENTS} concurrent clients, all 200; batches formed {r['batch_sizes']}; "
            f"client p50 {r['p50_ms']:.1f} ms, p99 {r['p99_ms']:.1f} ms, "
            f"{r['captions_per_s']:.2f} captions/s")
    log(f"server: engine built by the registry in {build_s:.2f} s, warmed in {warm_s:.2f} s; "
        f"per-request retries {len(retries)}; graphs {sorted(k[0] for k in engine._graphs)}")
    if max(n for r in rounds for n in r["batch_sizes"]) < 2:
        raise AssertionError(f"the queue formed no batch of more than one: {rounds}")
    if retries:
        raise AssertionError(f"the queue retried {len(retries)} requests one by one")
    return {"build_s": build_s, "warmup_s": warm_s, "rounds": rounds, "retries": len(retries),
            "warmed_before_round_2": warmed}


def _bench_phase(engine, dirs, root: Path) -> dict:
    """Phase 11: the measurement stack at full width (see the module
    docstring); the kernel counts set to 0 before it and read after."""
    import os

    os.environ["BENCH_PIPELINE_DEPTH"] = "2"
    os.environ["BENCH_TRIALS"] = "3"
    from video_caption_tpu_torch.bench import accuracy_alignment, benchmark, driver, roofline
    from video_caption_tpu_torch.bench import serving_load
    from video_caption_tpu_torch.config import serving_inference_config
    from video_caption_tpu_torch.engine import InferenceEngine
    from video_caption_tpu_torch.ops import selfcheck
    from video_caption_tpu_torch.server.services import batching_queue
    from video_caption_tpu_torch.server.services.model_registry import MODEL_REGISTRY

    out = {}
    _reset_kernel_counts()
    reports = root / "bench_reports"
    summary = benchmark.run_sweep(engine.config, dirs[0], [1], BENCH_WARMUP, BENCH_ITERS, 24,
                                  reports, params=engine.params, model_cfg=engine.model_cfg,
                                  seed=SEED)
    files = sorted(p.name for p in reports.iterdir())
    means = {k: summary[k]["mean"] for k in (
        "Preprocess_Latency", "Preprocess_CUDA_Latency", "ViT_Latency", "Cross_Modal_Alignment",
        "GPT2_Latency", "GPT2_token_step", "End_to_end_Latency")}
    log(f"bench StageBench batch 1 ({BENCH_WARMUP} warm-ups, {BENCH_ITERS} iterations), mean ms: "
        + ", ".join(f"{k} {v:.3f}" for k, v in means.items())
        + f"; {summary['Throughput']['mean']:.2f} samples/s; reports {files}")
    if files != ["baseline_iterations.csv", "baseline_summary.json",
                 "benchmark_bs_comparison.csv", "benchmark_bs_summary.json"]:
        raise AssertionError(f"StageBench wrote {files}")
    out["stage_bench"] = {"mean_ms": means, "files": files}

    cfg = engine.config
    unified = InferenceEngine(dataclasses.replace(cfg, compile=dataclasses.replace(
        cfg.compile, unified_decode=True)), params=engine.params, seed=SEED, device="cuda")
    out["roofline"] = {}
    for label, eng, batch in [("default", engine, b) for b in ROOFLINE_BATCHES] + [
            ("unified_decode", unified, 1)]:
        r = roofline.measure_roofline(eng, batch=batch,
                                      report_path=str(root / f"roofline_{label}_{batch}.json"))
        out["roofline"][f"{label} batch {batch}"] = r
        for st in r["stages"]:
            log(f"bench roofline {label} batch {batch} {st['stage']:34s} device "
                f"{st['device_ms']:.3f} ms, {st['gflops']:.2f} GFLOP, {st['gbytes']:.4f} GB, "
                f"{st['pct_peak_flops']:.2f}% of peak FLOP/s, {st['pct_peak_hbm']:.2f}% of "
                f"peak HBM")
            if st["pct_peak_flops"] > 100 or st["pct_peak_hbm"] > 100:
                raise AssertionError(f"a share of the peak over 100%: {st}")
        log(f"bench roofline {label} batch {batch}: device total {r['device_total_ms']:.3f} ms, "
            f"{r['device_caps_per_sec']:.2f} captions/s (device only; peaks {r['peaks']})")

    log("bench driver (batch 8, pipeline depth 2, 3 trials):")
    rc = driver.main(["1", "3", "8"])
    if rc != 0:
        raise AssertionError(f"the driver returned {rc}")
    out["driver_history"] = json.loads(driver.HISTORY.read_text())[-1]

    load = serving_load.run_load(dirs[0], LOAD_QPS, LOAD_SECONDS, num_frames=NUM_FRAMES)
    batching_queue.get_queue(MODEL_REGISTRY.get_engine(
        serving_inference_config(num_frames=NUM_FRAMES))).stop()
    if load["errors"]:
        raise AssertionError(f"the serving load had {load['errors']} errors of "
                             f"{load['requests_sent']}: {load['error_samples']}")
    lat = load["latency_ms"]
    log(f"bench serving load {LOAD_QPS:g} QPS for {LOAD_SECONDS:g} s: {load['requests_ok']} of "
        f"{load['requests_sent']} answered, achieved {load['achieved_qps']:.2f} QPS, p50 "
        f"{lat['p50']:.1f} ms, p90 {lat['p90']:.1f} ms, p99 {lat['p99']:.1f} ms, max "
        f"{lat['max']:.1f} ms")
    out["serving_load"] = load

    gate = accuracy_alignment.check_alignment(image_size=IMAGE_SIZE, num_frames=4, seed=SEED)
    for leg, res in gate.items():
        if leg != "all_ok":
            log(f"bench accuracy {leg}: {json.dumps(res)}")
    dec = gate[accuracy_alignment.DECODE]
    log(f"bench accuracy gate all_ok {gate['all_ok']}: {dec['rows']} rows, step rel "
        f"{dec['step_logits_rel_err']:.3e} (tol {dec['step_rel_tol']:g}), agreement "
        f"{dec['token_agreement_rate']:.4f} (floor {dec['agreement_floor']:g}), flat "
        f"{dec['token_agreement_rate_flat_informational']:.4f}, peaked fraction "
        f"{dec['peak_frac_gap_ge_1nat']:.5f} (floor {dec['peak_frac_floor']:g}), min gap "
        f"{dec['peak_min_gap_nats']:.3f} nats, mean gap {dec['peak_mean_gap_nats']:.3f}, "
        f"{dec['widening_rounds']} widening rounds, launches lm_head {dec['lm_head_launches']} "
        f"beam_attention {dec['beam_attention_launches']}")
    if not gate["all_ok"]:
        raise AssertionError(f"the accuracy gate failed: {gate}")
    out["accuracy"] = gate

    launches = _kernel_counts()
    log(f"bench: launches over the phase {launches}")
    _require_launches(launches, selfcheck.DEFAULT_PATH, "the bench phase")
    out["launches"] = launches
    return out


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
