"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--report PATH]

Phases (any failure ends the run with a traceback and a non-zero exit):

1. environment: requires CUDA; prints the torch/CUDA versions and the card's
   name and power limit (nvidia-smi);
2. build: compiles the hand-written kernels (ops/csrc/*.cu), one nvcc
   per source, all started together; prints nvcc's register and spill
   report of every kernel and the counts of tensor-core instructions (HMMA,
   HGMMA), 16-byte global loads, generic loads (fused_pool's reads of a
   cluster peer's shared memory), cluster barriers and cp.async copies
   (LDGSTS) in its SASS (cuobjdump);
3. kernels: each kernel against its plain PyTorch version on the card at the
   main path's and the trainers' shapes (error beside its tolerance, median
   device times of the kernel, the plain version and, where there is one, a
   single PyTorch call of the same function, beside the bound); then the input
   gradients of the five differentiable kernels (kernel forward,
   closed-form backward) against autograd through their plain versions;
   norm_act (the bf16 LayerNorm and GELU) at the ViT's and the decode's
   rows, held to 1 ulp and 99.9% equal outputs, its gradients at the mapper
   step's GPT-2 rows to autograd's bit for bit. Phases 3-9, 11 and 12 run
   bf16 alone on the card: there no LayerNorm or f32 GELU may take
   norm_act's plain version (its ``plain_on_cuda`` must not move; phase
   10's joint step and phase 13's accuracy gate run f32 on the card);
4. engine: a full-width ViT-B/16 + GPT-2 (124M) engine with seeded random
   bf16 weights, 16 frames of 224x224 JPEGs per request, serving each
   request as the default configuration does: one replay of the request
   program captured into a CUDA graph (``aot.RequestGraph``), which
   decodes the three presets in one unified beam-step loop
   (``compile.unified_fused_request``). Beside it its eager twin
   (``compile.aot_request_program`` off: group by group, op by op; the same
   seed and parameters). Each takes a warm-up (the graphs' captures) and
   then the same timed requests through ``InferenceEngine.infer`` with the
   core presets: the first request on a dir is cold (a video-cache miss:
   the overlapped path, chunk trunks and the feats program), a repeat warm
   (the pixel program); p50 of each kind is printed. The token ids of one
   more request must be identical (the graph's replay against the same
   program run op by op), and so must the results where both decode group
   by group (else the share of identical captions is printed). One replay
   runs under torch.profiler: its count of the port's kernels must equal
   the wrappers' counters' delta. The kernels' launch counts are read
   around each of the graph's requests: 1 prefix_projector, 24 lm_head and
   276 beam_attention launches a request, encoder_attention 24 a cold one
   (12 a chunk of 8 frames) and 12 a warm one, and neither fused-decode
   kernel. Then the same pair with
   ``unified_fused_request`` off (48 lm_head launches a request): kernels,
   device ms, replay ms, p50 and captions/s of both programs side by side;
   one request with the serving presets (its first: the capture included);
4b. artifact, on phase 4's engine and graph: ``aot.export_request_program``
   of the default engine (its seconds and the archive's MB), the weights,
   a video and the noise of the live request graph's next replay saved,
   then this script again in a fresh process (``--replay-artifact DIR``),
   which imports the port's ``aot`` module and not the engine: it loads
   the archive with ``AotRuntime`` (seconds) while phases 5-7 run, and
   after phase 7 captures ``run`` into an ``aot.RequestGraph`` and replays
   it; its ids must equal the live replay's for every group
   (the sampled one included), its launches a replay those of the live
   graph (12 / 1 / 24 / 276, and norm_act 925: the ViT's and 24 GPT-2
   forwards' 25 LayerNorms and 12 GELUs each), and its device ms under
   torch.profiler are printed beside the live graph's; then the eager
   request program's p50 with the kernel wrappers calling their CUDA
   implementations directly and through their custom ops, in turns
   (direct, op, op, direct);
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
7. int8, early stop, the split cache, full-vocab policies and eval, at
   full width with the default engine's parameters, each driven with the kernels' counts set to 0 just before it
   and read just after: (a) an engine with ``compile.quantize_decoder_int8``
   (its block weights int8 and their scales f32 on the card,
   ``use_pallas_decode_layer`` off) on its request graph beside its eager
   twin, as in 4, the logits of 4 beam-3 steps against the same int8
   weights dequantized in f32 on the CPU (relative error below 3e-2), its
   p50, replay, device ms and peak memory beside the bf16 engine's and its
   beam tokens' agreement with the bf16 engine (information: int8 captions
   may differ); (b) an engine with ``compile.early_stop_decode``, which
   serves eagerly: its results equal a full-length eager engine's, and the
   beam group and a greedy group (its EOS a token the greedy decode reaches)
   give the ids of their full-length loops, with the steps each ran; (c) an
   engine with ``compile.sample_split_cache`` (group by group) on its graph
   beside its eager twin, and the ``natural`` group's ids and device ms on
   the split and the contiguous cache; (d) the full-vocab chain:
   ``precise`` with ``repetition_penalty=0.9`` and ``natural`` with
   ``top_k=0`` through ``generate_once`` and ``run_decode_group`` beside
   their candidate-path policies, one unified decode mixing them with
   ``precise`` captured into a CUDA graph (its beam groups' ids equal the
   same program run op by op), and the processed scores of 4 beam-3 and 4
   K=1 steps against the f32 CPU path; (e) ``eval/``:
   ``ablate_decode.ablate`` over 2 annotated videos on beams 1, 3, 5 x T
   0.8 x top_p 0.9 x n-gram 3 and ``eval_compare.compare`` between the
   bf16 and int8 engines, which must launch ``beam_attention`` at K=5 (its
   wrapper's count by beam count);
8. batches: ``infer_batch`` of 1, 2, 4 and 8 videos on the graph (one graph
   per batch size, captured on first use) beside an eager twin: ms a batch,
   captions/s, capture s, and the ids of one more batch identical;
9. mapper trainer: ``cli/train_caption_mapper.main`` on a synthetic
   annotations file over the same JPEG directories, full-width ViT-B/16 +
   GPT-2 with seeded random weights, bf16 compute, 4 videos x 8 frames, 5
   steps (each synchronised and timed), then a validation pass and a
   best-val checkpoint; the losses must be finite, the mapper must move and
   every other weight stay bit-equal (their rate is 0), and the step must
   launch encoder_attention (frozen forward), prefix_projector and norm_act
   (the ViT's, and GPT-2's under autograd);
10. joint step: ``training/loop.run_training`` with the stage-1 alignment
   loss of ``cli/train_full.py --model vit`` and ``adamw(1e-4)``, the ViT
   with ``pool="gap"``, f32 and remat, 4 videos x 8 frames, 5 steps; the step
   must launch fused_pool once and encoder_attention twice per layer
   (forward and remat recompute); then the loss and global gradient norm of
   one step at 1 video x 2 frames on the card against the same step in f32
   on the CPU (plain versions);
11. server: the port's stdlib HTTP server on 127.0.0.1:0, the registry
   building the serving-preset engine (absent checkpoint: seeded random
   weights), 16 concurrent clients POST /infer, twice: every answer 200 and
   well formed, at least one batch of more than one formed by the queue and
   no request retried alone; batch sizes, client p50/p99, captions/s; then
   the frontend against the same server: ``frontend/api_client``'s
   ``check_health`` (true), ``infer_caption`` (a well-formed result) and its
   ``BackendError`` on a missing dir (400), and
   ``frontend/chainlit_app.handle_message`` (the markdown reply with BEST
   and S1-S3; its request carries the phase's payload fields) and its
   reply to a path that is no directory;
12. frame path: (a) the wire a packed load of the smoke's frames takes
   (the native loader's ``last_backend`` and ``last_error``: without
   libjpeg headers it does not build and frames decode through PIL as
   RGB), the 4:2:0 conversion on the card bit-equal to its CPU mirror on
   seeded planes at 224 and 223 (and the whole wire against PIL where the
   loader builds); (b) engines with the video cache off, the overlapped
   cold path on and off: cold p50 of each, the feats graph's capture, one
   replay of it, of the pixel graph and of a chunk's trunk graph under
   torch.profiler (kernels, device ms, the port's kernels equal to the
   counters' delta; a window whose head the profiler lost is discarded,
   at most one a replay, and the discards are reported), the feats program's prefix against the pixel
   program's on one video (relative error below 5e-2) and the two
   programs' identical id rows from one generator state; (c)
   ``bench/roofline.measure_training_step`` on the packed wire and on RGB
   (bf16, 4 videos x 8 frames: device, e2e and prefetched ms, bytes a
   step); (d) ``retrieval.features.extract_features`` over the 8 videos at
   8 frames (one batch: encoder_attention at 64 frames), the index and
   ``evaluate_retrieval`` (recall@1 must be 1), and 2 videos' features
   against f32 on the CPU (relative error below 5e-2);
13. bench: the port's measurement stack (``bench/``) over the default
   engine's parameters: ``StageBench`` at batch 1 (2 warm-ups, 5
   iterations, the four report files in a temporary directory; stage
   means); ``measure_roofline`` of the default engine at batch 1 and 8 and
   of one with ``compile.unified_decode`` at batch 1 (device ms, GFLOP,
   GB and the shares of the H100's peaks per stage; a share over 100%
   fails); the driver (``bench/driver.py``, batch 8, depth 2), which prints
   its JSON line; one ``serving_load.run_load`` at 8 QPS for 5 s (no
   error allowed); the accuracy gate (``check_alignment`` at 224x224:
   72 videos x 4 beams on the card against f32 on the CPU, ``all_ok``
   required). The kernel counts are read around the phase: the default
   path's four kernels must launch;
14. quality loop: ``tools/quality_loop.main`` at full width (ViT-B/16 at
   224x224, 8 frames, GPT-2 124M, seeded random init) with its scale cut
   (QUALITY_LOOP_ARGS: 4 classes, 2 train and 1 val video each, 30 stage-3
   steps, 30 mapper steps, 10 align steps at batch 8 and the loop's Adam
   1e-3, 4 eval videos; the ablation grid beams 1, 3, 5 x one
   temperature): each stage's seconds and first and last loss, the BLEU of
   the trained checkpoint (A) and of random weights (B), retrieval
   recall@1/5 and MRR trained and random, the phase's peak memory and the
   launches of encoder_attention, fused_pool (the align model's per-frame
   gap mean), prefix_projector, lm_head and beam_attention over ``main``,
   each of which must launch; every loss must be finite and the stage-3
   loss fall. At 1e-3 the align stage collapses 8 records to one
   embedding (loss ln 8) in the JAX package's algorithm too
   (``bench/align_rate.py``, ``tests/align_rate_vs_jax.py``), so the align
   loss must fall over ``train_align`` on the same records at Adam 1e-4
   (QUALITY_LOOP_ALIGN_STEPS steps). Then an engine over the mapper's
   checkpoint directory and one over ``tools/export_checkpoint``'s .pt of
   it: identical parameters and S1 ids; ``tools/batch_infer`` over the
   val split with that directory at batch 2 (one row per video) and
   ``tools/batch_bestof``'s pick from its rows; ``tools/hybrid_infer.hybrid_caption``
   through the directory's engine on 2 val videos, each after a first
   ``infer``: with a counting stub fallback (S1 and S2 equal to ``infer``'s
   on the same dir), then with ``tools/caption_fallback.make_blip_fallback()``
   (BEST and USED as ``is_bad_caption`` of the candidates decides; a BLIP
   fallback that is called reports ``fallback_failed:``: the card's
   machine has transformers but no weights, and the hub is kept offline;
   the first call's import of transformers takes ~11 s there), and both
   fallbacks once more on candidates made to fail the gate (the stub's
   caption taken, BLIP's failure recorded), the kernels' counts read around
   each request (the unified request's, encoder_attention 12 at 8 frames)
   and the ms of each request; ``tools/human_eval.main`` on the batch_infer
   CSV: a questionnaire of one row per captioned video;
16. mesh (run after 14, before the summary): the port's multi-device
   paths (``parallel/``). The card is one H100 and NCCL refuses two ranks
   on one device, so two ranks (``parallel/dryrun.run_world``, spawned,
   their exit codes checked, a world not done within MESH_TIMEOUT_S
   killed and the run failed) share it over gloo (``backend="gloo"``,
   printed with the reason). Each rank builds its engines as a user does:
   ``InferenceEngine(config)`` with ``config.mesh`` set and the device
   named ``cuda`` (resolved to ``cuda:LOCAL_RANK``). At full width with
   seeded random bf16 weights and 16 frames, ``infer_batch`` of 2 videos
   with the core presets on a 1x2 (TP: 6 heads a rank) and a 2x1 (DP) mesh
   engine, eagerly (the request program uncaptured, as under the JAX
   engine's mesh gates), each request with the kernels' counts set to 0
   just before it and read just after on each rank (encoder_attention,
   prefix_projector, lm_head and beam_attention must launch). TP: the
   prefix's and the prefill logits' relative error against the
   single-device engine (eager, same weights and seed; bound REL_TOL) and
   the share of identical id rows (not required: bf16 sums over the two
   halves of every row-parallel product in another order). DP: every
   group's ids identical to the single-device engine's on each data rank's
   video alone with that rank's rows of the batch's noise
   (``dryrun.rows_alone_ids``). encoder_attention and beam_attention at a
   rank's 6 heads against their plain versions (error, tolerance, kernel /
   plain / library ms, bound). One mapper-trainer step at 2x1 with
   ``fsdp=True, fsdp_min_elems=0`` at 2 GPT-2 layers of full width (the
   last one trained) against the single-device step: the loss within
   MESH_LOSS_RTOL, the gradient norm within MESH_NORM_RTOL, the trained
   leaves' update with a share of flipped elements below
   MESH_FLIPPED_SHARE (and one device's step on half the batch above it),
   all-gathers over data in it.
   Then a one-rank NCCL group: an all-reduce, an all-gather and a
   reduce-scatter of ``parallel/collectives.py`` on CUDA tensors, and the
   same batch on the engine of that one rank (a 1x1 mesh), whose ids must
   equal the single-device engine's (its ids gathered over ``data``
   through NCCL);
15. the seconds of each phase and of the run, the kernel table as one JSON
   line (launches of each kernel's path: the default engine's requests,
   each fused-decode engine's, the joint steps' for fused_pool), the
   nvidia-smi line, and last ``{"ok": true, "device": {...}}``.

With ``--report PATH`` every check, latency and result is also written to
PATH as JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
import json
import math
import os
import re
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
DEFERRED = "deferred_decode_cache_write"
GROUPED = "unified_fused_request"          # off: the request decodes group by group
# launches a request of the default engine (core presets, one unified loop:
# a prefill and 23 beam steps of 12 layers) and of the grouped program
UNIFIED_LAUNCHES = {"prefix_projector": 1, "lm_head": 24, "beam_attention": 276}
GROUPED_LAUNCHES = {"prefix_projector": 1, "lm_head": 48, "beam_attention": 276}
# launches of one replay of the default engine's request graph (warm: the
# pixel program), the live one and the one loaded from its artifact;
# norm_act: 2 LayerNorms and a GELU a layer and a final LayerNorm, in the
# ViT and in each of the 24 GPT-2 forwards
ARTIFACT_LAUNCHES = {"encoder_attention": 12, "norm_act": (1 + 24) * (3 * 12 + 1),
                     **UNIFIED_LAUNCHES}
ARTIFACT = "request.pt2"
ARTIFACT_TIMEOUT_S = 600    # the fresh process: load, capture, replays
EAGER_REQUESTS = 5          # eager requests a turn (direct, op, op, direct)
# encoder_attention a request: 12 layers over the whole video on a warm
# request (the pixel graph), 12 a chunk of 8 frames on a cold one (the
# overlapped path's trunk graphs)
CHUNK = 8
WARM_ENCODER = 12
# spin kernels that open a profiled window (_profiled_replay), ~5 us each
PROFILE_SPINS, PROFILE_SPIN_CYCLES = 256, 10_000
PROFILE_DISCARDS = 1    # windows a profiled replay may discard (it fails past that)
COLD_ENCODER = 12 * -(-NUM_FRAMES // CHUNK)
BUCKETS = (1, 2, 4, 8)
BENCH_WARMUP, BENCH_ITERS = 2, 5
ROOFLINE_BATCHES = (1, 8)
LOAD_QPS, LOAD_SECONDS = 8.0, 5.0
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
INT8_REL_TOL = 3e-2    # int8 weights in bf16 products on the card vs the same weights in f32
EVAL_VIDEOS = 2
QUALITY_LOOP_ARGS = ["--colors", "2", "--shapes", "1", "--motions", "2", "--sizes", "1",
                     "--train_per_class", "2", "--val_per_class", "1", "--stage3_steps", "30",
                     "--mapper_steps", "30", "--align_steps", "10", "--eval_limit", "4"]
# the align stage over the cut's 8 records: at the loop's Adam 1e-3 (and at
# 3e-4) they collapse to one embedding, through the kernels and the plain
# path alike (bench/align_rate.py) and in the JAX package's step
# (tests/align_rate_vs_jax.py); at 1e-4 the loss falls
QUALITY_LOOP_ALIGN_LR, QUALITY_LOOP_ALIGN_STEPS = 1e-4, 25
QUALITY_LOOP_GRID = {"num_beams": (1, 3, 5), "temperature": (0.8,), "top_p": (0.9,),
                     "no_repeat_ngram_size": (3,)}
QUALITY_LOOP_KERNELS = ("encoder_attention", "fused_pool", "prefix_projector", "lm_head",
                        "beam_attention")
QUALITY_LOOP_FRAMES = 8
HYBRID_VIDEOS = 2       # val videos of the quality loop that hybrid_caption captions
MESH_VIDEOS = 2         # phase 16's batch: one video a data rank at 2x1
MESH_TIMEOUT_S = 420    # a world of ranks not done by then is killed and fails the run
# the FSDP step at 2x1 (two rows a rank, bf16 compute) against the
# single-device step on the same four rows. The loss: each row's is the
# same computation, summed in another order (a few f32 ulps). The gradient
# norm: the bf16 weight gradients (8 bits, 2^-9 relative rounding) summed
# over the two ranks after rounding rather than before. The update of the
# trained leaves: Adam's first step moves nearly every element by +-lr
# (lr * g / (|g| + eps)), so the two steps' updates differ only where an
# element's gradient is within its rounding of 0 and its sign flips; the
# share of flipped elements is bounded. The control, one device's step on
# half the batch (a rank that left half of it out), must exceed the bound.
MESH_LOSS_RTOL = 1e-5
MESH_NORM_RTOL = 1e-3
MESH_FLIPPED_SHARE = 1e-2
EVAL_GRID = {"num_beams": (1, 3, 5), "temperature": (0.8,), "top_p": (0.9,),
             "no_repeat_ngram_size": (3,)}
FULL_VOCAB = {"precise": {"repetition_penalty": 0.9}, "natural": {"top_k": 0}}
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
    parser.add_argument("--replay-artifact", metavar="DIR",
                        help="(phase 4b's fresh process) load DIR's request artifact, capture "
                             "and replay it, and write DIR/replay.json")
    args = parser.parse_args()
    if args.replay_artifact:
        return _replay_artifact(Path(args.replay_artifact))
    run_t0 = time.perf_counter()
    # phase 14's BLIP fallback names a hub model: where transformers is
    # installed, it must fail on the missing weights and not reach for a hub
    os.environ["HF_HUB_OFFLINE"] = os.environ["TRANSFORMERS_OFFLINE"] = "1"
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
    phase_s, phase_t0 = report.setdefault("phase_s", {}), [run_t0]

    def lap(name: str) -> None:
        """Close the phase that ran since the last lap under ``name``."""
        now = time.perf_counter()
        phase_s[name] = now - phase_t0[0]
        phase_t0[0] = now

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

    lap("1-2 environment, build")
    # ---- 3. kernels against their plain versions
    plain_before = _plain_norm_act_calls()
    checks = selfcheck.main_path_checks()
    torch.cuda.synchronize()
    report["kernel_checks"] = [c.as_dict() for c in checks]
    for c in checks:
        _log_check(c)
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

    lap("3 kernel checks")
    # ---- 4. engine on the main path
    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stop:
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
        _require_per_request(pair["graph"]["per_request"], UNIFIED_LAUNCHES,
                             "the unified request")
        latencies = pair["graph"]["latencies_s"]
        log(f"engine result: {json.dumps(pair['graph']['results'][0])}")
        report["engine"] = {"presets": "core", "frames": NUM_FRAMES, **pair}

        # the same engine with the unified decode off: the grouped request
        cfg = dataclasses.replace(core_cfg, compile=dataclasses.replace(
            core_cfg.compile, **{GROUPED: False}))
        grouped = InferenceEngine(cfg, params=engine.params, seed=SEED, device="cuda")
        gpair = _graph_and_eager(f"{GROUPED}=False", grouped, dirs, TIMED_REQUESTS)
        _require_per_request(gpair["graph"]["per_request"], GROUPED_LAUNCHES,
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

        lap("4 engine")
        # ---- 4b. the serialized request artifact: exported here, loaded by
        # a fresh process while phases 5-7 run, replayed there after them
        artifact = _start_artifact(engine, dirs, Path(tmp), stop)
        lap("4b artifact: export")
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

        lap("5 fused decode")
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

        lap("6 plain-path correctness")
        # ---- 7. int8, early stop, the split cache, full-vocab policies and eval/
        report["decode_configs"] = _decode_configs_phase(
            engine, core_cfg, all_dirs, report["engine"]["graph"], emb_gpu, emb_cpu,
            Path(tmp))

        lap("7 decode configurations, eval")
        report["artifact"] = _finish_artifact(engine, artifact)
        lap("4b artifact: the fresh process's replay, eager p50")
        # ---- 8. infer_batch at every bucket, graph beside eager
        report["batches"] = _batch_phase(engine, all_dirs)

        lap("8 infer_batch")
        # ---- 9. and 10. the two trainers
        ann = Path(tmp) / "annotations.json"
        ann.write_text(json.dumps([
            {"video_id": f"video{v}", "frames_dir": d,
             "captions": [CAPTIONS[(v + i) % len(CAPTIONS)] for i in range(len(CAPTIONS))]}
            for v, d in enumerate(dirs)]))
        report["mapper_trainer"] = _mapper_trainer_phase(Path(tmp), ann)
        _require_no_plain_norm_act(plain_before, "phases 3-9 (bf16)")
        report["joint_step"] = _joint_step_phase(Path(tmp), ann)
        launches["fused_pool"] = report["joint_step"]["launches"]["fused_pool"]

        lap("9-10 trainers")
        # ---- 11. the HTTP server with its batch queue
        plain_before = _plain_norm_act_calls()
        report["server"] = _server_phase(all_dirs, ckpt)

        lap("11 server")
        # ---- 12. the cold request's frame path, the packed wire, retrieval
        # (before the bench phase: after its profiler capture, torch.profiler
        # was seen to miss the first port kernel of a replay)
        report["frame_path"] = _frame_path_phase(engine, all_dirs, Path(tmp), cpu_params,
                                                 cpu_cfg)
        _require_no_plain_norm_act(plain_before, "phases 11-12 (bf16)")

        lap("12 frame path")
        # ---- 13. the measurement stack (its accuracy gate runs the encoder in
        # f32 on the card: those LayerNorms and GELUs take the plain version)
        report["bench"] = _bench_phase(engine, all_dirs, Path(tmp))

        lap("13 bench")
        # ---- 14. the quality loop: the first trained checkpoint
        report["quality_loop"] = _quality_loop_phase(Path(tmp))
        lap("14 quality loop")
        # ---- 16. the multi-device paths: two ranks on the one card, and NCCL
        report["mesh"] = _mesh_phase(engine, core_cfg, all_dirs[:MESH_VIDEOS], Path(tmp), ckpt)
        lap("16 mesh")

    # ---- 15. summary: launches of each kernel's path (the default engine's
    # requests; the fused-decode kernels', their engines' requests;
    # fused_pool's, the joint steps'); times and bound of the first check of
    # each kernel, its single-request (fused_pool: joint-step) shape
    by_name = {}
    for c in checks:
        entry = by_name.setdefault(c.name, {"max_abs_err": 0.0, "first": c, "shapes": []})
        entry["max_abs_err"] = max(entry["max_abs_err"], c.max_abs_err)
        entry["shapes"].append(c.shape)
    kernels = []
    for name, (route, source, replaces, _) in selfcheck.KERNELS.items():
        first = by_name[name]["first"]
        kernels.append({"name": name, "route": route, "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": by_name[name]["max_abs_err"],
                        "ms": first.ms, "plain_ms": first.plain_ms, "bound_ms": first.bound_ms,
                        "bound_by": first.bound_by, "library_ms": first.library_ms,
                        "shape": first.shape, "shapes": by_name[name]["shapes"]})
    report["run_s"] = time.perf_counter() - run_t0
    log("chip_smoke: seconds a phase: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))
    log(f"chip_smoke: every phase passed in {report['run_s']:.1f} s")
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
    parameters), each warmed up, serving the same ``count`` requests
    through ``infer``: a request whose dir is not in the engine's video
    cache yet is cold and takes the overlapped path (chunk trunks, then
    the feats program: graphs on the first engine, op by op on its twin),
    a repeat is warm and takes the pixel program (its graph; the twin
    decodes group by group, ``generate_presets``). Then the ids of one
    more request on each (the eager engine runs the same request program
    op by op), the host-clock time of 5 replays with the ids' copy back,
    and one replay under torch.profiler. Fails unless the ids are
    identical, the results too where the request program decodes group by
    group as the eager path does (else their share of identical captions
    is printed: a unified loop runs other row counts, and bf16 products on
    random weights may then pick another token), and the profiler's count
    of the port's kernels in the replay equals the wrappers' counters'
    delta. The graph's ``launches`` are its timed requests', and
    ``per_request`` each request's, with whether it was cold."""
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
        lat, res, counts, per_request = _timed_requests(eng, dirs, count)
        for r in res:
            _check_result(r)
        out[mode] = {"warmup_s": warmup_s, "latencies_s": lat, "p50_s": statistics.median(lat),
                     "captions_per_s": 1.0 / statistics.mean(lat),
                     "peak_added_bytes": torch.cuda.max_memory_allocated() - before,
                     "peak_bytes": torch.cuda.max_memory_allocated(),
                     "launches": counts, "per_request": per_request, "results": res,
                     **_cold_warm_p50(lat, per_request)}
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
        f"ms, p50 {g['p50_s'] * 1000:.1f} ms ({_ms(g['cold_p50_s'])} cold x "
        f"{g['cold_requests']}, {_ms(g['warm_p50_s'])} warm x {g['warm_requests']}), "
        f"{g['captions_per_s']:.2f} captions/s, capture "
        f"{graph.capture_s:.2f} s (after a {graph.warmup_s:.2f} s run), peak "
        f"+{g['peak_added_bytes'] / 2**20:.0f} MiB; eager "
        f"{[round(x * 1000, 1) for x in e['latencies_s']]} ms, p50 {e['p50_s'] * 1000:.1f} ms "
        f"({_ms(e['cold_p50_s'])} cold, {_ms(e['warm_p50_s'])} warm), "
        f"{e['captions_per_s']:.2f} captions/s, peak +{e['peak_added_bytes'] / 2**20:.0f} MiB")
    log(f"engine {label}: request program {'unified' if unified else 'grouped'}, eager: cold "
        f"the same programs op by op, warm grouped; captions identical {same:.1%} over {count} "
        f"requests, ids identical "
        f"({[a.shape for a in ids[0]]}); replay with the ids' copy {g['replay_ms']:.2f} ms "
        f"(median of 5); one replay: {prof['kernels']} kernels, {prof['device_ms']:.2f} ms "
        f"device, busy {prof['busy_share']:.1%}, the port's kernels "
        f"{prof['wrapper_launches']} = counters' delta; launches over the graph's requests "
        f"{g['launches']}")
    return {**out, "ids_identical": same_ids, "unified": unified, "identical_captions": same}


def _start_artifact(engine, dirs, root: Path, stop: contextlib.ExitStack) -> dict:
    """Phase 4b, first half: the default engine's request program exported;
    the live graph's ids on a known draw and one replay profiled; the
    weights, video and noise saved; the fresh process started, which loads
    the artifact while phases 5-7 run (on other cores) and waits for
    :func:`_finish_artifact` before it loads the inputs, captures or
    replays. ``stop`` kills it if the run fails first."""
    from video_caption_tpu_torch import aot
    from video_caption_tpu_torch.cli.profile_request import profile_call

    work = root / "artifact"
    work.mkdir()
    t0 = time.perf_counter()
    path = Path(aot.export_request_program(engine, str(work / ARTIFACT)))
    export_s = time.perf_counter() - t0
    size_mb = path.stat().st_size / 1e6
    log(f"artifact: exported in {export_s:.1f} s, {size_mb:.1f} MB ({path.name})")

    video = engine.load_video(dirs[0])
    graph = engine.request_graph(video)
    live_launches = {m.__name__.rsplit(".", 1)[-1]: n for m, n in graph.launches.items()}
    if live_launches != ARTIFACT_LAUNCHES:
        raise AssertionError(f"the live request graph launches {live_launches}, not "
                             f"{ARTIFACT_LAUNCHES}")
    state = engine.generator.get_state()
    noises = engine.request_noise(1)            # what the next replay draws
    engine.generator.set_state(state)
    live = graph.replay(video).cpu()
    live_prof = profile_call(lambda: graph.replay(video))
    t0 = time.perf_counter()
    torch.save({"params": engine.params, "video": video, "noises": noises},
               work / "inputs.pt")
    save_s = time.perf_counter() - t0
    out = (work / "fresh_process.log").open("w")
    stop.callback(out.close)
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--replay-artifact",
                             str(work)], stdin=subprocess.PIPE, stdout=out,
                            stderr=subprocess.STDOUT, text=True)
    stop.callback(proc.wait)
    stop.callback(proc.kill)
    return {"work": work, "proc": proc, "started": time.perf_counter(), "video": video,
            "live": live, "report": {
                "export_s": export_s, "size_mb": size_mb, "save_inputs_s": save_s,
                "live_launches": live_launches, "live_device_ms": live_prof["device_ms"],
                "live_kernels": live_prof["kernels"],
                "live_busy_share": live_prof["busy_share"]}}


def _finish_artifact(engine, pending: dict) -> dict:
    """Phase 4b, second half: the fresh process, its artifact loaded, is let
    on the card (capture, replays, profile) and waited for; its ids must
    equal the live graph's and its launches a replay the live graph's. Then
    the eager request program's p50 with the wrappers calling their CUDA
    implementations directly (as before the custom ops) and through the
    ops, in turns."""
    from video_caption_tpu_torch.engine import InferenceEngine

    work, proc, live, rep = pending["work"], pending["proc"], pending["live"], pending["report"]
    waited = time.perf_counter()
    proc.communicate("go\n", timeout=ARTIFACT_TIMEOUT_S)
    rep.update(fresh_process_s=time.perf_counter() - pending["started"],
               waited_s=time.perf_counter() - waited)
    if proc.returncode != 0:
        raise RuntimeError(f"the fresh process failed (exit {proc.returncode}):\n"
                           f"{(work / 'fresh_process.log').read_text()[-6000:]}")
    got = json.loads((work / "replay.json").read_text())
    ids = torch.load(work / "replay_ids.pt")
    sizes = [len(idxs) * dp.max_new_tokens for dp, idxs, _, _ in engine._decode_groups()]
    same = [bool(torch.equal(a, b)) for a, b in zip(ids.split(sizes), live.split(sizes))]
    live_launches = rep["live_launches"]
    log(f"artifact: fresh process {rep['fresh_process_s']:.1f} s ({rep['waited_s']:.1f} s of it "
        f"after phase 7; inputs saved in {rep['save_inputs_s']:.1f} s): load "
        f"{got['load_s']:.1f} s, capture {got['capture_s']:.2f} s after a "
        f"{got['warmup_s']:.2f} s run; ids identical to the live graph's by group {same}; "
        f"launches a replay {got['launches']} (live {live_launches}); profiled "
        f"{got['profiled_launches']}; one replay {got['device_ms']:.2f} ms device, "
        f"{got['kernels']} kernels, busy {got['busy_share']:.1%} (live graph "
        f"{rep['live_device_ms']:.2f} ms, {rep['live_kernels']} kernels, busy "
        f"{rep['live_busy_share']:.1%}); engine imported {got['engine_imported']}, JAX "
        f"imported {got['jax_imported']}")
    if got["engine_imported"] or got["jax_imported"]:
        raise AssertionError("the fresh process imported the engine or JAX")
    if not (all(same) and ids.shape == live.shape and got["replays_identical"]):
        raise AssertionError(f"the artifact's ids differ from the live graph's: {same}")
    if got["launches"] != live_launches:
        raise AssertionError(f"the artifact's replay launched {got['launches']}, the live "
                             f"graph {live_launches}")

    cfg = engine.config
    eager = InferenceEngine(dataclasses.replace(cfg, compile=dataclasses.replace(
        cfg.compile, aot_request_program=False)), params=engine.params, seed=SEED, device="cuda")
    video = pending["video"]
    eager.request_ids(video)
    turns = []
    for direct in (True, False, False, True):
        with _direct_kernels(direct):
            lat = []
            for _ in range(EAGER_REQUESTS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eager.request_ids(video)
                lat.append(time.perf_counter() - t0)
        turns.append(("direct" if direct else "op", statistics.median(lat)))
    p50 = {kind: statistics.median([t for k, t in turns if k == kind])
           for kind in ("direct", "op")}
    log(f"artifact: eager request program p50 {p50['direct'] * 1000:.1f} ms with direct calls, "
        f"{p50['op'] * 1000:.1f} ms through the custom ops (turns "
        f"{[(k, round(t * 1000, 1)) for k, t in turns]} ms, medians of {EAGER_REQUESTS})")
    return {**rep, **got, "ids_identical_by_group": same, "eager_p50_direct_s": p50["direct"],
            "eager_p50_op_s": p50["op"], "eager_turns": turns}


@contextlib.contextmanager
def _direct_kernels(direct: bool):
    """With ``direct``, every kernel wrapper calls its CUDA implementation
    itself instead of its custom op (the path of the wrappers before the
    ops were registered); restored on exit."""
    from video_caption_tpu_torch import aot
    from video_caption_tpu_torch.ops import norm_act

    pairs = [(m, "_op", "_cuda") for m in aot.KERNEL_MODULES] + [(norm_act, "_gelu_op",
                                                                   "_gelu_cuda")]
    saved = [(m, op, getattr(m, op)) for m, op, _ in pairs]
    if direct:
        for m, op, cuda in pairs:
            setattr(m, op, getattr(m, cuda))
    try:
        yield
    finally:
        for m, op, fn in saved:
            setattr(m, op, fn)


def _replay_artifact(work: Path) -> int:
    """Phase 4b's fresh process: imports the port's ``aot`` module (which
    registers the kernels' custom ops) and the profiler helper, never the
    engine; loads ``work``'s artifact, then, once a line arrives on its
    standard input, the inputs, captures the loaded program into a
    RequestGraph, replays it and writes the ids and the measurements into
    ``work``."""
    from video_caption_tpu_torch import aot
    from video_caption_tpu_torch.cli.profile_request import profile_call

    t0 = time.perf_counter()
    runtime = aot.AotRuntime()
    runtime.load("request", str(work / ARTIFACT))
    load_s = time.perf_counter() - t0
    if not sys.stdin.readline():    # the parent's go (the card is free), or its end
        return 1
    inputs = torch.load(work / "inputs.pt", map_location="cuda")
    params, video, noises = inputs["params"], inputs["video"], inputs["noises"]

    def request(v):
        return torch.cat([x.reshape(-1) for x in runtime.run("request", params, v, noises)])

    graph = aot.RequestGraph.capture(request, video)
    ids = graph.replay(video).clone()
    again = graph.replay(video)
    prof = profile_call(lambda: graph.replay(video))
    torch.save(ids.cpu(), work / "replay_ids.pt")
    (work / "replay.json").write_text(json.dumps({
        "load_s": load_s, "warmup_s": graph.warmup_s, "capture_s": graph.capture_s,
        "launches": {m.__name__.rsplit(".", 1)[-1]: n for m, n in graph.launches.items()},
        "profiled_launches": prof["wrapper_launches"], "device_ms": prof["device_ms"],
        "kernels": prof["kernels"], "busy_share": prof["busy_share"],
        "replays_identical": bool(torch.equal(ids, again)),
        "engine_imported": "video_caption_tpu_torch.engine" in sys.modules,
        "jax_imported": any(m.split(".")[0] in ("jax", "video_caption_tpu") for m in sys.modules)}))
    return 0


def _ms(seconds) -> str:
    return "none" if seconds is None else f"{seconds * 1000:.1f} ms"


def _identical_share(a, b) -> float:
    """Share of the captions (S1-S3 of each result) two result lists agree on."""
    pairs = [(x[k], y[k]) for x, y in zip(a, b) for k in ("S1", "S2", "S3")]
    return sum(p == q for p, q in pairs) / len(pairs)


def _require_per_request(per_request, want, path, cold_encoder=COLD_ENCODER):
    """Each request launched ``want`` and encoder_attention ``cold_encoder``
    times if it was cold (a video-cache miss: the overlapped path's chunk
    trunks) or WARM_ENCODER times if it was warm (the pixel graph)."""
    for i, (cold, counts) in enumerate(per_request):
        exp = {**want, "encoder_attention": cold_encoder if cold else WARM_ENCODER}
        got = {name: counts[name] for name in exp}
        if got != exp:
            raise AssertionError(f"{path}: request {i} ({'cold' if cold else 'warm'}) launched "
                                 f"{got}, not {exp}")


def _cold_warm_p50(latencies, per_request):
    """p50 s of the cold and of the warm requests (None where there are none)."""
    out = {}
    for label, want in (("cold", True), ("warm", False)):
        lat = [t for t, (cold, _) in zip(latencies, per_request) if cold == want]
        out[f"{label}_p50_s"] = statistics.median(lat) if lat else None
        out[f"{label}_requests"] = len(lat)
    return out


def _timed_requests(engine, dirs, count):
    """(latencies s, results, launches of every kernel, per request (cold,
    its launches)) of ``count`` sequential requests through
    ``engine.infer``; a request is cold when its dir is not in the video
    cache before it (so it takes the overlapped path). The counts are set
    to 0 just before and read just after."""
    _reset_kernel_counts()
    latencies, results, per_request = [], [], []
    for i in range(count):
        d = dirs[i % len(dirs)]
        cold = engine._video_cache_get(d)[1] is None
        before = _kernel_counts()
        t0 = time.perf_counter()
        res = engine.infer(d)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        results.append(res.to_api_dict())
        per_request.append((cold, {n: c - before[n] for n, c in _kernel_counts().items()}))
    return latencies, results, _kernel_counts(), per_request


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
    """Phase 9: the mapper trainer through its CLI."""
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
    """Phase 10: the stage-1 joint step with pool="gap", and one step against
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


def _plain_norm_act_calls() -> int:
    from video_caption_tpu_torch.ops import norm_act

    return norm_act.plain_on_cuda


def _require_no_plain_norm_act(before: int, path: str) -> None:
    """Fails ``path`` (bf16 on the card alone) if a LayerNorm or f32 GELU
    in it took norm_act's plain version: every such call there has a bf16
    tensor and must launch the kernel."""
    n = _plain_norm_act_calls() - before
    log(f"{path}: norm_act plain_on_cuda +{n}")
    if n:
        raise AssertionError(f"{path}: {n} LayerNorm/GELU calls on the card took the plain "
                             "version")


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


def _decode_configs_phase(engine, core_cfg, dirs, default_graph, emb_gpu, emb_cpu,
                          root: Path) -> dict:
    """Phase 7: int8 weights, early stop, the split cache, the full-vocab
    chain and eval/, each driven with the counts set to 0 just before it
    and read just after."""
    from video_caption_tpu_torch.engine import InferenceEngine

    out = {}
    cfg = dataclasses.replace(core_cfg, compile=dataclasses.replace(
        core_cfg.compile, quantize_decoder_int8=True))
    int8 = InferenceEngine(cfg, params=engine.params, seed=SEED, device="cuda")
    out["int8"] = _int8_config(engine, int8, dirs[:3], default_graph, emb_gpu, emb_cpu)
    out["early_stop"] = _early_stop_config(engine, core_cfg, dirs[:3])
    out["split_cache"] = _split_cache_config(engine, core_cfg, dirs[:3])
    out["full_vocab"] = _full_vocab_config(engine, dirs[0], emb_gpu, emb_cpu)
    out["eval"] = _eval_config(engine, int8, dirs[:EVAL_VIDEOS], root)
    return out


def _block_weight_bytes(blocks) -> int:
    from video_caption_tpu_torch.models.quantize import QUANTIZED_BLOCK_WEIGHTS

    return sum(v.nbytes for k, v in blocks.items()
               if k in QUANTIZED_BLOCK_WEIGHTS or k[:-2] in QUANTIZED_BLOCK_WEIGHTS)


def _int8_config(engine, int8, dirs, default_graph, emb_gpu, emb_cpu) -> dict:
    """(a) The int8 engine: its weights on the card, its request graph beside
    its eager twin, 4 beam-3 steps against the f32 CPU path, its numbers
    beside the bf16 engine's and its beam tokens' agreement with them."""
    from video_caption_tpu_torch.models.quantize import QUANTIZED_BLOCK_WEIGHTS
    from video_caption_tpu_torch.ops import selfcheck

    blocks = int8.params["decoder"]["blocks"]
    for name in QUANTIZED_BLOCK_WEIGHTS:
        q, scale = blocks.get(name + "_q"), blocks.get(name + "_s")
        if name in blocks or q is None or q.dtype != torch.int8 \
                or q.device.type != int8.device.type or scale.dtype != torch.float32 \
                or scale.device.type != int8.device.type:
            raise AssertionError(f"the int8 engine's {name} is not int8 with f32 scales on the "
                                 f"card")
    if int8.model_cfg.gpt2.use_pallas_decode_layer:
        raise AssertionError("int8 left use_pallas_decode_layer on")
    wbytes = (_block_weight_bytes(blocks), _block_weight_bytes(engine.params["decoder"]["blocks"]))
    pair = _graph_and_eager("quantize_decoder_int8", int8, dirs, FUSED_REQUESTS)
    _require_launches(pair["graph"]["launches"], selfcheck.DEFAULT_PATH, "the int8 path")
    _require_per_request(pair["graph"]["per_request"], UNIFIED_LAUNCHES, "the int8 request")
    v = engine.model_cfg.gpt2.vocab_size
    with torch.inference_mode():
        got = _beam_decode_logits(int8.params["decoder"], int8.model_cfg.gpt2, emb_gpu)
        want = _beam_decode_logits(_f32_cpu(int8.params["decoder"]),
                                   _f32(int8.model_cfg).gpt2, emb_cpu)
    err = rel_err(got[..., :v], want[..., :v])
    finite = bool(torch.isfinite(got[..., :v]).all())
    video = engine.load_video(dirs[2])
    same = total = 0
    for (dp, *_), a, b in zip(engine._decode_groups(), engine.request_ids(video),
                              int8.request_ids(video)):
        if dp.num_beams > 1:
            same, total = same + int((a == b).sum()), total + a.size
    g = pair["graph"]
    log(f"int8: block weights {wbytes[0] / 2**20:.1f} MiB int8 + f32 scales on the card "
        f"(bf16 {wbytes[1] / 2**20:.1f} MiB), use_pallas_decode_layer off; graph p50 "
        f"{g['p50_s'] * 1000:.1f} ms (bf16 {default_graph['p50_s'] * 1000:.1f}), replay "
        f"{g['replay_ms']:.2f} ms (bf16 {default_graph['replay_ms']:.2f}), device "
        f"{g['replay_device_ms']:.2f} ms (bf16 {default_graph['replay_device_ms']:.2f}), "
        f"{g['replay_kernels']} kernels (bf16 {default_graph['replay_kernels']}), "
        f"max_memory_allocated {g['peak_bytes'] / 2**20:.0f} MiB (bf16 "
        f"{default_graph['peak_bytes'] / 2**20:.0f}), added by the requests "
        f"{g['peak_added_bytes'] / 2**20:.0f} MiB (bf16 "
        f"{default_graph['peak_added_bytes'] / 2**20:.0f}); {DECODE_STEPS} beam-{BEAMS} steps' "
        f"logits vs the same int8 weights in f32 on the CPU rel err {err:.3e} (bound "
        f"{INT8_REL_TOL:g}), finite {finite}; beam tokens equal to the bf16 engine's "
        f"{same}/{total} (information)")
    if not (finite and err < INT8_REL_TOL):
        raise AssertionError("the int8 beam steps disagree with the f32 plain path")
    return {**pair, "block_weight_bytes": wbytes[0], "bf16_block_weight_bytes": wbytes[1],
            "beam_steps_rel_err": err, "beam_tokens_equal_bf16": [same, total]}


def _steps_run(engine, prefix, dp, ids, mask):
    """(ids, decode steps run) of one group: lm_head launches once for the
    prefill and once a step."""
    from video_caption_tpu_torch.ops import lm_head

    before = lm_head.launches
    out = engine.run_decode_group(prefix, dp, ids, mask).cpu()
    return out, lm_head.launches - before - 1


def _early_stop_config(engine, core_cfg, dirs) -> dict:
    """(b) Early stop: requests served eagerly with the results of a
    full-length eager engine; the beam group and a greedy group with the
    ids of their full-length loops and the steps each ran."""
    from video_caption_tpu_torch.engine import InferenceEngine
    from video_caption_tpu_torch.ops import selfcheck

    engines = {}
    # the full-length engine decodes group by group, as early stop does
    # (the unified loop would run other row counts)
    for name, kw in (("early_stop", {"early_stop_decode": True}),
                     ("full", {"aot_request_program": False, GROUPED: False})):
        engines[name] = InferenceEngine(dataclasses.replace(core_cfg, compile=dataclasses.replace(
            core_cfg.compile, **kw)), params=engine.params, seed=SEED, device="cuda")
    es = engines["early_stop"]
    if es._serves_on_program(torch.zeros((1, NUM_FRAMES, 3, IMAGE_SIZE, IMAGE_SIZE),
                                         dtype=torch.uint8, device="cuda")):
        raise AssertionError("an early-stop request took the captured graph")
    runs = {}
    for name, eng in engines.items():
        eng.warmup()
        runs[name] = _timed_requests(eng, dirs, FUSED_REQUESTS)
    _require_launches(runs["early_stop"][2], selfcheck.DEFAULT_PATH, "the early-stop path")
    if not all(cold for r in runs.values() for cold, _ in r[3]):
        raise AssertionError("an early-stop comparison request was not cold")
    if runs["early_stop"][1] != runs["full"][1]:
        raise AssertionError(f"early stop changed the results: {runs['early_stop'][1]} vs "
                             f"{runs['full'][1]}")
    prefix = es.compute_prefix(es.load_video(dirs[0]))
    beam_dp, _, ids, mask = next(g for g in es._decode_groups() if g[0].num_beams > 1)
    greedy = dataclasses.replace(beam_dp, num_beams=1, early_stop=False)
    # a greedy group whose EOS is a token its first row reaches after
    # min_new_tokens, so the loop can end early
    ids1, mask1 = ids[:1], mask[:1]
    eos = int(es.run_decode_group(prefix, greedy, ids1, mask1)[0, greedy.min_new_tokens])
    steps = {}
    for label, dp, gi, gm in (("beam", beam_dp, ids, mask),
                              ("greedy", dataclasses.replace(greedy, eos_id=eos), ids1, mask1)):
        full, n_full = _steps_run(es, prefix, dataclasses.replace(dp, early_stop=False), gi, gm)
        stop, n_stop = _steps_run(es, prefix, dataclasses.replace(dp, early_stop=True), gi, gm)
        if not torch.equal(full, stop):
            raise AssertionError(f"early stop changed the {label} group's ids")
        steps[label] = {"steps": n_stop, "full_steps": n_full, "eos_id": dp.eos_id}
    p50 = {name: statistics.median(r[0]) * 1000 for name, r in runs.items()}
    log(f"early stop: requests eager, results equal to the full-length eager engine's over "
        f"{FUSED_REQUESTS} requests; p50 {p50['early_stop']:.1f} ms (full length "
        f"{p50['full']:.1f}); beam-{beam_dp.num_beams} group ids equal, "
        f"{steps['beam']['steps']} of {steps['beam']['full_steps']} decode steps run; greedy "
        f"group (EOS = token {eos}) ids equal, {steps['greedy']['steps']} of "
        f"{steps['greedy']['full_steps']} steps run")
    return {"p50_ms": p50, "latencies_s": {n: r[0] for n, r in runs.items()},
            "launches": runs["early_stop"][2], "steps": steps}


def _group_ms(engine, prefix, dp, ids, mask, runs=3):
    """(median wall ms of ``runs`` synchronised calls, one call's profile)
    of one group decoded eagerly, each from a generator seeded alike."""
    from video_caption_tpu_torch.cli.profile_request import profile_call

    def call():
        return engine.run_decode_group(prefix, dp, ids, mask,
                                       generator=torch.Generator("cuda").manual_seed(SEED))

    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000)
    return statistics.median(times), profile_call(call)


def _split_cache_config(engine, core_cfg, dirs) -> dict:
    """(c) The split cache: an engine decoding group by group on its graph
    beside its eager twin; the natural group's ids and device ms on the
    split and the contiguous cache, one seed."""
    from video_caption_tpu_torch.engine import InferenceEngine
    from video_caption_tpu_torch.ops import selfcheck

    split = InferenceEngine(dataclasses.replace(core_cfg, compile=dataclasses.replace(
        core_cfg.compile, sample_split_cache=True, **{GROUPED: False})), params=engine.params,
        seed=SEED, device="cuda")
    if not split.model_cfg.gpt2.sample_split_cache:
        raise AssertionError("the engine dropped sample_split_cache")
    pair = _graph_and_eager("sample_split_cache", split, dirs, FUSED_REQUESTS)
    _require_launches(pair["graph"]["launches"], selfcheck.DEFAULT_PATH, "the split-cache path")
    prefix = engine.compute_prefix(engine.load_video(dirs[0]))
    dp, _, ids, mask = next(g for g in engine._decode_groups() if g[0].do_sample)
    res = {}
    for name, eng in (("split", split), ("contiguous", engine)):
        with torch.inference_mode():
            tokens = eng.run_decode_group(prefix, dp, ids, mask,
                                          generator=torch.Generator("cuda").manual_seed(SEED))
        ms, prof = _group_ms(eng, prefix, dp, ids, mask)
        res[name] = {"ids": tokens.cpu(), "ms": ms, "device_ms": prof["device_ms"],
                     "kernels": prof["kernels"]}
    agree = float((res["split"]["ids"] == res["contiguous"]["ids"]).float().mean())
    log(f"split cache: graph ids equal its eager twin's; natural group ids agreement with the "
        f"contiguous cache {agree:.1%}; device {res['split']['device_ms']:.2f} ms in "
        f"{res['split']['kernels']} kernels (contiguous {res['contiguous']['device_ms']:.2f} ms "
        f"in {res['contiguous']['kernels']}), eager {res['split']['ms']:.1f} ms (contiguous "
        f"{res['contiguous']['ms']:.1f})")
    for r in res.values():
        r["ids"] = r["ids"].tolist()
    return {**pair, "natural_group": res, "ids_agreement": agree}


def _processed(logits, dp, beams: bool):
    """The full-vocab chain over DECODE_STEPS steps' logits [S, R, Vp]
    (log-softmax first for beams), the steps' fed tokens as the generated
    buffer."""
    from video_caption_tpu_torch.decode import generate as gen

    steps, rows, _ = logits.shape
    fed = torch.tensor((32, 97, 32, 109)[:steps], device=logits.device)
    generated = (fed[None] + torch.arange(rows, device=logits.device)[:, None] % BEAMS
                 if beams else fed[None].expand(rows, steps)).long()
    out = []
    for t in range(steps):
        x = torch.log_softmax(logits[t].float(), dim=-1) if beams else logits[t].float()
        out.append(gen._process_logits(x, generated, t + 1, dp))
    return torch.stack(out)


def _finite_rel_err(got, want) -> float:
    """rel_err over the finite scores; the -inf (banned, padded) ones must agree."""
    got, want = got.float().cpu(), want.float().cpu()
    if not torch.equal(torch.isneginf(got), torch.isneginf(want)):
        raise AssertionError("the processed scores ban other tokens on the card")
    keep = torch.isfinite(want)
    return rel_err(torch.where(keep, got, 0.0), torch.where(keep, want, 0.0))


def _full_vocab_config(engine, frames_dir, emb_gpu, emb_cpu) -> dict:
    """(d) The full-vocab chain: precise with repetition_penalty 0.9 and
    natural with top_k 0 through generate_once and run_decode_group beside
    their candidate-path policies; one unified decode mixing them with
    precise, captured into a graph; 4 steps' processed scores of the beam
    and K=1 steps against the f32 CPU path."""
    from video_caption_tpu_torch.aot import RequestGraph
    from video_caption_tpu_torch.decode import unified
    from video_caption_tpu_torch.decode.presets import preset_to_kwargs
    from video_caption_tpu_torch.engine import _pack
    from video_caption_tpu_torch.ops import selfcheck

    _reset_kernel_counts()
    prefix = engine.compute_prefix(engine.load_video(frames_dir))
    groups = {("natural" if g[0].do_sample else "precise"): g for g in engine._decode_groups()}
    res = {}
    for name, over in FULL_VOCAB.items():
        dp, _, ids, mask = groups[name]
        fv = dataclasses.replace(dp, **over)
        row = {}
        for path, policy in (("full_vocab", fv), ("candidate", dp)):
            t0 = time.perf_counter()
            text = engine.generate_once(prefix, NATURAL[1] if name == "natural" else "",
                                        **{**preset_to_kwargs(name),
                                           **(over if policy is fv else {})})
            torch.cuda.synchronize()
            once_ms = (time.perf_counter() - t0) * 1000
            ms, prof = _group_ms(engine, prefix, policy, ids, mask)
            row[path] = {"generate_once_ms": once_ms, "text": text, "group_ms": ms,
                         "group_device_ms": prof["device_ms"], "group_kernels": prof["kernels"]}
        res[name] = {"policy": over, **row}
        log(f"full vocab {name} {over}: group {row['full_vocab']['group_ms']:.1f} ms eager, "
            f"{row['full_vocab']['group_device_ms']:.2f} ms device in "
            f"{row['full_vocab']['group_kernels']} kernels (candidate path "
            f"{row['candidate']['group_ms']:.1f} ms, {row['candidate']['group_device_ms']:.2f} ms "
            f"in {row['candidate']['group_kernels']}); generate_once "
            f"{row['full_vocab']['generate_once_ms']:.1f} ms (candidate "
            f"{row['candidate']['generate_once_ms']:.1f}): {row['full_vocab']['text']!r}")

    # one unified decode: both full-vocab policies and the candidate-path precise
    prompts, dps = [], []
    for name, over in list(FULL_VOCAB.items()) + [("precise", {})]:
        dp, _, ids, mask = groups[name]
        prompts.append((ids, mask))
        dps.append(dataclasses.replace(dp, **over))
    params, mc = engine.params, engine.model_cfg

    def program(gen):
        def run(p):
            with torch.inference_mode():
                return _pack(unified.generate_unified(params["decoder"], mc.gpt2, p, prompts,
                                                      dps, gen))
        return run

    graph_gen = torch.Generator("cuda").manual_seed(SEED)
    graph = RequestGraph.capture(program(graph_gen), prefix, (graph_gen,))
    replayed = graph.replay(prefix).clone()
    eager = program(torch.Generator("cuda").manual_seed(SEED))(prefix)
    sizes = [len(ids) * dp.max_new_tokens for (ids, _), dp in zip(prompts, dps)]
    parts = list(zip(dps, replayed.split(sizes), eager.split(sizes)))
    if not all(torch.equal(a, b) for dp, a, b in parts if not dp.do_sample):
        raise AssertionError("the captured unified decode's beam ids differ from its eager run")
    sampled_same = [bool(torch.equal(a, b)) for dp, a, b in parts if dp.do_sample]
    launches = _kernel_counts()
    _require_launches(launches, ("lm_head", "beam_attention"), "the full-vocab policies")

    v = mc.gpt2.vocab_size
    cpu_dec = _f32_cpu(params["decoder"])
    errs = {}
    with torch.inference_mode():
        for label, run, name in (("beam", _beam_decode_logits, "precise"),
                                 ("greedy", _decode_logits, "precise")):
            dp = dataclasses.replace(groups[name][0], **FULL_VOCAB[name])
            if label == "greedy":
                dp = dataclasses.replace(dp, num_beams=1)
            beams = label == "beam"
            got = _processed(run(params["decoder"], mc.gpt2, emb_gpu), dp, beams)
            want = _processed(run(cpu_dec, _f32(mc).gpt2, emb_cpu), dp, beams)
            errs[label] = _finite_rel_err(got[..., :v], want[..., :v])
    log(f"full vocab: unified decode of repetition_penalty {[d.repetition_penalty for d in dps]}"
        f", top_k {[d.top_k for d in dps]} captured (capture {graph.capture_s:.2f} s), "
        f"beam ids equal to its eager run, sampled ids equal {sampled_same}; {DECODE_STEPS} "
        f"steps' processed scores vs f32 on the CPU: beam-{BEAMS} (log-softmax, rep. 0.9) rel "
        f"err {errs['beam']:.3e}, K=1 {errs['greedy']:.3e} (bound {REL_TOL:g}); launches "
        f"{launches}")
    if not all(e < REL_TOL for e in errs.values()):
        raise AssertionError("the full-vocab chain disagrees with the f32 plain path")
    return {"groups": res, "unified_capture_s": graph.capture_s,
            "unified_sampled_ids_equal": sampled_same, "processed_rel_err": errs,
            "launches": launches}


def _eval_config(engine, int8, dirs, root: Path) -> dict:
    """(e) eval/: the ablation grid over the annotated videos with the bf16
    engine and eval_compare between the bf16 and int8 engines; the
    beam-attention wrapper's count by beam count must show K=5."""
    from video_caption_tpu_torch.eval import ablate_decode, eval_compare
    from video_caption_tpu_torch.ops import beam_attention, selfcheck

    ann = root / "eval_annotations.json"
    ann.write_text(json.dumps([
        {"video_id": f"video{v}", "frames_dir": d,
         "captions": [CAPTIONS[(v + i) % len(CAPTIONS)] for i in range(3)]}
        for v, d in enumerate(dirs)]))
    _reset_kernel_counts()
    before = dict(beam_attention.launches_by_beams)
    t0 = time.perf_counter()
    rows = ablate_decode.ablate(str(ann), str(root / "ablate.csv"), limit=len(dirs),
                                num_frames=NUM_FRAMES, grid=EVAL_GRID, image_size=IMAGE_SIZE,
                                engine=engine)
    ablate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    summary = eval_compare.compare(str(ann), "", "", str(root / "eval_compare"), limit=len(dirs),
                                   num_frames=NUM_FRAMES, image_size=IMAGE_SIZE,
                                   engines=(engine, int8))
    compare_s = time.perf_counter() - t0
    launches = _kernel_counts()
    by_beams = {k: n - before.get(k, 0) for k, n in beam_attention.launches_by_beams.items()
                if n != before.get(k, 0)}
    _require_launches(launches, selfcheck.DEFAULT_PATH, "eval/")
    with (root / "eval_compare" / "results.csv").open() as fh:
        results = list(csv.reader(fh))
    for row in rows:
        log(f"eval ablate {row}")
    for row in results:
        log(f"eval compare {row}")
    log(f"eval: ablate {len(rows)} grid points x {len(dirs)} videos in {ablate_s:.1f} s, compare "
        f"bf16 vs int8 in {compare_s:.1f} s, summary {json.dumps(summary)}; beam_attention "
        f"launches by beam count {by_beams}; launches {launches} (random weights: the BLEU "
        f"means nothing)")
    if not by_beams.get(5) or len(results) != len(dirs) + 1:
        raise AssertionError(f"eval did not run beam_attention at K=5 over every video: "
                             f"{by_beams}, {results}")
    return {"ablate": rows, "compare": summary, "results_csv": results, "ablate_s": ablate_s,
            "compare_s": compare_s, "beam_attention_by_beams": by_beams, "launches": launches}


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
        frontend = _frontend_checks(server.port, payload, dirs)
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
            "warmed_before_round_2": warmed, "frontend": frontend}


def _frontend_checks(port, payload, dirs) -> dict:
    """Phase 11's frontend: the port's REST client (``frontend/api_client``,
    its ``BACKEND_URL`` set to the running server) and the chat handler
    (``frontend/chainlit_app.handle_message``) against the server. The
    client's requests carry the phase's payload fields, so they reach the
    phase's engine; the handler's go through its module's ``infer_caption``
    bound to them. Every answer must be well formed."""
    import functools
    import importlib.util

    from video_caption_tpu_torch.frontend import api_client, chainlit_app

    t0 = time.perf_counter()
    fields = {k: v for k, v in payload(dirs[0]).items() if k != "frames_dir"}
    api_client.BACKEND_URL = f"http://127.0.0.1:{port}"
    healthy = api_client.check_health()
    body = api_client.infer_caption(dirs[1], **fields)
    _check_result(body)
    try:
        api_client.infer_caption(str(Path(dirs[0]).parent / "no-such-dir"), **fields)
        error = None
    except api_client.BackendError as err:
        error = str(err)
    unbound = chainlit_app.infer_caption
    chainlit_app.infer_caption = functools.partial(api_client.infer_caption, **fields)
    try:
        reply = chainlit_app.handle_message(f' "{dirs[2]}" ')
        missing = chainlit_app.handle_message(str(Path(dirs[0]).parent / "no-such-dir"))
    finally:
        chainlit_app.infer_caption = unbound
    seconds = time.perf_counter() - t0
    transport = "httpx" if importlib.util.find_spec("httpx") else "urllib"
    log(f"server frontend ({transport}): check_health {healthy}; infer_caption "
        f"{json.dumps(body)}; a missing dir -> BackendError {error!r}; handle_message "
        f"{reply!r}, on a missing dir {missing!r}; {seconds:.2f} s")
    lines = reply.splitlines()
    well_formed = (len(lines) == 5 and re.match(r"\*\*BEST \(S[123]\):\*\* \S", lines[0])
                   and all(re.match(rf"- S{i}: \S", line) for i, line in enumerate(lines[2:], 1)))
    if not (healthy and error and error.startswith("backend error 400: ") and well_formed
            and "is not a directory" in missing):
        raise AssertionError(f"the frontend's answers are not well formed: health {healthy}, "
                             f"error {error!r}, reply {reply!r}, missing {missing!r}")
    return {"healthy": healthy, "result": body, "error": error, "reply": reply,
            "transport": transport, "seconds": seconds}


def _quality_loop_phase(root: Path) -> dict:
    """Phase 14: the quality loop, cut to size, then the tools over its
    checkpoint directory."""
    from video_caption_tpu_torch.config import default_inference_config
    from video_caption_tpu_torch.engine import InferenceEngine
    from video_caption_tpu_torch.tools import (batch_bestof, batch_infer, export_checkpoint,
                                               human_eval, quality_loop)

    out, data = root / "quality_loop", root / "quality_loop_data"
    phase_t0 = time.perf_counter()
    log(f"quality loop: ViT-B/16 at {IMAGE_SIZE} px, {QUALITY_LOOP_FRAMES} frames, GPT-2 124M; "
        f"scale cut to {' '.join(QUALITY_LOOP_ARGS)}, ablation grid {QUALITY_LOOP_GRID}")
    _reset_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = quality_loop.main(["--root", str(data), "--out_dir", str(out), "--image_size",
                            str(IMAGE_SIZE), "--num_frames", str(QUALITY_LOOP_FRAMES),
                            *QUALITY_LOOP_ARGS, "--device", "cuda"], ablate_grid=QUALITY_LOOP_GRID)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    result = json.loads((out / "quality_loop.json").read_text())
    summary = json.loads(result["eval_compare_summary"])
    losses = {"stage3": result["stage3_lm_loss"], "mapper": result["mapper_loss"],
              "align": result["align_loss"]}
    stage_s = result["stage_s"]
    log(f"quality loop: rc {rc}, {wall:.1f} s; stages "
        + ", ".join(f"{k} {v:.1f} s" for k, v in stage_s.items()))
    log("quality loop: losses " + ", ".join(f"{k} {v['first']:.4f} -> {v['last']:.4f}"
                                            for k, v in losses.items())
        + f"; mapper best val {result['mapper']['best_val']:.4f}")
    log(f"quality loop: BLEU A (trained) {summary['corpus_bleu_a']:.3f}, B (random) "
        f"{summary['corpus_bleu_b']:.3f} over {summary['num_samples']} videos; ablation top "
        f"{result['ablate_top']}")
    for name in ("trained", "random"):
        m = result["retrieval"][name]
        log(f"quality loop: retrieval {name} recall@1 {m['recall@1']:.4f} recall@5 "
            f"{m['recall@5']:.4f} mrr {m['mrr']:.4f} over {m['num_queries']} queries")
    log(f"quality loop: launches over main {launches}; peak device memory "
        f"{peak / 2**20:.0f} MiB; device {result['device']}")
    _require_launches(launches, QUALITY_LOOP_KERNELS, "the quality loop")
    finite = [v[k] for v in losses.values() for k in ("first", "last")]
    if not (rc == 0 and all(x is not None and math.isfinite(x) for x in finite)
            and math.isfinite(result["mapper"]["best_val"])):
        raise AssertionError(f"the quality loop's losses are not all finite: {losses}")
    if not losses["stage3"]["last"] < losses["stage3"]["first"]:
        raise AssertionError(f"the stage-3 loss did not fall: {losses}")
    if result["retrieval"]["trained"] is None:
        raise AssertionError("the quality loop wrote no trained retrieval result")
    t0 = time.perf_counter()
    *_, align_losses = quality_loop.train_align(
        str(data / "train" / "annotations.json"), QUALITY_LOOP_FRAMES, IMAGE_SIZE,
        max_steps=QUALITY_LOOP_ALIGN_STEPS, lr=QUALITY_LOOP_ALIGN_LR, device="cuda")
    align_s = time.perf_counter() - t0
    log(f"quality loop: train_align at Adam {QUALITY_LOOP_ALIGN_LR:g} over the same records, "
        f"{QUALITY_LOOP_ALIGN_STEPS} steps in {align_s:.1f} s: loss {align_losses[0]:.4f} -> "
        f"{align_losses[-1]:.4f} (ln 8 = {math.log(8):.4f})")
    if not (all(math.isfinite(x) for x in align_losses) and align_losses[-1] < align_losses[0]):
        raise AssertionError(f"the align loss did not fall at Adam {QUALITY_LOOP_ALIGN_LR:g}: "
                             f"{align_losses}")

    # the trainer's directory, served as it is and through its export
    ckpt, exported = out / "ckpt_mapper", root / "quality_loop_export.pt"
    if export_checkpoint.main(["--ckpt", str(ckpt), "--out", str(exported),
                               "--num_frames", str(QUALITY_LOOP_FRAMES)]) != 0:
        raise AssertionError("export_checkpoint failed")
    cfg = default_inference_config(ckpt=str(ckpt), num_frames=QUALITY_LOOP_FRAMES,
                                   image_size=IMAGE_SIZE)
    from_dir = InferenceEngine(cfg, seed=SEED, device="cuda")
    from_pt = InferenceEngine(dataclasses.replace(cfg, ckpt=str(exported)), seed=SEED,
                              device="cuda")
    pt_leaves = list(_leaves(from_pt.params))
    same_params = all(torch.equal(a, b) for a, b in zip(_leaves(from_dir.params), pt_leaves)) \
        and len(pt_leaves) == len(list(_leaves(from_dir.params)))
    val_ann = data / "val" / "annotations.json"
    val = json.loads(val_ann.read_text())
    video = from_dir.load_video(val[0]["frames_dir"])
    s1_dir, s1_pt = from_dir.request_ids(video)[0][0], from_pt.request_ids(video)[0][0]
    log(f"quality loop: engine over the directory vs over its export: parameters identical "
        f"{same_params}, S1 ids identical {bool((s1_dir == s1_pt).all())} ({s1_dir.tolist()})")
    if not (same_params and (s1_dir == s1_pt).all()):
        raise AssertionError("the engine over the trainer's directory disagrees with the engine "
                             "over its exported .pt")
    del from_pt
    hybrid = _hybrid_checks(from_dir, [v["frames_dir"] for v in val[:HYBRID_VIDEOS]])
    del from_dir
    t0 = time.perf_counter()
    rows = batch_infer.batch_infer(str(val_ann), str(root / "quality_loop_batch.csv"),
                                   ckpt=str(ckpt), num_frames=QUALITY_LOOP_FRAMES, batch_size=2,
                                   device="cuda")
    batch_s = time.perf_counter() - t0
    best = batch_bestof.bestof_from_rows(rows)
    for row, pick in zip(rows, best):
        log(f"quality loop: batch_infer {row['video_id']}: S1 {row['S1']!r} S2 {row['S2']!r} "
            f"S3 {row['S3']!r} best {row['best_key']} (ref {row['ref_caption']!r}); best-of "
            f"{pick['caption']!r}")
    t0 = time.perf_counter()
    questionnaire_csv = root / "quality_loop_questionnaire.csv"
    if human_eval.main(["--results_csv", str(root / "quality_loop_batch.csv"),
                        "--out", str(questionnaire_csv)]) != 0:
        raise AssertionError("human_eval failed")
    with questionnaire_csv.open() as fh:
        questionnaire = list(csv.DictReader(fh))
    human_s = time.perf_counter() - t0
    captioned = sorted(r["video_id"] for r in rows if r["best_text"])
    log(f"quality loop: human_eval questionnaire of {len(questionnaire)} rows over the "
        f"{len(rows)} batch_infer rows in {human_s:.2f} s: "
        f"{[(r['video_id'], r['caption']) for r in questionnaire]}")
    phase_s = time.perf_counter() - phase_t0
    log(f"quality loop: batch_infer over {len(rows)} val videos at batch 2 in {batch_s:.1f} s "
        f"(engine build and graph captures included); the phase {phase_s:.1f} s")
    if len(rows) != len(val) or not all(
            p["caption"] in (r["S1"], r["S2"], r["S3"]) for r, p in zip(rows, best)):
        raise AssertionError(f"batch_infer / batch_bestof did not caption every val video: "
                             f"{rows}, {best}")
    if sorted(r["video_id"] for r in questionnaire) != captioned or not all(
            r["caption"] for r in questionnaire):
        raise AssertionError(f"the questionnaire does not hold one row per sampled video: "
                             f"{questionnaire}")
    return {"rc": rc, "wall_s": wall, "phase_s": phase_s, "stage_s": stage_s, "losses": losses,
            "bleu": summary, "retrieval": result["retrieval"], "ablate_top": result["ablate_top"],
            "launches": launches, "peak_bytes": peak, "batch_infer_rows": rows, "bestof": best,
            "batch_infer_s": batch_s, "align_at_low_rate": {"lr": QUALITY_LOOP_ALIGN_LR,
                                                            "losses": align_losses,
                                                            "seconds": align_s},
            "hybrid": hybrid, "questionnaire": questionnaire, "human_eval_s": human_s}


class _CountingFallback:
    """A fallback captioner that counts its calls and answers a caption the
    gate passes."""
    name = "counting-stub"
    text = "A person is moving a shape across the frame."

    def __init__(self):
        self.calls = 0

    def __call__(self, frames_dir):
        self.calls += 1
        return self.text


class _JunkDecodes:
    """The engine's tokenizer with a word the gate takes for boilerplate in
    front of every decode: candidates that fail the gate, so that both
    fallbacks are reached on the card."""

    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def decode(self, ids, skip_special_tokens=True):
        return "youtube " + self.inner.decode(ids, skip_special_tokens=skip_special_tokens)


def _hybrid_checks(engine, dirs) -> dict:
    """Phase 14's hybrid inference: ``tools/hybrid_infer.hybrid_caption``
    through ``engine`` (the mapper's checkpoint directory, full width) on
    ``dirs``, after ``engine.warmup()`` (its graphs' captures, as in phase
    4). Each dir's first request is ``engine.infer`` (cold where the video
    is not in the device cache yet); then hybrid_caption with a counting stub
    fallback, ``infer`` again (S1 and S2 must equal the hybrid's: the same
    warm program), and hybrid_caption with ``make_blip_fallback()``; BEST
    and USED must be what ``is_bad_caption`` of the candidates decides, and a
    BLIP fallback that was called must read ``fallback_failed:`` (the card's
    machine has no weights, and the hub is kept offline).
    Then both fallbacks once more on candidates that fail the gate. The
    kernels' counts are read around each request and must be the unified
    request's."""
    from video_caption_tpu_torch.tools import caption_fallback, hybrid_infer

    # the BLIP fallback names a hub model: where transformers is installed
    # it must fail on the missing weights and never reach for the hub (set
    # before huggingface_hub is first imported; main sets it first thing)
    os.environ["HF_HUB_OFFLINE"] = os.environ["TRANSFORMERS_OFFLINE"] = "1"
    t0 = time.perf_counter()
    warmup_s = engine.warmup()
    blip = caption_fallback.make_blip_fallback()
    per_request, timed, out = [], [], []

    def request(kind, call, d):
        cold = engine._video_cache_get(d)[1] is None
        before = _kernel_counts()
        start = time.perf_counter()
        res = call(d)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - start) * 1000
        timed.append({"kind": kind, "cold": cold, "ms": ms})
        per_request.append((cold, {n: c - before[n] for n, c in _kernel_counts().items()}))
        return res

    def expect(res, fallback, taken_text):
        """BEST and USED as the gate decides them from the candidates."""
        key, text = hybrid_infer.pick_best_from_ours(res)
        bad, reason = hybrid_infer.is_bad_caption(text)
        used = {"source": "ours", "detail": key, "fallback_reason": ""}
        if bad or key == "NONE":
            if taken_text is not None:
                text = taken_text
                used = {"source": "fallback", "detail": fallback.name, "fallback_reason": reason}
            else:
                used["fallback_reason"] = res["USED"]["fallback_reason"]
                if not used["fallback_reason"].startswith("fallback_failed:"):
                    raise AssertionError(f"the BLIP fallback did not report its failure: {res}")
        if res["BEST"] != {"key": key, "text": text} or res["USED"] != used:
            raise AssertionError(f"hybrid_caption's BEST/USED disagree with the gate: {res}")
        return bad or key == "NONE"

    for d in dirs:
        request("infer", engine.infer, d)
        stub = _CountingFallback()
        res = request("hybrid stub", lambda x: hybrid_infer.hybrid_caption(x, engine, stub), d)
        ours = request("infer", lambda x: engine.infer(x).to_api_dict(), d)
        if (res["S1"], res["S2"]) != (ours["S1"], ours["S2"]):
            raise AssertionError(f"hybrid_caption's S1/S2 differ from infer's: {res} vs {ours}")
        failed = expect(res, stub, stub.text)
        if stub.calls != failed:
            raise AssertionError(f"the stub fallback was called {stub.calls} times, the gate "
                                 f"failed {failed}")
        res_blip = request("hybrid blip", lambda x: hybrid_infer.hybrid_caption(x, engine, blip),
                           d)
        expect(res_blip, blip, None)
        out.append({"frames_dir": d, "stub": res, "blip": res_blip, "infer": ours})
    tokenizer = engine.tokenizer
    engine.tokenizer = _JunkDecodes(tokenizer)
    try:
        stub = _CountingFallback()
        junk = [request(f"hybrid {kind} (gate fails)",
                        lambda x, fb=fb: hybrid_infer.hybrid_caption(x, engine, fb), dirs[0])
                for kind, fb in (("stub", stub), ("blip", blip))]
    finally:
        engine.tokenizer = tokenizer
    if not (expect(junk[0], stub, stub.text) and expect(junk[1], blip, None) and stub.calls == 1):
        raise AssertionError(f"candidates that fail the gate did not reach the fallbacks: {junk}")
    seconds = time.perf_counter() - t0
    cold_encoder = 12 * -(-QUALITY_LOOP_FRAMES // CHUNK)
    _require_per_request(per_request, UNIFIED_LAUNCHES, "hybrid_caption's requests",
                         cold_encoder=cold_encoder)
    for o in out:
        log(f"hybrid: {Path(o['frames_dir']).name}: stub {json.dumps(o['stub'])}; blip USED "
            f"{json.dumps(o['blip']['USED'])}")
    log(f"hybrid: on candidates that fail the gate: stub USED {json.dumps(junk[0]['USED'])}, "
        f"blip USED {json.dumps(junk[1]['USED'])}")
    log(f"hybrid: {len(per_request)} requests, each launching {UNIFIED_LAUNCHES} and "
        f"encoder_attention {cold_encoder} (cold) or {WARM_ENCODER} (warm); ms a request: "
        + ", ".join(f"{r['kind']}{' (cold)' if r['cold'] else ''} {r['ms']:.3f}" for r in timed)
        + f"; {seconds:.2f} s, the engine's warm-up {warmup_s:.2f} s of it")
    return {"videos": out, "junk": junk, "requests": timed, "seconds": seconds,
            "warmup_s": warmup_s, "per_request": per_request}


def _bench_phase(engine, dirs, root: Path) -> dict:
    """Phase 12: the measurement stack at full width (see the module
    docstring); the kernel counts set to 0 before it and read after."""
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


def _frame_path_phase(engine, dirs, root: Path, cpu_params, cpu_cfg) -> dict:
    """Phase 12: the cold request's frame path, the packed training wire and
    the retrieval entry points, each driven with the counts set to 0 just
    before it and read just after."""
    import numpy as np

    from video_caption_tpu_torch.bench.roofline import measure_training_step
    from video_caption_tpu_torch.engine import InferenceEngine
    from video_caption_tpu_torch.models import caption_model as cm
    from video_caption_tpu_torch.native import loader
    from video_caption_tpu_torch.ops import selfcheck
    from video_caption_tpu_torch.preprocessing import frame_loader
    from video_caption_tpu_torch.preprocessing.yuv420 import (packed_plane_len,
                                                              yuv420_packed_to_rgb_chw,
                                                              yuv420_packed_to_rgb_chw_np)
    from video_caption_tpu_torch.retrieval import eval_retrieval, features, index

    out = {}
    # (a) the wire: which one a packed load takes here, and the conversion
    # on the card against its CPU mirror, bit for bit
    kind, packed = frame_loader.load_video_packed(dirs[0], NUM_FRAMES, IMAGE_SIZE)
    wire = {"kind": kind, "last_backend": loader.last_backend,
            "last_error": (loader.last_error or "")[-300:] or None}
    for size in (IMAGE_SIZE, 223):
        planes = np.random.RandomState(size).randint(
            0, 256, (NUM_FRAMES, packed_plane_len(size)), dtype=np.uint8)
        planes[0], planes[1] = 0, 255                    # the clip at both ends
        dev = torch.from_numpy(planes).cuda()
        same = torch.equal(yuv420_packed_to_rgb_chw(dev, size).cpu(),
                           torch.from_numpy(yuv420_packed_to_rgb_chw_np(planes, size)))
        ms = selfcheck.median_ms(lambda: yuv420_packed_to_rgb_chw(dev, size))
        wire[f"conversion_{size}"] = {"bit_equal": same, "device_ms": ms}
        if not same:
            raise AssertionError(f"the 4:2:0 conversion at {size} differs on the card from the "
                                 f"CPU mirror")
    if kind == "yuv420":
        picks = frame_loader.sample_frame_paths(frame_loader.list_frames(dirs[0]), NUM_FRAMES)
        want = np.stack([frame_loader.load_image_u8(f, IMAGE_SIZE) for f in picks])
        got = yuv420_packed_to_rgb_chw(torch.from_numpy(packed).cuda(), IMAGE_SIZE)
        wire["whole_wire_bit_equal_to_pil"] = bool(np.array_equal(got.cpu().numpy(), want))
        if not wire["whole_wire_bit_equal_to_pil"]:
            raise AssertionError("the 4:2:0 wire differs from PIL on the card")
    log(f"frame path: a packed load took the {kind} wire (native loader: last_backend "
        f"{wire['last_backend']}, last_error {wire['last_error']}); 4:2:0 conversion of "
        f"[{NUM_FRAMES}, packed_plane_len] on the card bit-equal to the CPU mirror at "
        f"{IMAGE_SIZE} ({wire[f'conversion_{IMAGE_SIZE}']['device_ms']:.4f} ms) and 223 "
        f"({wire['conversion_223']['device_ms']:.4f} ms); whole wire against PIL: "
        f"{wire.get('whole_wire_bit_equal_to_pil', 'not run (no native loader)')}")
    out["wire"] = wire

    # (b) cold requests (the video cache off) with the overlapped path on
    # and off, and the two request programs on one video
    saved = os.environ.get("VIDEO_CAPTION_VIDEO_CACHE_MB")
    os.environ["VIDEO_CAPTION_VIDEO_CACHE_MB"] = "0"
    try:
        cold = {on: InferenceEngine(dataclasses.replace(engine.config, compile=dataclasses.replace(
            engine.config.compile, overlap_single_upload=on)), params=engine.params, seed=SEED,
            device="cuda") for on in (True, False)}
    finally:
        if saved is None:
            os.environ.pop("VIDEO_CAPTION_VIDEO_CACHE_MB")
        else:
            os.environ["VIDEO_CAPTION_VIDEO_CACHE_MB"] = saved
    requests = {}
    for on, eng in cold.items():
        eng.warmup()
        lat, res, _, per_request = _timed_requests(eng, dirs[:3], TIMED_REQUESTS)
        for r in res:
            _check_result(r)
        if not all(c for c, _ in per_request):
            raise AssertionError("a request with the video cache off was not cold")
        _require_per_request(per_request, UNIFIED_LAUNCHES, f"overlap_single_upload={on}",
                             cold_encoder=COLD_ENCODER if on else WARM_ENCODER)
        requests[on] = {"latencies_s": lat, "p50_s": statistics.median(lat), "results": res}
    same = _identical_share(requests[True]["results"], requests[False]["results"])
    eng = cold[True]
    feats = eng._load_feats_overlapped(dirs[0])
    video = eng.load_video(dirs[0])
    fgraph, pgraph = eng.feats_graph(feats), eng.request_graph(video)
    trunk_key = next(k for k in eng._trunk_graphs if k[2] == CHUNK)
    tgraph = eng._trunk_graphs[trunk_key]
    chunk = tgraph.static_input.clone()
    profiles = {}
    for name, call in (("feats", lambda: fgraph.replay(feats)),
                       ("pixel", lambda: pgraph.replay(video)),
                       ("trunk", lambda: tgraph.replay(chunk))):
        prof, delta, lost, discarded = _profiled_replay(f"the {name} graph", call)
        profiles[name] = {"kernels": prof["kernels"], "device_ms": prof["device_ms"],
                          "launches": delta, "profiler_lost_spins": lost,
                          "discarded_windows": discarded}
    with torch.inference_mode():
        pre_feats = cm.frames_to_prefix(eng.params, feats, eng.model_cfg)
        pre_pixels = eng.compute_prefix(video)
    prefix_err = rel_err(pre_feats, pre_pixels)
    # the two programs' ids from one generator state
    state = eng.generator.get_state()
    ids_feats = eng._collect_ids(eng._dispatch_feats(feats))
    eng.generator.set_state(state)
    ids_pixels = eng.request_ids(video)
    rows = [(a == b).all(axis=1) for a, b in zip(ids_feats, ids_pixels)]
    same_rows = float(sum(r.sum() for r in rows)) / sum(r.size for r in rows)
    f, px, t = profiles["feats"], profiles["pixel"], profiles["trunk"]
    log(f"frame path: cold requests (cache off), p50 {requests[True]['p50_s'] * 1000:.1f} ms "
        f"with overlap_single_upload {[round(x * 1000, 1) for x in requests[True]['latencies_s']]}"
        f", {requests[False]['p50_s'] * 1000:.1f} ms without "
        f"{[round(x * 1000, 1) for x in requests[False]['latencies_s']]}; captions identical "
        f"{same:.1%}; encoder_attention {COLD_ENCODER} launches a cold request with the overlap, "
        f"{WARM_ENCODER} without")
    log(f"frame path: feats graph [1,{NUM_FRAMES},{feats.shape[-1]}] capture "
        f"{fgraph.capture_s:.2f} s (after a {fgraph.warmup_s:.2f} s run), one replay "
        f"{f['kernels']} kernels, {f['device_ms']:.2f} ms device, "
        f"port kernels {f['launches']}; pixel graph {px['kernels']} kernels, "
        f"{px['device_ms']:.2f} ms; trunk graph {trunk_key} {t['kernels']} kernels, "
        f"{t['device_ms']:.2f} ms (capture {tgraph.capture_s:.2f} s), port kernels "
        f"{t['launches']}; prefix feats vs pixel program rel err {prefix_err:.3e} (bound "
        f"{REL_TOL:g}); id rows identical {same_rows:.1%}; spin records the profiler lost "
        f"{[profiles[n]['profiler_lost_spins'] for n in ('feats', 'pixel', 'trunk')]} of "
        f"{PROFILE_SPINS}, windows discarded "
        f"{[profiles[n]['discarded_windows'] for n in ('feats', 'pixel', 'trunk')]}")
    if not (prefix_err < REL_TOL and torch.isfinite(pre_feats).all()):
        raise AssertionError("the feats program's prefix disagrees with the pixel program's")
    out["requests"] = {"cold_p50_s": {"overlap": requests[True]["p50_s"],
                                      "no_overlap": requests[False]["p50_s"]},
                       "latencies_s": {"overlap": requests[True]["latencies_s"],
                                       "no_overlap": requests[False]["latencies_s"]},
                       "identical_captions": same}
    out["graphs"] = {"feats_capture_s": fgraph.capture_s, "trunk_key": list(trunk_key),
                     "trunk_capture_s": tgraph.capture_s, **profiles}
    out["programs"] = {"prefix_rel_err": prefix_err, "identical_id_rows": same_rows}

    # (c) the mapper step on the packed wire and on RGB, in turns (packed,
    # RGB, RGB, packed) so that neither has the first run alone
    _reset_kernel_counts()
    train = {True: [], False: []}
    for wire_on in (True, False, False, True):
        train[wire_on].append(measure_training_step(
            batch=TRAIN_BATCH, num_frames=TRAIN_FRAMES, trials=3, yuv420_wire=wire_on,
            dtype="bfloat16", report_path=None))
    launches = _kernel_counts()
    _require_launches(launches, selfcheck.MAPPER_TRAINING_PATH, "measure_training_step")
    keys = ("device_ms", "e2e_ms", "e2e_prefetch_ms")
    for r in train[True] + train[False]:
        if not all(math.isfinite(r[k]) and r[k] > 0 for k in keys):
            raise AssertionError(f"measure_training_step: {r}")

    def runs(wire_on):
        rs = train[wire_on]
        return ", ".join(f"{k} {' / '.join(f'{r[k]:.2f}' for r in rs)}" for k in keys) + \
            f" ms, {rs[0]['wire_mb_per_step']:.2f} MB a step"

    log(f"frame path: mapper step (bf16, {TRAIN_BATCH} videos x {TRAIN_FRAMES} frames, runs 1 and "
        f"4 packed, 2 and 3 RGB) on the packed wire: {runs(True)}; RGB: {runs(False)}; launches "
        f"{launches}")
    out["training"] = {"packed": train[True], "rgb": train[False], "launches": launches}

    # (d) retrieval over the smoke's dirs: one batch of 8 videos x 8 frames
    ann = root / "retrieval_annotations.json"
    ann.write_text(json.dumps([{"video_id": f"video{v}", "frames_dir": d,
                                "captions": [CAPTIONS[v % len(CAPTIONS)]]}
                               for v, d in enumerate(dirs)]))
    _reset_kernel_counts()
    t0 = time.perf_counter()
    feats_, ids = features.extract_features(str(ann), str(root / "features"), num_frames=8,
                                            image_size=IMAGE_SIZE, batch_size=8, device="cuda")
    extract_s = time.perf_counter() - t0
    launches = _kernel_counts()
    idx = index.build_index(feats_, ids, str(root / "index"))
    metrics = eval_retrieval.evaluate_retrieval(feats_, ids, idx, ids)
    with torch.inference_mode():
        cpu, _ = features.extract_features(
            str(ann), str(root / "features_cpu"), num_frames=8, image_size=IMAGE_SIZE,
            batch_size=2, limit=2, device="cpu",
            encoder=lambda v: cm.encode_video(cpu_params, v, cpu_cfg))
    err = rel_err(torch.from_numpy(feats_[:2]), torch.from_numpy(cpu))
    want_launches = 12 * -(-len(dirs) // 8)
    log(f"frame path: retrieval: extract_features of {len(ids)} videos in {extract_s:.2f} s "
        f"(the checkpoint's or seeded weights, bf16), features {feats_.shape}, "
        f"encoder_attention {launches['encoder_attention']} launches (at [64,197,2304]); "
        f"{idx.backend} index, {json.dumps(metrics)}; 2 videos' features vs f32 on the CPU rel "
        f"err {err:.3e} (bound {REL_TOL:g})")
    if not (np.isfinite(feats_).all() and feats_.shape == (len(dirs), 256)
            and metrics["recall@1"] == 1.0 and err < REL_TOL
            and launches["encoder_attention"] == want_launches):
        raise AssertionError("retrieval over the smoke's videos is wrong")
    out["retrieval"] = {"extract_s": extract_s, "metrics": metrics, "rel_err_vs_cpu": err,
                        "launches": launches, "backend": idx.backend}
    return out


def _profiled_replay(label, call):
    """(profile, the counters' delta, spin records the profiler lost) of
    one call under torch.profiler, behind PROFILE_SPINS spin kernels that
    open the window. Late in a run of this script the profiler lost the
    first 16 kernel records of a window (the feats graph's first 16
    kernels, its prefix_projector among them; with one 2 ms spin first, the
    spin and 15 of them), where early in a process it lost none; in other
    runs 67 records (64 spins and 3 of the pixel graph's kernels) and 310
    (256 spins and 54 of the trunk graph's). The spins take that loss, and
    the ones it kept are taken out of the kernel count and the device ms. A
    window that kept no spin lost part of the call's records: it is
    discarded and the call profiled again, at most PROFILE_DISCARDS times.
    Fails unless a window kept at least one spin (so the call's records are
    whole) and the profiler's count of the port's kernels in that window
    equals the wrappers' counters' delta. Returns the window's profile, the
    counters' delta, the spins it lost and the windows discarded."""
    from video_caption_tpu_torch.cli.profile_request import profile_call

    def opened():
        for _ in range(PROFILE_SPINS):
            torch.cuda._sleep(PROFILE_SPIN_CYCLES)
        call()

    for discarded in range(PROFILE_DISCARDS + 1):
        before = _kernel_counts()
        prof = profile_call(opened, count=("spin_kernel",))
        delta = {n: c - before[n] for n, c in _kernel_counts().items() if c != before[n]}
        spins = prof["counted"]["spin_kernel"]
        kept = spins["launches"]
        if kept:
            break
        log(f"{label}: the profiler lost the window's head (0 of {PROFILE_SPINS} spins, "
            f"{prof['kernels']} kernels kept); window {discarded + 1} discarded "
            f"({PROFILE_DISCARDS} allowed)")
    if prof["wrapper_launches"] != delta or not kept:
        raise AssertionError(f"{label}: the profiler saw {prof['wrapper_launches']} launches in "
                             f"one replay ({prof['kernels']} kernels, {prof['device_ms']:.2f} ms, "
                             f"{kept} of {PROFILE_SPINS} spins, {discarded} windows discarded "
                             f"before it), the counters {delta}")
    return {**prof, "kernels": prof["kernels"] - kept,
            "device_ms": prof["device_ms"] - spins["ms"]}, delta, \
        PROFILE_SPINS - kept, discarded


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _f32_cpu(tree):
    """Floating leaves in f32 on the CPU; integer leaves (int8 weights) as they are."""
    return {k: _f32_cpu(v) if isinstance(v, dict)
            else (v.float() if v.is_floating_point() else v).cpu() for k, v in tree.items()}


def _f32(model_cfg):
    import dataclasses

    return dataclasses.replace(model_cfg, vit=dataclasses.replace(model_cfg.vit, dtype=torch.float32),
                               gpt2=dataclasses.replace(model_cfg.gpt2, dtype=torch.float32))


def _log_check(c, prefix="kernel") -> None:
    lib = "none" if c.library_ms is None else f"{c.library_ms:.4f} ms"
    atol = f"{c.atol:g}{' x max|plain|' if c.atol_of_max else ''}"
    tol = (f"atol {atol} rtol {c.rtol:g}" if c.max_ulp is None else
           f"{c.max_ulp:g} ulp, {c.equal_share:.4%} equal")
    log(f"{prefix} {c.name:18s} {c.shape:52s} max_abs_err {c.max_abs_err:.3e} "
        f"({tol}) {'ok' if c.ok else 'FAIL'} "
        f"kernel {c.ms:.4f} ms plain {c.plain_ms:.4f} ms library {lib} "
        f"bound {c.bound_ms:.4f} ms ({c.bound_by})")


def _mesh_phase(engine, core_cfg, dirs, root: Path, ckpt: str) -> dict:
    """Phase 16: the multi-device paths on one card (module docstring)."""
    import numpy as np

    from video_caption_tpu_torch.engine import InferenceEngine
    from video_caption_tpu_torch.ops import selfcheck
    from video_caption_tpu_torch.parallel import dryrun

    out = {}
    # the kernels at a rank's 6 of 12 heads: the TP request's encoder (2
    # videos x 16 frames) and its beam-3 group (2 videos x 2 presets)
    checks = [selfcheck.check_encoder_attention(MESH_VIDEOS * NUM_FRAMES, heads=6),
              selfcheck.check_beam_attention(2 * MESH_VIDEOS, BEAMS, 48, 24, 12, heads=6),
              selfcheck.check_beam_attention(2 * MESH_VIDEOS, BEAMS, 48, 24, 12, heads=6,
                                             deferred=True)]
    for c in checks:
        _log_check(c, "mesh kernel (6 heads)")
    out["kernel_checks"] = [c.as_dict() for c in checks]
    if not all(c.ok for c in checks):
        raise AssertionError(f"kernels at 6 heads disagree with their plain versions: {checks}")

    # the single-device engine on the same weights and seed, eagerly
    ref_cfg = dataclasses.replace(core_cfg, compile=dataclasses.replace(
        core_cfg.compile, aot_request_program=False))
    ref = InferenceEngine(ref_cfg, params=engine.params, seed=SEED, device="cuda")
    want = dryrun.engine_request(ref, dirs)
    alone = dryrun.rows_alone_ids(ref, dirs, 2, SEED)
    del ref
    rng = np.random.RandomState(SEED)
    mask = np.ones((TRAIN_BATCH, 24), np.int32)
    mask[0, 12:] = 0
    batch = {"video": rng.randint(0, 255, (TRAIN_BATCH, TRAIN_FRAMES, 3, IMAGE_SIZE, IMAGE_SIZE),
                                  np.uint8),
             "caption_ids": rng.randint(0, 50000, (TRAIN_BATCH, 24)).astype(np.int32),
             "attention_mask": mask}
    payload = {"dirs": list(dirs), "ckpt": ckpt, "num_frames": NUM_FRAMES,
               "image_size": IMAGE_SIZE, "seed": SEED, "out_dir": str(root / "mesh"),
               "batch": batch}
    log("mesh: two ranks share the one H100 over gloo (backend='gloo'): NCCL refuses two "
        "ranks on one device")
    t0 = time.perf_counter()
    ranks = dryrun.run_world(2, dryrun.chip_mesh_ranks, payload, device="cuda",
                             backend="gloo", timeout=MESH_TIMEOUT_S)
    out["ranks_s"] = time.perf_counter() - t0
    v = engine.model_cfg.gpt2.vocab_size

    def id_rows_share(ids, reference):
        rows = [(a == b).all(axis=1) for a, b in zip(ids, reference)]
        return float(sum(r.sum() for r in rows)) / sum(r.size for r in rows)

    for shape, label in (((1, 2), "1x2 (TP)"), ((2, 1), "2x1 (DP)")):
        got = [r[shape] for r in ranks]
        if any(not all(np.array_equal(a, b) for a, b in zip(g["ids"], got[0]["ids"]))
               for g in got[1:]):
            raise AssertionError(f"mesh {label}: the ranks returned different ids")
        for r, g in enumerate(got):
            _require_launches(g["launches"], selfcheck.DEFAULT_PATH,
                              f"mesh {label} rank {r}'s request")
            for result in g["results"]:
                _check_result(result)
        launches = [{k: n for k, n in g["launches"].items() if k in selfcheck.DEFAULT_PATH}
                    for g in got]
        out[label] = {"seconds": [g["seconds"] for g in got], "launches": launches,
                      "results": got[0]["results"]}
        head = (f"mesh {label}: infer_batch of {len(dirs)} videos (core presets, eager) "
                f"{[round(g['seconds'], 2) for g in got]} s a rank, launches a rank {launches}")
        if shape == (1, 2):
            prefix_err = rel_err(torch.from_numpy(got[0]["prefix"]),
                                 torch.from_numpy(want["prefix"]))
            logits_err = rel_err(torch.from_numpy(got[0]["logits"][:, :v]),
                                 torch.from_numpy(want["logits"][:, :v]))
            share = id_rows_share(got[0]["ids"], want["ids"])
            log(f"{head}; prefix rel err {prefix_err:.3e}, prefill logits rel err "
                f"{logits_err:.3e} (bound {REL_TOL:g}) against the single-device engine; "
                f"identical id rows {share:.1%}; result {json.dumps(got[0]['results'][0])}")
            out[label].update(prefix_rel_err=prefix_err, logits_rel_err=logits_err,
                              identical_id_rows=share)
            if not (prefix_err < REL_TOL and logits_err < REL_TOL):
                raise AssertionError(f"mesh {label} disagrees with the single-device engine")
        else:
            same = [np.array_equal(a, b) for a, b in zip(got[0]["ids"], alone)]
            log(f"{head}; each group's ids identical to the single-device engine's on each "
                f"rank's video alone with its rows of the batch's noise: {same} (groups "
                f"sampling {got[0]['sampled']}); identical id rows against the 2-video "
                f"single-device batch {id_rows_share(got[0]['ids'], want['ids']):.1%}; result "
                f"{json.dumps(got[0]['results'][0])}")
            out[label].update(identical_groups=same, sampled=got[0]["sampled"])
            if not all(same):
                raise AssertionError(f"mesh {label}: ids differ from the single-device engine "
                                     f"on each rank's rows")

    single, half = (dryrun.mapper_step(None, dryrun.full_width_mapper_config(), b, SEED,
                                       str(root / f"mesh_single{i}"), torch.device("cuda"))
                    for i, b in enumerate((batch, {k: v[:TRAIN_BATCH // 2]
                                                   for k, v in batch.items()})))
    fsdp = [r["fsdp"] for r in ranks]
    diff = abs(fsdp[0]["loss"] - single["loss"]) / abs(single["loss"])
    norm_diff = abs(fsdp[0]["grad_norm"] - single["grad_norm"]) / single["grad_norm"]
    b0 = single["before"]
    update_diff, flipped = _update_diff(b0, fsdp[0]["after"], single["after"])
    half_diff, half_flipped = _update_diff(b0, half["after"], single["after"])
    log(f"mesh 2x1 FSDP mapper step (2 GPT-2 layers, the last trained, full width, "
        f"fsdp_min_elems=0) against one device: loss {fsdp[0]['loss']:.6f} / "
        f"{single['loss']:.6f} (relative diff {diff:.2e}, bound {MESH_LOSS_RTOL:g}); gradient "
        f"norm {fsdp[0]['grad_norm']:.6e} / {single['grad_norm']:.6e} (relative diff "
        f"{norm_diff:.2e}, bound {MESH_NORM_RTOL:g}); update of {len(b0)} trained leaves: "
        f"flipped share {flipped:.3e} (bound {MESH_FLIPPED_SHARE:g}), relative L2 diff "
        f"{update_diff:.3e}; control, one device on half the batch: flipped share "
        f"{half_flipped:.3e}, relative L2 diff {half_diff:.3e}; "
        f"{fsdp[0]['data_sharded']} leaves data-sharded, {fsdp[0]['data_gathers']} all-gathers "
        f"over data; step {fsdp[0]['seconds']:.2f} s (rank 0), {single['seconds']:.2f} s on "
        f"one device")
    out["fsdp"] = {"loss": fsdp[0]["loss"], "single_loss": single["loss"], "rel_diff": diff,
                   "grad_norm": fsdp[0]["grad_norm"], "single_grad_norm": single["grad_norm"],
                   "norm_rel_diff": norm_diff, "update_rel_diff": update_diff,
                   "flipped_share": flipped, "half_batch_update_rel_diff": half_diff,
                   "half_batch_flipped_share": half_flipped,
                   "trained_leaves": len(b0), "data_sharded": fsdp[0]["data_sharded"],
                   "data_gathers": fsdp[0]["data_gathers"],
                   "seconds": [f["seconds"] for f in fsdp], "single_seconds": single["seconds"]}
    if not (diff < MESH_LOSS_RTOL and norm_diff < MESH_NORM_RTOL
            and flipped < MESH_FLIPPED_SHARE < half_flipped and fsdp[0]["loss"] == fsdp[1]["loss"]
            and fsdp[0]["data_gathers"] > 0 and fsdp[0]["data_sharded"] > 0):
        raise AssertionError(f"the FSDP step disagrees: {out['fsdp']}")

    t0 = time.perf_counter()
    nccl = dryrun.run_world(1, dryrun.chip_nccl_rank, payload, device="cuda",
                            backend="nccl", timeout=MESH_TIMEOUT_S)[0]
    out["nccl_s"] = time.perf_counter() - t0
    same_ids = all(np.array_equal(a, b) for a, b in zip(nccl["request"]["ids"], want["ids"]))
    log(f"mesh one-rank NCCL group (backend {nccl['backend']}): {nccl['collectives']} "
        f"collectives on CUDA tensors return their input {nccl['same']}; 1x1 mesh engine's "
        f"ids identical to the single-device engine's {same_ids}, its collectives "
        f"{nccl['request_collectives']}, launches {nccl['request']['launches']}")
    out["nccl"] = {"backend": nccl["backend"], "same": nccl["same"], "identical_ids": same_ids,
                   "request_collectives": nccl["request_collectives"]}
    _require_launches(nccl["request"]["launches"], selfcheck.DEFAULT_PATH,
                      "the 1x1 NCCL mesh request")
    if not (nccl["backend"] == "nccl" and nccl["on_mesh"] and all(nccl["same"].values())
            and same_ids and nccl["request_collectives"]):
        raise AssertionError(f"the one-rank NCCL check failed: {out['nccl']}")
    return out


def _update_diff(before: dict, got: dict, want: dict) -> tuple:
    """(relative L2 difference, share of flipped elements) of the update
    ``got - before`` against ``want - before`` over the leaves of
    ``before``: an element is flipped where the two updates differ by more
    than half the largest move of its leaf in ``want``."""
    import numpy as np

    sq = moved = flipped = count = 0.0
    for p, b in before.items():
        d_got, d_want = got[p] - b, want[p] - b
        sq += float(np.sum((d_got - d_want) ** 2))
        moved += float(np.sum(d_want ** 2))
        flipped += int(np.sum(np.abs(d_got - d_want) > 0.5 * np.abs(d_want).max()))
        count += b.size
    return math.sqrt(sq / moved), flipped / count


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
