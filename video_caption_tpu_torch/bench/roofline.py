"""Per-stage roofline: device time, FLOPs, HBM bytes, % of the card's peak
(counterpart of video_caption_tpu/bench/roofline.py).

Each pipeline stage gets {device_ms, flops, bytes, pct_peak_flops,
pct_peak_hbm} against the card's published peaks, plus a device-only
captions/s that leaves out JPEG decode and the upload.

FLOPs and bytes are analytic, from the model geometry and the parameter
dict, with the JAX package's formulas. The stages run eagerly as one
kernel launch per op, so a host clock would time the host's issue rate:
each timed stage is captured once into a CUDA graph
(``aot.graphed``) and its replays are timed with CUDA events, ``amortize``
replays between two events. On the CPU (the tests) the stages run as
they are, timed by the host clock; ``chip_peaks`` is then None and no
share of a peak is given.

Every share is of the peak of the stage's compute dtype
(``ops/selfcheck.py``: 989 TFLOP/s bf16, 67 TFLOP/s f32 outside the
tensor cores, 3.35 TB/s HBM); the result names the dtype it used.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from video_caption_tpu_torch.aot import graphed
from video_caption_tpu_torch.ops.selfcheck import HBM_BYTES_PER_S, PEAK_FLOPS

PEAK_DEVICES = ("NVIDIA H100 80GB HBM3",)
"""The cards whose published peaks ``chip_peaks`` knows."""


def chip_peaks(device="cuda") -> Optional[tuple]:
    """(dense bf16 FLOP/s, HBM bytes/s) of ``device``: the H100 SXM's data
    sheet for an "NVIDIA H100 80GB HBM3", None for any other device, the CPU
    included."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    if torch.cuda.get_device_name(device) not in PEAK_DEVICES:
        return None
    return PEAK_FLOPS[torch.bfloat16], HBM_BYTES_PER_S


# ---------------------------------------------------------------------------
# analytic FLOPs / bytes
# ---------------------------------------------------------------------------

def _tree_bytes(tree) -> int:
    return sum(_tree_bytes(v) if isinstance(v, dict) else v.numel() * v.element_size()
               for v in tree.values())


def vit_encode_flops(model_cfg, num_frames: int) -> float:
    """Dense FLOPs of one video's encode (T frames through the ViT trunk +
    pool + head + prefix mapper)."""
    v = model_cfg.vit
    s, h, L = v.seq_len, v.embed_dim, v.depth
    patch_dim = v.patch_size * v.patch_size * v.in_chans
    per_frame = 2 * v.num_patches * patch_dim * h            # patch embed
    per_block = 24 * s * h * h + 4 * s * s * h               # qkv+proj+mlp / attn
    per_frame += L * per_block
    per_frame += 2 * h * v.out_dim                           # per-frame head share
    mapper = 2 * model_cfg.video_dim * model_cfg.mapper_out
    return num_frames * per_frame + mapper


def vit_encode_bytes(params, model_cfg, num_frames: int, batch: int) -> float:
    """HBM traffic estimate: weights once + activations twice per block."""
    w_bytes = _tree_bytes(params["encoder"])
    v = model_cfg.vit
    act = batch * num_frames * v.seq_len * v.embed_dim * 2   # bf16 activations
    return w_bytes + 2 * v.depth * act


def gpt2_step_flops(gcfg, kv_len: int) -> float:
    """One decode step, one row: qkv+attn-proj+mlp + cache attention + lm head."""
    h = gcfg.n_embd
    return gcfg.n_layer * (24 * h * h + 4 * h * kv_len) + 2 * h * gcfg.vocab_size


def decode_group_flops(gcfg, rows: int, num_beams: int, prefill_len: int,
                       max_new_tokens: int, max_len: int) -> float:
    """Dense FLOPs of one grouped decode program: every step of the static
    length runs, attention over the whole static cache."""
    h, L, V = gcfg.n_embd, gcfg.n_layer, gcfg.vocab_size
    r = rows * num_beams
    prefill = rows * (prefill_len * (L * 24 * h * h) + L * 2 * prefill_len * prefill_len * h
                      + 2 * prefill_len * h * V)
    per_step = L * (24 * h * h + 4 * h * max_len) + 2 * h * V
    return prefill + r * max_new_tokens * per_step


def training_step_flops(mc, batch: int, num_frames: int, cap_len: int,
                        unfreeze_last_gpt2: int = 0) -> float:
    """Dense FLOPs of one mapper-trainer step (compute_loss + backward):
    the frozen encoder's forward only, the GPT-2 teacher-forcing forward at
    S = prefix + caption tokens, its backward as dgrad through every
    decoder layer (the prefix gradient must reach the mapper) ~= 1x the
    forward's products, and wgrad only for the unfrozen tail blocks."""
    g = mc.gpt2
    h, L, V = g.n_embd, g.n_layer, g.vocab_size
    s = mc.prefix_len + cap_len
    enc = batch * vit_encode_flops(mc, num_frames)
    per_block = 24 * h * h * s + 4 * s * s * h
    fwd = L * per_block + 2 * s * h * V
    dgrad = fwd
    wgrad = unfreeze_last_gpt2 * per_block
    return enc + batch * (fwd + dgrad + wgrad)


def decode_group_bytes(params, gcfg, rows: int, num_beams: int,
                       max_new_tokens: int, max_len: int) -> float:
    """Weight traffic dominates: the whole decoder read once per step, plus
    the static KV cache read per row per step."""
    w_bytes = _tree_bytes(params["decoder"])
    kv = rows * num_beams * gcfg.n_layer * 2 * max_len * gcfg.n_embd * 2  # bf16 k+v
    return max_new_tokens * (w_bytes + kv)


def decode_unified_cost(params, gcfg, group_list, batch: int,
                        prefix_len: int) -> tuple:
    """(flops, bytes) of the unified mixed-policy program: every group in
    one loop to the longest horizon, the weights read once per step."""
    h, L, V = gcfg.n_embd, gcfg.n_layer, gcfg.vocab_size
    l_max = max(ids.shape[1] for _, _, ids, _ in group_list)
    s0 = prefix_len + l_max
    n_max = max(dp.max_new_tokens for dp, *_ in group_list)
    i_tot = sum(batch * len(idxs) for _, idxs, *_ in group_list)
    r_tot = sum(batch * len(idxs) * dp.num_beams for dp, idxs, *_ in group_list)
    w_bytes = _tree_bytes(params["decoder"])

    prefill_flops = i_tot * (s0 * L * 24 * h * h + L * 2 * s0 * s0 * h + 2 * s0 * h * V)
    step_flops = r_tot * (L * 24 * h * h + 2 * h * V)
    for dp, idxs, *_ in group_list:
        rg = batch * len(idxs) * dp.num_beams
        step_flops += rg * L * 4 * h * (s0 + dp.num_beams * n_max)
    flops = prefill_flops + n_max * step_flops

    gen_kv = r_tot * n_max * L * 2 * h * 2        # bf16 K|V
    pre_kv = i_tot * s0 * L * 2 * h * 2
    # the prefill reads the weights once; each of the n_max steps reads
    # them once for every group, plus both cache regions
    bytes_ = w_bytes + n_max * (w_bytes + gen_kv + pre_kv)
    return flops, bytes_


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------

def _timed(fn: Callable[[], Any], trials: int, amortize: int = 1, device="cuda") -> tuple:
    """(median seconds per execution, last result) of ``fn``.

    On CUDA each trial records an event, issues ``amortize`` executions
    back to back, records a second event and waits for it: one stream runs
    them in issue order, so the interval over ``amortize`` is one
    execution's device time (the host's issue time hides behind the
    device's work once the stream is ahead). On the CPU each trial is the
    host clock around ``amortize`` executions. One untimed execution first."""
    device = torch.device(device)
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    times = []
    for _ in range(trials):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(amortize):
                out = fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3 / amortize)
        else:
            t0 = time.perf_counter()
            for _ in range(amortize):
                out = fn()
            times.append((time.perf_counter() - t0) / amortize)
    return statistics.median(times), out


def _write(report_path: Optional[str], result: Dict[str, Any]) -> None:
    if report_path:
        p = Path(report_path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(result, indent=1) + "\n")


def measure_roofline(engine, batch: int = 16, trials: int = 5,
                     report_path: Optional[str] = "reports/torch/roofline.json",
                     amortize: int = 4) -> Dict[str, Any]:
    """Per-stage device-time roofline of ``engine`` on a device-resident
    batch of ``batch`` random videos.

    Stages: ``encode`` (``engine.compute_prefix``); one
    ``decode[beams=..,new=..,rows=..]`` per policy group
    (``engine.run_decode_group``); with two or more groups either
    ``decode[grouped,pipelined]`` (the groups' graphs replayed back to
    back, as the batch program runs them) or, where the engine's batches
    decode in one unified loop (``_unified_eligible``), ``decode[unified]``
    (``decode/unified.generate_unified``). Sampled decodes draw from
    throwaway generators: the engine's generator is not advanced.
    ``device_total_ms`` is the encode plus what the engine runs for the
    decode, ``device_caps_per_sec`` the batch over it."""
    from video_caption_tpu_torch.decode.unified import generate_unified

    mc, c, device = engine.model_cfg, engine.config, engine.device
    video = torch.from_numpy(np.random.RandomState(0).randint(
        0, 255, (batch, c.num_frames, 3, c.image_size, c.image_size), np.uint8)).to(device)
    peaks = chip_peaks(device)
    dtype = mc.gpt2.dtype
    peak_flops = PEAK_FLOPS[dtype] if peaks else None
    stages: List[Dict[str, Any]] = []

    def add_stage(name, secs, flops, bytes_):
        row = {
            "stage": name,
            "device_ms": secs * 1e3,
            "gflops": flops / 1e9,
            "gbytes": bytes_ / 1e9,
            "tflops_per_sec": flops / secs / 1e12,
            "gbytes_per_sec": bytes_ / secs / 1e9,
        }
        if peaks:
            row["pct_peak_flops"] = 100 * flops / secs / peak_flops
            row["pct_peak_hbm"] = 100 * bytes_ / secs / peaks[1]
        stages.append(row)
        return row

    def throwaway(seed: int) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(seed)

    # stage 1: encode (ViT trunk + pool + head + prefix norm + mapper)
    encode = graphed(engine.compute_prefix, video)
    t_enc, prefix = _timed(lambda: encode(video), trials, amortize, device)
    add_stage("encode", t_enc,
              batch * vit_encode_flops(mc, c.num_frames),
              vit_encode_bytes(engine.params, mc, c.num_frames, batch))

    # one decode per policy group, through the engine's group dispatch
    group_list = engine._decode_groups()
    total = t_enc
    dec_flops = dec_bytes = 0.0
    group_runs = []
    for gi, (dp, idxs, ids, mask) in enumerate(group_list):
        gen = throwaway(gi)
        run = graphed(lambda p, d=dp, i=ids, m=mask, g=gen: engine.run_decode_group(p, d, i, m, g),
                      prefix, (gen,))
        group_runs.append(run)
        t_g, _ = _timed(lambda r=run: r(prefix), trials, amortize, device)
        total += t_g
        rows = len(idxs)
        prefill_len = mc.prefix_len + ids.shape[1]
        max_len = prefill_len + dp.max_new_tokens
        g_flops = decode_group_flops(mc.gpt2, batch * rows, dp.num_beams, prefill_len,
                                     dp.max_new_tokens, max_len)
        g_bytes = decode_group_bytes(engine.params, mc.gpt2, batch * rows, dp.num_beams,
                                     dp.max_new_tokens, max_len)
        dec_flops += g_flops
        dec_bytes += g_bytes
        add_stage(f"decode[beams={dp.num_beams},new={dp.max_new_tokens},rows={rows}]",
                  t_g, g_flops, g_bytes)

    unified = engine._unified_eligible(group_list)
    if len(group_list) > 1 and not unified:
        # the groups back to back on one stream, as the batch program runs
        # them: no gap between them, unlike the sum of the stages above
        t_pipe, _ = _timed(lambda: [run(prefix) for run in group_runs][-1], trials, amortize,
                           device)
        add_stage("decode[grouped,pipelined]", t_pipe, dec_flops, dec_bytes)
        total = t_enc + t_pipe

    if unified:
        prompts = [(ids, mask) for _, _, ids, mask in group_list]
        dps = [dp for dp, *_ in group_list]
        gen = throwaway(100)

        def run_unified(p):
            with torch.inference_mode():
                return generate_unified(engine.params["decoder"], mc.gpt2, p, prompts, dps, gen)

        run_u = graphed(run_unified, prefix, (gen,))
        t_u, _ = _timed(lambda: run_u(prefix), trials, amortize, device)
        uf, ub = decode_unified_cost(engine.params, mc.gpt2, group_list, batch, mc.prefix_len)
        add_stage("decode[unified]", t_u, uf, ub)
        total = t_enc + t_u   # the engine's batches run only the unified loop

    result = {
        "device_kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "batch": batch,
        "num_frames": c.num_frames,
        "trials": trials,
        "amortize": amortize,
        "peaks": {"bf16_tflops": peaks[0] / 1e12, "hbm_gbps": peaks[1] / 1e9,
                  "compute_dtype": str(dtype).removeprefix("torch."),
                  "compute_tflops": peak_flops / 1e12} if peaks else None,
        "stages": stages,
        "device_total_ms": total * 1e3,
        "device_caps_per_sec": batch / total,
    }
    _write(report_path, result)
    return result


def measure_training_step(
    batch: int = 8, num_frames: int = 8, trials: int = 10,
    yuv420_wire: bool = True, unfreeze_last_gpt2: int = 0,
    report_path: Optional[str] = "reports/torch/roofline_training.json",
    dtype: str = "float32", device="cuda", model_cfg=None,
) -> Dict[str, Any]:
    """Training-step roofline of the mapper trainer (frozen ViT-B/16 +
    mapper + GPT-2 teacher forcing; ``model_cfg`` another geometry). Under
    a launcher's world the trainer's default mesh puts every rank on
    ``data`` and each step takes this data rank's rows of the batch, as the
    JAX package's ``shard_batch`` does.
    ``yuv420_wire`` (on, as in the JAX package) ships the batch as packed
    4:2:0 planes [B,T,plane_len] that the step converts on the device; off,
    uint8 RGB [B,T,3,S,S].

    ``device_ms``: ``amortize`` = 4 steps back to back on a batch already on
    the device, between two CUDA events (the step is eager: the interval
    holds the stream's idle time while the host issues its kernels).
    ``e2e_ms``: one step with the host batch moved by ``.to(device)``, host
    clock, synchronised. ``e2e_prefetch_ms``: batch N+1's upload issued
    before step N. FLOPs are ``training_step_flops``; ``xla_cost_gflops``
    has no counterpart and stays None. The share of peak is of the peak of
    the step's compute dtype (``peak_flops_dtype``)."""
    from video_caption_tpu_torch.config import default_inference_config
    from video_caption_tpu_torch.engine import model_config_from_inference
    from video_caption_tpu_torch.models import caption_model as cm
    from video_caption_tpu_torch.preprocessing.yuv420 import packed_plane_len
    from video_caption_tpu_torch.training.mapper_trainer import MapperTrainer, TrainArgs

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA device is available")
    mc = model_cfg or model_config_from_inference(
        default_inference_config(ckpt="none.pt", num_frames=num_frames))
    # fp32 master parameters, compute in ``dtype``
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    mc = dataclasses.replace(mc, vit=dataclasses.replace(mc.vit, dtype=dt),
                             gpt2=dataclasses.replace(mc.gpt2, dtype=dt))
    params = cm.init_caption_model(0, mc, device)
    rng = np.random.RandomState(0)
    size = mc.vit.image_size
    if yuv420_wire:
        vid = rng.randint(0, 255, (batch, num_frames, packed_plane_len(size)), np.uint8)
    else:
        vid = rng.randint(0, 255, (batch, num_frames, 3, size, size), np.uint8)
    host_batch = {
        "video": vid,
        "caption_ids": rng.randint(0, min(50000, mc.gpt2.vocab_size), (batch, 24)).astype(np.int32),
        "attention_mask": np.ones((batch, 24), np.int32),
    }

    def upload(b):
        if device.type == "cuda":
            return {k: torch.from_numpy(v).pin_memory().to(device, non_blocking=True)
                    for k, v in b.items()}
        return {k: torch.from_numpy(v) for k, v in b.items()}

    with tempfile.TemporaryDirectory() as out_dir:
        trainer = MapperTrainer(mc, params, TrainArgs(unfreeze_last_gpt2=unfreeze_last_gpt2,
                                                      out_dir=out_dir))

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        # e2e: the host batch moved every step, the loss read back
        trainer.run_step(host_batch)
        e2e = []
        for _ in range(trials):
            t0 = time.perf_counter()
            trainer.run_step(host_batch)
            e2e.append(time.perf_counter() - t0)
        t_e2e = statistics.median(e2e)

        def run_prefetched(n_steps: int) -> float:
            nxt = upload(host_batch)
            sync()
            t0 = time.perf_counter()
            for _ in range(n_steps):
                cur, nxt = nxt, upload(host_batch)
                trainer.run_step(cur, sync=False)
            trainer.drain_pending()
            sync()
            return (time.perf_counter() - t0) / n_steps

        run_prefetched(2)
        t_pre = min(run_prefetched(max(trials // 2, 3)) for _ in range(3))

        dev_batch = upload(host_batch)
        t_dev, _ = _timed(lambda: trainer.run_step(dev_batch, sync=False), trials, amortize=4,
                          device=device)
        trainer.drain_pending()

    flops = training_step_flops(mc, batch, num_frames, host_batch["caption_ids"].shape[1],
                                unfreeze_last_gpt2)
    peaks = chip_peaks(device)
    wire_bytes = sum(v.size * v.dtype.itemsize for v in host_batch.values())
    result = {
        "device_kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "batch": batch, "num_frames": num_frames,
        "yuv420_wire": yuv420_wire,
        "unfreeze_last_gpt2": unfreeze_last_gpt2,
        "dtype": dtype,
        "trials": trials,
        "device_ms": t_dev * 1e3,
        "e2e_ms": t_e2e * 1e3,
        "e2e_prefetch_ms": t_pre * 1e3,
        "wire_mb_per_step": wire_bytes / 1e6,
        "gflops": flops / 1e9,
        "xla_cost_gflops": None,
        "tflops_per_sec": flops / t_dev / 1e12,
    }
    if peaks:
        result["pct_peak_flops"] = 100 * flops / t_dev / PEAK_FLOPS[dt]
        result["peak_flops_dtype"] = dtype
    _write(report_path, result)
    return result
