"""Stage-sliced benchmark (counterpart of video_caption_tpu/bench/benchmark.py).

The measurement design of the JAX package, on the card:

- the 4-stage taxonomy, one ``torch.profiler.record_function`` range per
  stage: Preprocessing, ViT_Encoder, Cross_Modal_Alignment,
  GPT2_Decoder_Step;
- a manual greedy decode loop timed token by token (one single-token step
  per token, not the engine's decode);
- warmup + N iterations, a batch-size sweep that stops at the first batch
  size that runs out of memory;
- the same report files: baseline_iterations.csv, baseline_summary.json,
  benchmark_bs_comparison.csv, benchmark_bs_summary.json (``_fp32``
  variants for f32).

On CUDA every device stage is a CUDA graph (``aot.graphed``), captured in
the first iteration and replayed after, and timed with CUDA events
recorded around its replay: eagerly the stages would time the host's
issue rate. The step's cache offset is a Python int (``gpt2_forward``), so
the loop has one graph per step index, all writing the one cache the
prefill graph returns. Events are read once the iteration's last token is
back, so the per-token times hold no host round trip. The preprocessing
stages and ``end_to_end_ms`` are host-clock times. On the CPU (the
tests) the stages run as they are, timed by the host clock.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from video_caption_tpu_torch.aot import graphed
from video_caption_tpu_torch.bench import report as rpt
from video_caption_tpu_torch.config import InferenceConfig, default_inference_config
from video_caption_tpu_torch.engine import InferenceEngine
from video_caption_tpu_torch.env import device_summary
from video_caption_tpu_torch.memory import MemoryManager, is_oom_error
from video_caption_tpu_torch.models import caption_model as cm
from video_caption_tpu_torch.models import gpt2 as g2
from video_caption_tpu_torch.ops.prefix_norm import apply_prefix_norm
from video_caption_tpu_torch.preprocessing.frame_loader import load_video_array_u8

log = logging.getLogger(__name__)


class _Clock:
    """Time marks on ``device``: CUDA events recorded on the current stream,
    or the host clock on the CPU; ``ms(a, b)`` once the work is done."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1000


class StageBench:
    """The pipeline's stages over one (config, batch) shape: encode, align,
    prefill and one greedy step per token index, each a CUDA graph on the
    card. ``params`` (and ``model_cfg``) replace the configured checkpoint
    or seeded random weights, as an engine takes them. ``last_ids`` holds
    the last iteration's tokens [batch, max_new_tokens]."""

    def __init__(self, config: InferenceConfig, batch_size: int, max_new_tokens: int = 24,
                 params: Optional[dict] = None, model_cfg=None, device="cuda", seed: int = 0):
        self.config = config
        self.batch = batch_size
        self.max_new = max_new_tokens
        # the engine loads and casts the weights as it serves them
        engine = InferenceEngine(config, params=params, seed=seed, model_cfg=model_cfg,
                                 device=device)
        self.device = engine.device
        self.model_cfg = engine.model_cfg
        self.params = engine.params
        self.tokenizer = engine.tokenizer
        self.memory = MemoryManager(config.memory, self.device)
        self.clock = _Clock(self.device)
        self.s0 = self.model_cfg.prefix_len + 1  # prefix + BOS
        self.last_ids: Optional[np.ndarray] = None
        self._wte_t = g2.lm_head_t(self.params["decoder"], self.model_cfg.gpt2)
        self._encode = self._align = self._prefill = None
        self._steps: List = []

    # the stages, each a function of one tensor --------------------------
    def _encode_fn(self, video):
        with torch.inference_mode():
            return cm.encode_video(self.params, video, self.model_cfg)

    def _align_fn(self, emb):
        mc = self.model_cfg
        with torch.inference_mode():
            return cm.map_prefix(self.params, apply_prefix_norm(emb, mc.ln_scale, mc.in_weight), mc)

    def _prefill_fn(self, prefix):
        """prefix [B,P,H] + BOS -> (first token [B], cache, valid) over a
        cache of s0 + max_new_tokens columns."""
        mc, dec = self.model_cfg, self.params["decoder"]
        b, s0 = prefix.shape[0], self.s0
        with torch.inference_mode():
            bos = torch.full((b, 1), self.tokenizer.bos_token_id, dtype=torch.int64,
                             device=prefix.device)
            embeds = cm.build_decoder_inputs(self.params, prefix, bos, mc)
            cache = g2.init_cache(mc.gpt2, b, s0 + self.max_new, prefix.device)
            valid = torch.zeros((b, s0 + self.max_new), dtype=torch.int32, device=prefix.device)
            valid[:, :s0] = 1
            positions = torch.arange(s0, device=prefix.device)[None].expand(b, s0)
            (logits, _, _, _), cache = g2.gpt2_forward(
                dec, embeds, positions, valid, cache, 0, mc.gpt2, wte_t=self._wte_t,
                last_only=True, return_stats=True, row_stats=False)
            return logits.argmax(dim=-1), cache, valid

    def _step_fn(self, t: int, cache, valid):
        """The greedy step of token index t: the token of step t-1 at cache
        column s0 + t -> the next token [B]."""
        mc, dec = self.model_cfg, self.params["decoder"]
        col = self.s0 + t

        def step(tok):
            with torch.inference_mode():
                positions = torch.full((tok.shape[0], 1), col, dtype=torch.int64,
                                       device=tok.device)
                valid[:, col] = 1
                (logits, _, _, _), _ = g2.gpt2_forward(
                    dec, dec["wte"][tok][:, None, :], positions, valid, cache, col, mc.gpt2,
                    wte_t=self._wte_t, return_stats=True, row_stats=False)
                return logits.argmax(dim=-1)

        return step

    # ------------------------------------------------------------------
    def run_iteration(self, frames_dir: str) -> Dict:
        cfg = self.config
        row: Dict = {"batch_size": self.batch, "num_frames": cfg.num_frames,
                     "max_new_tokens": self.max_new, "dtype": cfg.compile.dtype}
        sync = torch.cuda.synchronize if self.clock.cuda else (lambda: None)
        t_all = time.perf_counter()

        with record_function("Preprocessing"):
            t0 = time.perf_counter()
            host = load_video_array_u8(frames_dir, cfg.num_frames, cfg.image_size)
            host = np.repeat(host, self.batch, axis=0)
            row["preprocess_ms"] = (time.perf_counter() - t0) * 1000

            t0 = time.perf_counter()
            video = torch.from_numpy(host).to(self.device)
            sync()
            row["preprocess_device_ms"] = (time.perf_counter() - t0) * 1000

        if self._encode is None:
            self._encode = graphed(self._encode_fn, video)
        clock = self.clock
        with record_function("ViT_Encoder"):
            a = clock.mark()
            emb = self._encode(video)
            b = clock.mark()

        if self._align is None:
            self._align = graphed(self._align_fn, emb)
        with record_function("Cross_Modal_Alignment"):
            prefix = self._align(emb)
            c = clock.mark()

        if self._prefill is None:
            self._prefill = graphed(self._prefill_fn, prefix)
        tok, cache, valid = self._prefill(prefix)
        if not clock.cuda:
            self._steps = []        # uncaptured: the steps take this iteration's cache
        tokens, token_marks = [tok], []
        for t in range(self.max_new - 1):
            if len(self._steps) == t:
                self._steps.append(graphed(self._step_fn(t, cache, valid), tok))
            with record_function("GPT2_Decoder_Step"):
                start = clock.mark()
                tok = self._steps[t](tok)
                token_marks.append((start, clock.mark()))
            tokens.append(tok)
        gen = torch.stack(tokens, dim=1).cpu().numpy()   # [B, max_new]; waits for the device
        end = clock.mark()
        sync()
        row["vit_ms"] = clock.ms(a, b)
        row["cross_modal_ms"] = clock.ms(b, c)
        row["gpt2_ms"] = clock.ms(c, end)
        token_times = [clock.ms(s, e) for s, e in token_marks]
        row["gpt2_token_step_ms"] = float(np.mean(token_times)) if token_times else 0.0

        row["end_to_end_ms"] = (time.perf_counter() - t_all) * 1000
        row["throughput_samples_s"] = self.batch / (row["end_to_end_ms"] / 1000)

        eos = self.tokenizer.eos_token_id
        lengths = []
        for r in gen:
            stop = np.where(r == eos)[0]
            lengths.append(int(stop[0]) + 1 if len(stop) else len(r))
        row["generated_tokens"] = int(np.mean(lengths))
        row["caption_preview"] = self.tokenizer.decode(gen[0])[:60].replace("\n", " ")
        self.last_ids = gen

        snap = self.memory.snapshot()
        row["peak_memory_mb"] = round(snap.peak_bytes_in_use / 2**20, 1) if snap.peak_bytes_in_use else ""
        return row


def benchmark_one_batch_size(
    config: InferenceConfig, frames_dir: str, batch_size: int,
    warmup: int, iters: int, max_new_tokens: int, **bench_kw,
) -> Dict:
    """``bench_kw``: StageBench's params, model_cfg, device, seed."""
    bench = StageBench(config, batch_size, max_new_tokens, **bench_kw)
    for _ in range(warmup):
        bench.run_iteration(frames_dir)
    rows = [bench.run_iteration(frames_dir) for _ in range(iters)]
    for i, row in enumerate(rows):
        row["iteration"] = i
    return {"rows": rows, "bench": bench}


def run_sweep(
    config: InferenceConfig, frames_dir: str, batch_sizes: List[int],
    warmup: int, iters: int, max_new_tokens: int, out_dir: Path, tag: str = "", **bench_kw,
) -> Dict:
    per_bs = []
    all_rows: List[Dict] = []
    summary_per_bs = {}
    device = bench_kw.get("device", "cuda")
    for bs in batch_sizes:
        try:
            result = benchmark_one_batch_size(config, frames_dir, bs, warmup, iters,
                                              max_new_tokens, **bench_kw)
        except Exception as err:
            if is_oom_error(err):
                log.warning("batch %d OOM; stopping sweep (reference contract)", bs)
                per_bs.append({"batch_size": bs, "status": "OOM"})
                break
            raise
        rows = result["rows"]
        all_rows.extend(rows)
        stats = {
            "batch_size": bs, "status": "ok",
            "end_to_end_mean_ms": float(np.mean([r["end_to_end_ms"] for r in rows])),
            "end_to_end_std_ms": float(np.std([r["end_to_end_ms"] for r in rows])),
            "vit_mean_ms": float(np.mean([r["vit_ms"] for r in rows])),
            "cross_modal_mean_ms": float(np.mean([r["cross_modal_ms"] for r in rows])),
            "gpt2_mean_ms": float(np.mean([r["gpt2_ms"] for r in rows])),
            "gpt2_token_step_mean_ms": float(np.mean([r["gpt2_token_step_ms"] for r in rows])),
            "throughput_mean": float(np.mean([r["throughput_samples_s"] for r in rows])),
            "throughput_std": float(np.std([r["throughput_samples_s"] for r in rows])),
            "peak_memory_mb": rows[-1].get("peak_memory_mb", ""),
        }
        per_bs.append(stats)
        summary_per_bs[str(bs)] = stats
        log.info("bs=%d e2e=%.1fms tok=%.2fms tput=%.2f/s", bs,
                 stats["end_to_end_mean_ms"], stats["gpt2_token_step_mean_ms"],
                 stats["throughput_mean"])

    suffix = f"_{tag}" if tag else ""
    rpt.write_iteration_csv(out_dir / f"baseline_iterations{suffix}.csv", all_rows)
    rpt.write_bs_comparison(out_dir / f"benchmark_bs_comparison{suffix}.csv", per_bs)

    bs1_rows = [r for r in all_rows if r["batch_size"] == batch_sizes[0]]
    stages = {
        "preprocess": [r["preprocess_ms"] for r in bs1_rows],
        "preprocess_device": [r["preprocess_device_ms"] for r in bs1_rows],
        "vit": [r["vit_ms"] for r in bs1_rows],
        "cross_modal": [r["cross_modal_ms"] for r in bs1_rows],
        "gpt2": [r["gpt2_ms"] for r in bs1_rows],
        "gpt2_token_step": [r["gpt2_token_step_ms"] for r in bs1_rows],
        "end_to_end": [r["end_to_end_ms"] for r in bs1_rows],
    }
    summary = rpt.build_summary(
        stages,
        [r["throughput_samples_s"] for r in bs1_rows],
        env=device_summary(device),
        config={**dataclasses.asdict(config), "batch_size": batch_sizes[0],
                "warmup": warmup, "iters": iters, "max_new_tokens": max_new_tokens},
        generated_tokens=[r["generated_tokens"] for r in bs1_rows],
        caption_preview=bs1_rows[-1]["caption_preview"] if bs1_rows else "",
    )
    rpt.write_json(out_dir / f"baseline_summary{suffix}.json", summary)
    rpt.write_json(out_dir / f"benchmark_bs_summary{suffix}.json", summary_per_bs)
    return summary


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser()
    p.add_argument("--frames_dir", default="")
    p.add_argument("--ckpt", default="")
    p.add_argument("--batch-sizes", default="1,2,4,8,12,16")
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--max_new_tokens", type=int, default=24)
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--out_dir", default="reports/torch")
    args = p.parse_args(argv)

    overrides = {"num_frames": args.num_frames}
    if args.ckpt:
        overrides["ckpt"] = args.ckpt
    config = default_inference_config(**overrides)
    config = dataclasses.replace(
        config, compile=dataclasses.replace(config.compile, dtype=args.dtype)
    )

    frames_dir = args.frames_dir or _make_synth_frames()

    # the deployment default (bf16) writes the plain file names
    # (baseline_summary.json, ...); fp32 gets a suffix
    tag = "" if args.dtype == "bfloat16" else "fp32"
    run_sweep(
        config, frames_dir, [int(b) for b in args.batch_sizes.split(",")],
        args.warmup, args.iters, args.max_new_tokens, Path(args.out_dir), tag=tag,
    )
    return 0


def _make_synth_frames() -> str:
    import tempfile

    from PIL import Image

    d = tempfile.mkdtemp(prefix="vct_bench_frames_")
    rng = np.random.RandomState(0)
    for i in range(40):
        Image.fromarray(rng.randint(0, 255, (240, 320, 3), np.uint8)).save(
            f"{d}/frame_{i:05d}.jpg", quality=95
        )
    return d


if __name__ == "__main__":
    raise SystemExit(main())
