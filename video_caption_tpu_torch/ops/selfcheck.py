"""On-card checks of the four CUDA kernels against their plain PyTorch
versions, at the shapes the caption main path gives them.

Each check builds seeded inputs on a CUDA device, runs the kernel wrapper and
the plain version on the same tensors, and returns the largest absolute
error beside the tolerance it is held to, and the median time of each (CUDA
events, one launch per timed run). ``chip_smoke.py`` and
``tests/test_torch_cuda_kernels.py`` both use these. The launches made here
count in the wrappers' ``launches``; a caller that reads the counts of a main
path run resets them after these checks.

Tolerances (elementwise ``|kernel - plain| <= atol + rtol * |plain|``):

- encoder_attention, beam_attention: bf16 outputs of O(1). Both sides round
  the probabilities and the output to bf16 at the same points, but sum in
  another order, so a value can land one bf16 step (2^-8 relative) apart:
  atol = rtol = 1e-2.
- prefix_projector: f32 out of f32 sums over 256 products: 1e-4 / 1e-4.
- lm_head: f32 logits and statistics out of f32 sums over 768 products of
  bf16 values: 1e-4 / 1e-4 (l: rtol 1e-4).
"""
from __future__ import annotations

import statistics
from dataclasses import asdict, dataclass
from typing import Callable, List

import torch

from video_caption_tpu_torch.ops import beam_attention as ba
from video_caption_tpu_torch.ops import encoder_attention as ea
from video_caption_tpu_torch.ops import lm_head as lmh
from video_caption_tpu_torch.ops import prefix_projector as pp

KERNELS = {
    # name: (route, source, the TPU kernel it replaces (the function that
    # reaches pl.pallas_call), module)
    "encoder_attention": ("cuda", "video_caption_tpu_torch/ops/csrc/encoder_attention.cu",
                          "video_caption_tpu/ops/pallas/encoder_attention.py:75", ea),
    "prefix_projector": ("cuda", "video_caption_tpu_torch/ops/csrc/prefix_projector.cu",
                         "video_caption_tpu/ops/pallas/prefix_projector.py:38", pp),
    "lm_head": ("cuda", "video_caption_tpu_torch/ops/csrc/lm_head.cu",
                "video_caption_tpu/ops/pallas/lm_head.py:134", lmh),
    "beam_attention": ("cuda", "video_caption_tpu_torch/ops/csrc/beam_attention.cu",
                       "video_caption_tpu/ops/pallas/beam_attention.py:215", ba),
}

TOLERANCES = {
    "encoder_attention": (1e-2, 1e-2),
    "prefix_projector": (1e-4, 1e-4),
    "lm_head": (1e-4, 1e-4),
    "beam_attention": (1e-2, 1e-2),
}


@dataclass
class CheckResult:
    name: str
    shape: str
    max_abs_err: float
    atol: float
    rtol: float
    ok: bool
    ms: float
    plain_ms: float

    def as_dict(self) -> dict:
        return asdict(self)


def median_ms(fn: Callable[[], object], runs: int = 25, warmup: int = 3) -> float:
    """Median over ``runs`` of one call's device time (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _compare(name: str, got, want) -> tuple:
    atol, rtol = TOLERANCES[name]
    errs, ok = [], True
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        finite = torch.isfinite(w)
        ok &= bool(torch.equal(torch.isfinite(g), finite))
        diff = (g - w).abs()[finite]
        errs.append(float(diff.max()) if diff.numel() else 0.0)
        ok &= bool((diff <= atol + rtol * w.abs()[finite]).all())
    return max(errs), ok


def _result(name, shape, got, want, kernel_fn, plain_fn) -> CheckResult:
    torch.cuda.synchronize()
    err, ok = _compare(name, got, want)
    atol, rtol = TOLERANCES[name]
    return CheckResult(name, shape, err, atol, rtol, ok, median_ms(kernel_fn),
                       median_ms(plain_fn))


def _gen(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def check_encoder_attention(frames: int, device="cuda", seq: int = 197, heads: int = 12,
                            seed: int = 0) -> CheckResult:
    g = _gen(device, seed)
    qkv = torch.randn((frames, seq, 3 * heads * 64), generator=g, device=device).bfloat16()
    got = ea.encoder_attention(qkv, heads)
    want = ea.encoder_attention_ref(qkv, heads)
    return _result("encoder_attention", f"qkv[{frames},{seq},{3 * heads * 64}] bf16",
                   [got], [want], lambda: ea.encoder_attention(qkv, heads),
                   lambda: ea.encoder_attention_ref(qkv, heads))


def check_prefix_projector(rows: int, device="cuda", din: int = 256, dout: int = 3072,
                           seed: int = 1) -> CheckResult:
    g = _gen(device, seed)
    x = torch.randn((rows, din), generator=g, device=device) * 0.4
    w = (torch.randn((din, dout), generator=g, device=device) * 0.02).bfloat16()
    b = (torch.randn((dout,), generator=g, device=device) * 0.02).bfloat16()
    got = pp.prefix_project(x, w, b)
    want = pp.prefix_project_ref(x, w, b)
    return _result("prefix_projector", f"x[{rows},{din}] f32 @ w[{din},{dout}] bf16",
                   [got], [want], lambda: pp.prefix_project(x, w, b),
                   lambda: pp.prefix_project_ref(x, w, b))


def check_lm_head(rows: int, device="cuda", h: int = 768, vocab: int = 50257,
                  seed: int = 2) -> CheckResult:
    g = _gen(device, seed)
    vp = -(-vocab // lmh.WINDOW) * lmh.WINDOW
    x = torch.randn((rows, h), generator=g, device=device).bfloat16()
    w = (torch.randn((h, vp), generator=g, device=device) * 0.02).bfloat16()
    w[:, vocab:] = 0
    got = lmh.lm_head_stats(x, w, vocab)
    want = lmh.lm_head_stats_ref(x, w, vocab)
    return _result("lm_head", f"x[{rows},{h}] @ wte_t[{h},{vp}] bf16, vocab {vocab}",
                   got, want, lambda: lmh.lm_head_stats(x, w, vocab),
                   lambda: lmh.lm_head_stats_ref(x, w, vocab))


def check_beam_attention(videos: int, beams: int, prefill: int, steps: int, t: int,
                         device="cuda", heads: int = 12, seed: int = 3) -> CheckResult:
    g = _gen(device, seed)
    h, r = heads * 64, videos * beams
    q = torch.randn((r, 3 * h), generator=g, device=device).bfloat16()[:, :h]  # strided rows
    gkv = torch.randn((steps, 2, r, h), generator=g, device=device).bfloat16()
    pk = torch.randn((videos, prefill, h), generator=g, device=device).bfloat16()
    pv = torch.randn((videos, prefill, h), generator=g, device=device).bfloat16()
    valid = torch.ones((videos, prefill), dtype=torch.int32, device=device)
    valid[0, : prefill // 4] = 0                        # a left-padded first video
    own = torch.randint(0, beams, (r, steps), generator=g, device=device)
    anc = ((torch.arange(r, device=device)[:, None] // beams) * beams + own).to(torch.int32)
    args = (q, gkv, pk, pv, valid, anc, t, beams, heads)
    got = ba.beam_attention(*args)
    want = ba.beam_attention_ref(*args)
    return _result("beam_attention", f"R={r} (B={videos},K={beams}) S0={prefill} N={steps} t={t} bf16",
                   [got], [want], lambda: ba.beam_attention(*args),
                   lambda: ba.beam_attention_ref(*args))


def main_path_checks(device="cuda") -> List[CheckResult]:
    """Every kernel at the main path's shapes; the first check of each kernel
    is the single-request shape whose times chip_smoke.py reports."""
    out = []
    out += [check_encoder_attention(n, device) for n in (16, 128)]
    out += [check_prefix_projector(b, device) for b in (1, 8)]
    out += [check_lm_head(r, device) for r in (6, 1, 9, 192)]
    for videos, beams, prefill, steps in ((2, 3, 48, 24), (1, 4, 48, 40)):
        out += [check_beam_attention(videos, beams, prefill, steps, t, device)
                for t in (steps // 2, 0, steps - 1)]
    return out
