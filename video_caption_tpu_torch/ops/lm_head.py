"""LM head with the decode step's selection statistics (kernel K3).

Counterpart of video_caption_tpu/ops/pallas/lm_head.py. The CUDA kernel is
``csrc/lm_head.cu``; ``lm_head_stats_ref`` is the plain PyTorch version, the
mirror of the XLA body of ``gpt2.lm_stats``.

The window of 128 columns is part of the selection algorithm: the window
maxima feed ``logits_process.exact_topk``'s two-stage top-k.
"""
from __future__ import annotations

import itertools
from typing import Tuple

import torch

from video_caption_tpu_torch.ops import build

WINDOW = 128

launches = 0
"""Number of times ``lm_head_stats`` launched its CUDA kernels."""

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def lm_head_stats_ref(x: torch.Tensor, wte_t: torch.Tensor, vocab_size: int) -> Stats:
    """(logits [R,Vp] f32 with -inf pad columns, wmax [R,Vp/128], m [R], l [R]).

    The product takes both operands in f32: products of bf16 values are exact
    in f32, so this equals a bf16 product with f32 accumulation up to
    summation order."""
    logits = x.float() @ wte_t.float()
    r, vp = logits.shape
    if vp != vocab_size:
        col = torch.arange(vp, device=x.device)
        logits = torch.where(col < vocab_size, logits, float("-inf"))
    wmax = logits.reshape(r, vp // WINDOW, WINDOW).amax(dim=-1)
    m = logits.amax(dim=-1)
    l = torch.exp(logits - m[:, None]).sum(dim=-1)
    return logits, wmax, m, l


def lm_head_stats(x: torch.Tensor, wte_t: torch.Tensor, vocab_size: int) -> Stats:
    """x [R, H] @ wte_t [H, Vp] with the selection statistics.

    CPU tensors take the plain version; CUDA tensors launch the kernel, which
    takes x and wte_t of one dtype (float32 or bfloat16), Vp a multiple of 128
    and any R (in bf16, H a multiple of 8 and both tensors 16-byte aligned),
    and raises on anything else. In bf16 the kernel reads wte_t once per call
    up to R = 256, and once per 256 rows above that."""
    global launches
    if x.device.type == "cpu":
        return lm_head_stats_ref(x, wte_t, vocab_size)
    build.require_cuda(x, "x")
    build.require_cuda(wte_t, "wte_t")
    if x.dtype != wte_t.dtype:
        raise TypeError(f"x and wte_t must share a dtype, got {x.dtype} and {wte_t.dtype}")
    if x.ndim != 2 or wte_t.ndim != 2 or x.shape[1] != wte_t.shape[0]:
        raise ValueError(f"shapes x {tuple(x.shape)} and wte_t {tuple(wte_t.shape)} do not match")
    r, h = x.shape
    vp = wte_t.shape[1]
    if vp % WINDOW or not 0 < vocab_size <= vp:
        raise ValueError(f"padded vocab {vp} must be a multiple of {WINDOW} holding {vocab_size}")
    if x.dtype == torch.bfloat16 and (h % 8 or x.data_ptr() % 16 or wte_t.data_ptr() % 16):
        raise ValueError("bf16 x and wte_t must be 16-byte aligned with H a multiple of 8")
    # the five f32 outputs (the third the kernel's lpart) in one allocation,
    # their views taken after the launch: the decode loop that calls this is
    # bound by the host's time per call
    nwin = vp // WINDOW
    sizes = (r * vp, r * nwin, r * nwin, r, r)
    buf = torch.empty(sum(sizes), dtype=torch.float32, device=x.device)
    if r:
        ptrs = [buf.data_ptr() + 4 * o for o in itertools.accumulate(sizes[:-1], initial=0)]
        build.launch("vct_lm_head_stats", x.data_ptr(), wte_t.data_ptr(), *ptrs,
                     r, h, vp, vocab_size, build.dtype_code(x.dtype), build.stream_of(x))
        launches += 1
    logits, wmax, _, m, l = buf.split(sizes)
    return logits.view(r, vp), wmax.view(r, nwin), m, l
