"""On-card checks of the seven CUDA kernels against their plain PyTorch
versions, at the shapes the caption main path (and its two fused-decode
configurations) and the two trainers give them, and of the backward passes
of the three differentiable kernels.

Each check builds seeded inputs on a CUDA device, runs the kernel wrapper and
the plain version on the same tensors, and returns the largest absolute
error beside the tolerance it is held to, the median device time of each
(CUDA events around one call, the stream held by a spin kernel while the
host enqueues it, so the host's time to issue the call is not counted),
the time of one PyTorch call computing
the same function where there is one (``library_ms``; the port never calls
it), and the bound: the least time the card could take for the same work,
the larger of the bytes the function must move (each input read once, each
output written once; where the work depends on the data, what these inputs
need) over 3.35 TB/s and its operations over the H100's dense peak for the
operands' type (989 TFLOP/s bf16, 67 TFLOP/s f32; NVIDIA's data sheet; the
f32 encoder attention runs each f32 product as three TF32 products on the
tensor cores, so its bound counts three times the operations at 495
TFLOP/s, the least time either way).
``chip_smoke.py`` and ``tests/test_torch_cuda_kernels.py`` both use these.
The launches made here count in the wrappers' ``launches``; a caller that
reads the counts of a main path run resets them after these checks.

Tolerances (elementwise ``|kernel - plain| <= atol + rtol * |plain|``):

- encoder_attention, beam_attention (both modes), decode_attention, and
  decode_layer over one layer: bf16 outputs of O(1). Both sides round at the same points
  but sum in another order, so a value can land one bf16 step (2^-8
  relative) apart: atol = rtol = 1e-2.
- beam_attention in f32: f32 sums over 64 dims and up to ~200 columns in
  another order: 1e-4 / 1e-4; decode_attention in f32 likewise over up to
  L columns.
- encoder_attention in f32: 3xTF32 products (each f32 product to about
  2^-20 relative) and f32 sums over 64 dims and 197 keys in another order:
  1e-4 / 1e-4.
- prefix_projector: f32 out of f32 sums over 256 products: 1e-4 / 1e-4.
- lm_head: f32 logits and statistics out of f32 sums over 768 products of
  bf16 values: 1e-4 / 1e-4 (l: rtol 1e-4).
- decode_layer over all 12 layers in bf16: a value one bf16 step apart after
  one layer moves the next layer's LayerNorm, products and softmax, and the
  steps cascade through the residual stream. Emulated on a CPU (the plain
  step against itself with float64 in place of f32 sums, the inputs of
  ``decode_layer_case``) the cascade reaches 0.08 on values up to 6.5, over
  the elementwise bound; no summation order meets it. So the 12-layer bf16
  step is held to 5e-2 of the largest plain value (``atol_of_max``: the
  bound chip_smoke.py holds bf16 to against f32 through 12 layers), beside
  the elementwise 1e-2 / 1e-2 over one layer and 1e-4 / 1e-4 for all 12
  layers in f32 (the same emulation: 3.7e-6), which checks the layer loop,
  the barriers and the cache addressing of every layer.
- fused_pool: f32 means of O(1) values over up to 8 x 196 rows, summed in
  another order than the plain version (one sum over a video's rows against
  per-frame means): 1e-5 / 1e-5; in bf16 the output rounds to a bf16 step:
  1e-2 / 1e-2.

Backward checks (``check_*_backward``) hold the input gradients of each
``autograd.Function`` (the kernel's forward, its closed-form backward)
against ``torch.autograd.grad`` through the plain version, as the largest
error relative to the largest gradient value: encoder_attention 1e-4 in f32
(the same rounding points, f32 sums over 197 rows in another order) and
2e-2 in bf16 (dV and dP are products in bf16); fused_pool and
prefix_projector 1e-5 (f32; the same divisions, and f32 sums over at most
3072 products).
"""
from __future__ import annotations

import statistics
from dataclasses import asdict, dataclass
from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F

from video_caption_tpu_torch.ops import beam_attention as ba
from video_caption_tpu_torch.ops import decode_attention as da
from video_caption_tpu_torch.ops import decode_layer as dl
from video_caption_tpu_torch.ops import encoder_attention as ea
from video_caption_tpu_torch.ops import fused_pool as fpl
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
    "decode_attention": ("cuda", "video_caption_tpu_torch/ops/csrc/decode_attention.cu",
                         "video_caption_tpu/ops/pallas/decode_attention.py:45", da),
    "decode_layer": ("cuda", "video_caption_tpu_torch/ops/csrc/decode_layer.cu",
                     "video_caption_tpu/ops/pallas/decode_layer.py:153", dl),
    "fused_pool": ("cuda", "video_caption_tpu_torch/ops/csrc/fused_pool.cu",
                   "video_caption_tpu/ops/pallas/fused_pool.py:77", fpl),
}
DEFAULT_PATH = ("encoder_attention", "prefix_projector", "lm_head", "beam_attention")
"""The kernels of the default configuration; decode_attention and
decode_layer run only with their compile switches."""
MAPPER_TRAINING_PATH = ("encoder_attention", "prefix_projector")
"""The kernels of a mapper-trainer step (the encoder frozen, forward only)."""
JOINT_TRAINING_PATH = ("encoder_attention", "fused_pool")
"""The kernels of a stage-1 joint step with ``pool="gap"`` (forward, and
again in the remat recompute)."""

TOLERANCES = {
    "encoder_attention": (1e-2, 1e-2),
    "prefix_projector": (1e-4, 1e-4),
    "lm_head": (1e-4, 1e-4),
    "beam_attention": (1e-2, 1e-2),
    "decode_attention": (1e-2, 1e-2),
    "decode_layer": (1e-2, 1e-2),
    "fused_pool": (1e-5, 1e-5),
}
BACKWARD_TOLERANCES = {           # largest error / largest gradient value
    ("encoder_attention", torch.float32): 1e-4,
    ("encoder_attention", torch.bfloat16): 2e-2,
    ("fused_pool", torch.float32): 1e-5,
    ("prefix_projector", torch.float32): 1e-5,
}

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, "3xtf32": 495e12}


@dataclass
class CheckResult:
    name: str
    shape: str
    max_abs_err: float
    atol: float
    rtol: float
    atol_of_max: bool
    ok: bool
    ms: float
    plain_ms: float
    library_ms: Optional[float]
    bytes: int
    flops: int
    bound_ms: float
    bound_by: str

    def as_dict(self) -> dict:
        return asdict(self)


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_: int, flops: int, dtype: torch.dtype) -> tuple:
    """(least ms, "bytes" or "operations") for moving ``bytes_`` and doing
    ``flops`` operations on operands of ``dtype`` (a torch dtype, or "3xtf32"
    for TF32 products) on one H100."""
    by_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


HOLD_CYCLES = 1_000_000
"""Cycles of the spin kernel that holds the stream before each timed call
(~0.5 ms at the H100's clock)."""
FLUSH_BYTES = 256 * 2**20
"""Bytes written before each cold run: five times the H100's 50 MB L2."""
_flush: Optional[torch.Tensor] = None


def median_ms(fn: Callable[[], object], runs: int = 25, warmup: int = 3,
              hold: bool = True, cold: bool = False, dirty: bool = False) -> float:
    """Median over ``runs`` of one call's device time (CUDA events). Before
    each run a spin kernel holds the stream while the host enqueues the
    start event, the call and the end event, so the interval is the
    device's time for the call and not the host's time to issue it (a call
    whose host side takes longer than the spin still shows the rest).
    ``hold=False`` leaves out the spin: the interval then holds the host's
    time to issue the call wherever that is the longer (one launch as the
    caller sees it). ``cold=True`` writes FLUSH_BYTES before each run (before
    the spin) and reads them back, so the call finds its inputs in device
    memory, not in L2, and L2 holds only clean lines; with ``dirty=True`` the
    read-back is left out, and the call also writes back up to 50 MB of the
    flush's dirty lines as its reads evict them."""
    global _flush
    if cold and _flush is None:
        _flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if cold:
            _flush.fill_(1)
            if not dirty:
                _flush.view(torch.int32).max()
        if hold:
            torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _compare(got, want, atol: float, rtol: float, atol_of_max: bool) -> tuple:
    """(largest |got - want|, whether every element is within atol + rtol *
    |want|; with atol_of_max, atol counts in units of max |want| of its
    tensor)."""
    errs, ok = [], True
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        finite = torch.isfinite(w)
        ok &= bool(torch.equal(torch.isfinite(g), finite))
        diff = (g - w).abs()[finite]
        errs.append(float(diff.max()) if diff.numel() else 0.0)
        a = atol * float(w.abs()[finite].max()) if atol_of_max and diff.numel() else atol
        ok &= bool((diff <= a + rtol * w.abs()[finite]).all())
    return max(errs), ok


def _result(name, shape, got, want, kernel_fn, plain_fn, work, library_fn=None,
            tol=None) -> CheckResult:
    """``work`` = (bytes, flops, operand dtype) of the function at this shape;
    ``tol`` = (atol, rtol, atol_of_max) where it differs from TOLERANCES."""
    torch.cuda.synchronize()
    atol, rtol, of_max = tol or (*TOLERANCES[name], False)
    err, ok = _compare(got, want, atol, rtol, of_max)
    bytes_, flops, dtype = work
    bound_ms, bound_by = bound(bytes_, flops, dtype)
    return CheckResult(name, shape, err, atol, rtol, of_max, ok, median_ms(kernel_fn),
                       median_ms(plain_fn), median_ms(library_fn) if library_fn else None,
                       bytes_, flops, bound_ms, bound_by)


def _gen(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def check_encoder_attention(frames: int, device="cuda", seq: int = 197, heads: int = 12,
                            dtype=torch.bfloat16, seed: int = 0) -> CheckResult:
    """The forward; in f32 the kernel runs 3xTF32 (three TF32 products per
    f32 product) on the tensor cores, so its operations bound counts those
    at the TF32 rate."""
    g = _gen(device, seed)
    qkv = torch.randn((frames, seq, 3 * heads * 64), generator=g, device=device).to(dtype)
    got = ea.encoder_attention(qkv, heads)
    want = ea.encoder_attention_ref(qkv, heads)
    q, k, v = qkv.view(frames, seq, 3, heads, 64).permute(2, 0, 3, 1, 4)
    flops = 4 * frames * heads * seq * seq * 64
    if dtype == torch.float32:
        work, tol, kind = (nbytes(qkv, got), 3 * flops, "3xtf32"), (1e-4, 1e-4, False), "f32"
    else:
        work, tol, kind = (nbytes(qkv, got), flops, dtype), None, "bf16"
    return _result("encoder_attention", f"qkv[{frames},{seq},{3 * heads * 64}] {kind}",
                   [got], [want], lambda: ea.encoder_attention(qkv, heads),
                   lambda: ea.encoder_attention_ref(qkv, heads), work,
                   lambda: F.scaled_dot_product_attention(q, k, v), tol=tol)


def check_prefix_projector(rows: int, device="cuda", din: int = 256, dout: int = 3072,
                           seed: int = 1) -> CheckResult:
    g = _gen(device, seed)
    x = torch.randn((rows, din), generator=g, device=device) * 0.4
    w = (torch.randn((din, dout), generator=g, device=device) * 0.02).bfloat16()
    b = (torch.randn((dout,), generator=g, device=device) * 0.02).bfloat16()
    got = pp.prefix_project(x, w, b)
    want = pp.prefix_project_ref(x, w, b)
    w32, b32 = w.float(), b.float()      # addmm takes one dtype: upcast outside the timing
    work = (nbytes(x, w, b, got), 2 * rows * din * dout, x.dtype)
    return _result("prefix_projector", f"x[{rows},{din}] f32 @ w[{din},{dout}] bf16",
                   [got], [want], lambda: pp.prefix_project(x, w, b),
                   lambda: pp.prefix_project_ref(x, w, b), work,
                   lambda: torch.addmm(b32, x, w32))


def check_lm_head(rows: int, device="cuda", h: int = 768, vocab: int = 50257,
                  pad_windows: int = 0, seed: int = 2) -> CheckResult:
    """``pad_windows`` whole windows of pad columns past the one that holds
    the last word (their wmax -inf, no share of l)."""
    g = _gen(device, seed)
    vp = (-(-vocab // lmh.WINDOW) + pad_windows) * lmh.WINDOW
    x = torch.randn((rows, h), generator=g, device=device).bfloat16()
    w = (torch.randn((h, vp), generator=g, device=device) * 0.02).bfloat16()
    w[:, vocab:] = 0
    got = lmh.lm_head_stats(x, w, vocab)
    want = lmh.lm_head_stats_ref(x, w, vocab)
    work = (nbytes(x, w, *got), 2 * rows * h * vp, x.dtype)
    return _result("lm_head", f"x[{rows},{h}] @ wte_t[{h},{vp}] bf16, vocab {vocab}",
                   got, want, lambda: lmh.lm_head_stats(x, w, vocab),
                   lambda: lmh.lm_head_stats_ref(x, w, vocab), work,
                   lambda: torch.matmul(x, w))      # the logits only, no statistics


def beam_attention_case(videos: int, beams: int, prefill: int, steps: int, device="cuda",
                        heads: int = 12, dtype=torch.bfloat16, seed: int = 3,
                        live: Optional[Sequence[int]] = None):
    """Seeded inputs of one layer of a beam step: q, k_new, v_new [R, H] as
    the strided thirds of one fused [R, 3H] QKV output, gkv [N, 2, R, H],
    pk/pv [B, S0, H], valid [B, S0] (the first video left-padded by a
    quarter), anc [R, N] rows of the row's own video (block). ``live``
    gives the unified decode's layout (decode/unified.py): per block, its
    live rows; a block's first ``live[b]`` rows (more than one: a beam
    group) draw their ancestors among themselves, and the rest, like the
    one row of a sampled block (``live[b]`` 1), keep identity ancestry."""
    g = _gen(device, seed)
    h, r = heads * 64, videos * beams
    qkv = torch.randn((r, 3 * h), generator=g, device=device).to(dtype)
    gkv = torch.randn((steps, 2, r, h), generator=g, device=device).to(dtype)
    pk = torch.randn((videos, prefill, h), generator=g, device=device).to(dtype)
    pv = torch.randn((videos, prefill, h), generator=g, device=device).to(dtype)
    valid = torch.ones((videos, prefill), dtype=torch.int32, device=device)
    valid[0, : prefill // 4] = 0
    rows = torch.arange(r, device=device)
    live_of = torch.full((r,), beams, device=device) if live is None else \
        torch.tensor(live, device=device).repeat_interleave(beams)
    own = (torch.rand((r, steps), generator=g, device=device) * live_of[:, None]).long()
    anc = (rows[:, None] // beams) * beams + own
    identity = (live_of == 1) | (rows % beams >= live_of)
    anc = torch.where(identity[:, None], rows[:, None], anc).to(torch.int32)
    return qkv[:, :h], qkv[:, h:2 * h], qkv[:, 2 * h:], gkv, pk, pv, valid, anc


def check_beam_attention(videos: int, beams: int, prefill: int, steps: int, t: int,
                         device="cuda", heads: int = 12, deferred: bool = False,
                         dtype=torch.bfloat16, seed: int = 3,
                         live: Optional[Sequence[int]] = None) -> CheckResult:
    """One call of either mode; in f32 held to 1e-4 / 1e-4 (f32 sums over
    64 dims and the columns in another order). ``live``: the unified
    decode's blocks (``beam_attention_case``)."""
    q, k_new, v_new, gkv, pk, pv, valid, anc = beam_attention_case(
        videos, beams, prefill, steps, device, heads, dtype, seed, live)
    r, h = q.shape
    args = (q, gkv, pk, pv, valid, anc, t, beams, heads)
    kw = dict(k_new=k_new, v_new=v_new) if deferred else {}
    got = ba.beam_attention(*args, **kw)
    want = ba.beam_attention_ref(*args, **kw)
    # what this input needs: the visible prefill rows of each video, the
    # distinct generated (step, writer row) columns the ancestry reaches
    # (steps before t when deferred) and, deferred, the self column's k_new
    # and v_new rows
    read = t if deferred else t + 1
    vis = valid.sum(dim=1).repeat_interleave(beams)                     # [R]
    gen_cols = torch.unique(anc[:, :read].long()
                            + torch.arange(read, device=device) * r).numel()
    rows = int(valid.sum()) + gen_cols + (r if deferred else 0)
    bytes_ = (r * h + 2 * h * rows) * q.element_size() + nbytes(valid, anc[:, :read], got)
    work = (bytes_, 4 * h * int((vis + read + int(deferred)).sum()), q.dtype)
    kind = "f32" if dtype == torch.float32 else "bf16"
    tol = (1e-4, 1e-4, False) if dtype == torch.float32 else None
    blocks = "" if live is None else f" unified live {tuple(live)}"
    return _result("beam_attention", f"R={r} (B={videos},K={beams}) S0={prefill} N={steps} t={t} "
                   f"{kind}{' deferred' if deferred else ''}{blocks}",
                   [got], [want], lambda: ba.beam_attention(*args, **kw),
                   lambda: ba.beam_attention_ref(*args, **kw), work, tol=tol)


def decode_attention_case(batch: int, length: int, device="cuda", heads: int = 12,
                          dtype=torch.bfloat16, seed: int = 4, empty_row: bool = False,
                          stale: bool = False):
    """Seeded inputs of one layer of the sampled decode step: q a slice of
    the fused QKV output, K and V strided views of one layer of the
    interleaved [B, L, 2, nh, hd] cache; the last quarter of the columns not
    yet written and the first row left-padded by 3 (``empty_row``: no
    visible column in the first row at all). ``stale``: every column that is
    not visible holds 1e4 in K and V. Returns (q, k, v, valid)."""
    g = _gen(device, seed)
    qkv = torch.randn((batch, 3, heads, 64), generator=g, device=device).to(dtype)
    kv = torch.randn((batch, length, 2, heads, 64), generator=g, device=device).to(dtype)
    valid = torch.ones((batch, length), dtype=torch.int32, device=device)
    valid[:, length - length // 4:] = 0
    valid[0, :3] = 0
    if empty_row:
        valid[0] = 0
    if stale:
        kv[valid == 0] = 1e4
    return qkv[:, 0], kv[:, :, 0], kv[:, :, 1], valid


def check_decode_attention(batch: int, length: int, device="cuda", heads: int = 12,
                           seed: int = 4, dtype=torch.bfloat16, empty_row: bool = False,
                           stale: bool = False, splits: Optional[int] = None,
                           stage_rows: Optional[int] = None) -> CheckResult:
    """One call on ``decode_attention_case``'s inputs; ``splits`` /
    ``stage_rows`` launch a geometry other than the plan's (through the
    wrapper's ``_launch``). In f32 held to 1e-4 / 1e-4 (f32 sums over 64
    dims and L columns in another order)."""
    q, k, v, valid = decode_attention_case(batch, length, device, heads, dtype, seed,
                                           empty_row, stale)
    h = heads * 64
    p, forced = None, ""
    if splits is not None or stage_rows is not None:
        p = da.plan(batch, heads, length, q.element_size(), splits=splits,
                    stage_rows=stage_rows)
        strides = da._check(q, k, v, valid)
        forced = f", {p.splits} splits x {p.stage_rows} staged rows"

    def kernel():
        if p is None:
            return da.decode_attention(q, k, v, valid)
        return da._launch(q, k, v, valid, p, strides)

    got = kernel()
    want = da.decode_attention_ref(q, k, v, valid)
    # what this input needs: q, valid, the output, the visible K and V rows,
    # and every V row of a row with no visible column (their mean)
    live = int(valid.sum())
    blind = int((valid.sum(dim=1) == 0).sum()) * length
    work = (nbytes(q, valid, got) + (2 * live + blind) * h * q.element_size(),
            4 * h * live + 2 * h * blind, q.dtype)
    mask = (valid > 0)[:, None, None, :]
    qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    kind = "f32" if dtype == torch.float32 else "bf16"
    tol = (1e-4, 1e-4, False) if dtype == torch.float32 else None
    edge = (", no visible column in row 0" if empty_row else "") \
        + (", stale rows 1e4" if stale else "")
    return _result("decode_attention",
                   f"B={batch} L={length} {heads}x64 {kind} (strided K/V){edge}{forced}",
                   [got], [want], kernel, lambda: da.decode_attention_ref(q, k, v, valid), work,
                   lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask), tol=tol)


def decode_layer_case(batch: int, device="cuda", n_layer: int = 12, h: int = 768,
                      max_len: int = 64, offset: int = 40, dtype=torch.bfloat16, seed: int = 5,
                      stale: bool = False, empty_row: bool = False):
    """Seeded inputs of one fused decode step at GPT-2 124M widths, with
    the weights as prepare_decode_params leaves them (LN f32, the rest in
    ``dtype``): (x, kvf, valid, blocks). The first row is left-padded by 3
    (``empty_row``: it has no visible column at all); ``stale``: every
    cache row the step cannot see (past the offset, or not valid) holds 1e4
    in K and V."""
    g = _gen(device, seed)

    def nrm(*shape, std=0.02):
        return torch.randn(shape, generator=g, device=device) * std

    blocks = {"ln1_scale": 1 + nrm(n_layer, h, std=0.1), "ln1_bias": nrm(n_layer, h, std=0.1),
              "ln2_scale": 1 + nrm(n_layer, h, std=0.1), "ln2_bias": nrm(n_layer, h, std=0.1)}
    for name, shape in (("attn_w", (h, 3 * h)), ("attn_b", (3 * h,)), ("proj_w", (h, h)),
                        ("proj_b", (h,)), ("fc_w", (h, 4 * h)), ("fc_b", (4 * h,)),
                        ("out_w", (4 * h, h)), ("out_b", (h,))):
        blocks[name] = nrm(n_layer, *shape).to(dtype)
    x = nrm(batch, h, std=1.0).to(dtype)
    kvf = nrm(n_layer, max_len, batch, 2 * h, std=1.0).to(dtype)
    valid = torch.zeros((batch, max_len), dtype=torch.int32, device=device)
    valid[:, :offset + 1] = 1
    valid[0, :3] = 0                      # a left-padded first row
    if empty_row:
        valid[0] = 0
    if stale:
        kvf[:, (valid == 0).t()] = 1e4
    return x, kvf, valid, blocks


def check_decode_layer(batch: int, device="cuda", n_layer: int = 12, h: int = 768,
                       max_len: int = 64, offset: int = 40, dtype=torch.bfloat16,
                       stale: bool = False, empty_row: bool = False) -> CheckResult:
    x, kvf, valid, blocks = decode_layer_case(batch, device, n_layer, h, max_len, offset, dtype,
                                              stale=stale, empty_row=empty_row)
    heads = h // 64
    kvf_kernel, kvf_plain = kvf.clone(), kvf.clone()
    got, _ = dl.gpt2_decode_step(x, kvf_kernel, valid, offset, blocks, heads)
    want, _ = dl.gpt2_decode_step_ref(x, kvf_plain, valid, offset, blocks, heads)
    live = int(valid[:, :offset + 1].sum())
    blind = int((valid[:, :offset + 1].sum(dim=1) == 0).sum())   # rows that average every V row
    row = batch * 2 * h * kvf.element_size()
    bytes_ = nbytes(x, got, valid, *blocks.values()) \
        + n_layer * (h * kvf.element_size() * (2 * live + blind * max_len) + row)
    flops = n_layer * (2 * batch * 12 * h * h + 4 * h * live + 2 * h * blind * max_len)
    if dtype == torch.float32:
        tol = (1e-4, 1e-4, False)
    else:
        tol = (5e-2, 0.0, True) if n_layer > 1 else None
    kind = "f32" if dtype == torch.float32 else "bf16"
    edge = (", no visible column in row 0" if empty_row else "") \
        + (", stale rows 1e4" if stale else "")
    return _result("decode_layer",
                   f"B={batch} {n_layer}x{h} max_len={max_len} offset={offset} {kind}{edge}",
                   [got, kvf_kernel], [want, kvf_plain],
                   lambda: dl.gpt2_decode_step(x, kvf_kernel, valid, offset, blocks, heads),
                   lambda: dl.gpt2_decode_step_ref(x, kvf_plain, valid, offset, blocks, heads),
                   (bytes_, flops, x.dtype), tol=tol)


def check_fused_pool(batch: int, frames: int, mode: str = "gap", dtype=torch.float32,
                     device="cuda", seq: int = 197, h: int = 768, seed: int = 6) -> CheckResult:
    g = _gen(device, seed)
    tokens = torch.randn((batch * frames, seq, h), generator=g, device=device).to(dtype)
    got = fpl.fused_pool_temporal(tokens, batch, frames, mode)
    want = fpl.fused_pool_ref(tokens, batch, frames, mode)
    rows = seq - 1 if mode == "gap" else 1           # the rows of a frame the pool reads
    read = batch * frames * rows * h
    work = (read * tokens.element_size() + nbytes(got), read, torch.float32)   # f32 adds
    first = 1 if mode == "gap" else 0
    view = tokens.view(batch, frames, seq, h)
    tol = None if dtype == torch.float32 else (1e-2, 1e-2, False)
    kind = "f32" if dtype == torch.float32 else "bf16"
    return _result("fused_pool", f"{mode} tokens[{batch * frames},{seq},{h}] {kind} (B={batch},T={frames})",
                   [got], [want], lambda: fpl.fused_pool_temporal(tokens, batch, frames, mode),
                   lambda: fpl.fused_pool_ref(tokens, batch, frames, mode), work,
                   lambda: torch.mean(view[:, :, first:first + rows], dim=(1, 2),
                                      dtype=torch.float32),
                   tol=tol)


@dataclass
class BackwardResult:
    """Input gradients of an ``autograd.Function`` (kernel forward,
    closed-form backward) against ``torch.autograd.grad`` through the plain
    version; times of forward + backward of each, of the closed-form
    backward alone, and of one PyTorch call's forward + backward where
    there is one."""

    name: str
    shape: str
    max_abs_err: float
    max_abs_grad: float
    rel_tol: float
    ok: bool
    ms: float
    plain_ms: float
    bwd_ms: float
    library_ms: Optional[float]

    def as_dict(self) -> dict:
        return asdict(self)


def _backward_result(name, shape, dtype, inputs, fn, plain_fn, grad_out, bwd_fn,
                     library_fn=None) -> BackwardResult:
    def grads(f):
        return torch.autograd.grad(f(*inputs), inputs, grad_out)

    got, want = grads(fn), grads(plain_fn)
    torch.cuda.synchronize()
    err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
    scale = max(float(b.float().abs().max()) for b in want)
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    tol = BACKWARD_TOLERANCES[(name, dtype)]
    return BackwardResult(name, shape, err, scale, tol, finite and err <= tol * scale,
                          median_ms(lambda: grads(fn)), median_ms(lambda: grads(plain_fn)),
                          median_ms(bwd_fn), median_ms(library_fn) if library_fn else None)


def check_encoder_attention_backward(frames: int, dtype=torch.float32, device="cuda",
                                     seq: int = 197, heads: int = 12,
                                     seed: int = 7) -> BackwardResult:
    g = _gen(device, seed)
    h = heads * 64
    qkv = torch.randn((frames, seq, 3 * h), generator=g, device=device).to(dtype)
    grad_out = torch.randn((frames, seq, h), generator=g, device=device).to(dtype)
    x = qkv.clone().requires_grad_()

    def sdpa_fwd_bwd():
        q, k, v = x.view(frames, seq, 3, heads, 64).permute(2, 0, 3, 1, 4)
        out = F.scaled_dot_product_attention(q, k, v)
        return torch.autograd.grad(out, x, grad_out.view(frames, seq, heads, 64).transpose(1, 2))

    kind = "f32" if dtype == torch.float32 else "bf16"
    return _backward_result("encoder_attention", f"qkv[{frames},{seq},{3 * h}] {kind}", dtype,
                            (x,), lambda t: ea.encoder_attention(t, heads),
                            lambda t: ea.encoder_attention_ref(t, heads), grad_out,
                            lambda: ea.encoder_attention_bwd(qkv, grad_out, heads), sdpa_fwd_bwd)


def check_fused_pool_backward(batch: int, frames: int, mode: str = "gap", device="cuda",
                              seq: int = 197, h: int = 768, seed: int = 8) -> BackwardResult:
    g = _gen(device, seed)
    x = torch.randn((batch * frames, seq, h), generator=g, device=device).requires_grad_()
    grad_out = torch.randn((batch, h), generator=g, device=device)
    return _backward_result("fused_pool", f"{mode} tokens[{batch * frames},{seq},{h}] f32",
                            torch.float32, (x,),
                            lambda t: fpl.fused_pool_temporal(t, batch, frames, mode),
                            lambda t: fpl.fused_pool_ref(t, batch, frames, mode), grad_out,
                            lambda: fpl.fused_pool_bwd(grad_out, seq, frames, mode))


def check_prefix_projector_backward(rows: int, device="cuda", din: int = 256, dout: int = 3072,
                                    seed: int = 9) -> BackwardResult:
    g = _gen(device, seed)
    x = (torch.randn((rows, din), generator=g, device=device) * 0.4).requires_grad_()
    w = (torch.randn((din, dout), generator=g, device=device) * 0.02).requires_grad_()
    b = (torch.randn((dout,), generator=g, device=device) * 0.02).requires_grad_()
    grad_out = torch.randn((rows, dout), generator=g, device=device)

    def addmm_fwd_bwd():
        return torch.autograd.grad(torch.addmm(b, x, w), (x, w, b), grad_out)

    return _backward_result("prefix_projector", f"x[{rows},{din}] @ w[{din},{dout}] f32",
                            torch.float32, (x, w, b), pp.prefix_project, pp.prefix_project_ref,
                            grad_out,
                            lambda: pp.prefix_project_bwd(x.detach(), w.detach(), grad_out,
                                                          torch.float32),
                            addmm_fwd_bwd)


def backward_checks(device="cuda") -> List[BackwardResult]:
    """The backward passes at the trainers' shapes: the joint step's 4 videos
    x 8 frames (encoder_attention in f32 and bf16, fused_pool gap f32) and
    the mapper trainer's batch of 4."""
    return [check_encoder_attention_backward(32, torch.float32, device),
            check_encoder_attention_backward(32, torch.bfloat16, device),
            check_fused_pool_backward(4, 8, "gap", device),
            check_prefix_projector_backward(4, device)]


def main_path_checks(device="cuda") -> List[CheckResult]:
    """Every kernel at the main path's shapes; the first check of each kernel
    is the single-request shape whose times chip_smoke.py reports (lm_head
    and beam_attention: the unified request's 9 rows, 3 blocks of 3 with a
    sampled row and two dead ones; for the two fused-decode kernels, the
    single-request ``natural`` group: B=1, a 64-column cache; for
    fused_pool, the joint training step's 4 videos x 8 frames in f32).
    encoder_attention also runs at the trainers' 4 x 8 frames (f32 in the
    joint step, bf16 in the mapper step), at a chunk of 8 frames (the
    overlapped cold request's trunk) and at 64 (retrieval: 8 videos x 8
    frames), prefix_projector at 1, 8, 4 (the
    mapper step) and 64 rows, lm_head from one row to 256 (12: the serving
    presets' unified request; 24 and 96: batches; 5: eval_compare's beam-5
    decode of one video), beam_attention in both
    modes at the serving presets' unified blocks (R=12, K_max 4) and at the
    grouped single-request shapes (t = N/2, 0, N-1), at 16 videos x 3 beams
    (a batch of 8 with two beam presets) and at 64 x 3 (batched serving),
    eval_compare's beam-5 decode (B=1, K=5, a 5-column prefill, 32 steps),
    decode_attention at B=64 (batched), at B=2, L=300 and B=1, L=1024 (split
    over a cluster), on a row with no visible column, over stale rows of
    1e4, in f32, and at L=4096 (chunks), and decode_layer at B=1 and 8 over
    12 layers and one, in f32, over a 1024-row cache and at B=64."""
    out = []
    out += [check_encoder_attention(n, device) for n in (16, 128)]
    out += [check_encoder_attention(32, device, dtype=torch.float32),   # joint step
            check_encoder_attention(32, device)]                        # mapper step
    out += [check_encoder_attention(n, device) for n in (8, 64)]        # cold chunk, retrieval
    out += [check_prefix_projector(b, device) for b in (1, 8, 4, 64)]   # 4: the mapper step
    out += [check_lm_head(r, device) for r in (9, 6, 1, 12, 24, 96, 192, 64, 256, 5)]
    # the unified request's blocks: core presets (beam-3 x 2, natural) and
    # serving presets (beam-3 with a dead row, beam-4, natural and 3 dead rows)
    out += [check_beam_attention(3, 3, 48, 24, 12, device, live=(3, 3, 1))]
    out += [check_beam_attention(3, 4, 48, 40, t, device, deferred=deferred, live=(3, 4, 1))
            for deferred in (False, True) for t in (20, 0, 39)]
    for videos, beams, prefill, steps in ((2, 3, 48, 24), (1, 4, 48, 40)):
        out += [check_beam_attention(videos, beams, prefill, steps, t, device, deferred=deferred)
                for deferred in (False, True) for t in (steps // 2, 0, steps - 1)]
    out += [check_beam_attention(16, 3, 48, 24, 12, device)]   # a batch of 8: 2 presets x 8
    out += [check_beam_attention(64, 3, 48, 24, 12, device, deferred=deferred)   # batched
            for deferred in (False, True)]
    out += [check_beam_attention(1, 5, 5, 32, t, device) for t in (16, 0, 31)]   # eval
    out += [check_decode_attention(b, 64, device) for b in (1, 64)]
    out += [check_decode_attention(2, 300, device), check_decode_attention(1, 1024, device),
            check_decode_attention(2, 64, device, empty_row=True),
            check_decode_attention(2, 300, device, stale=True),
            check_decode_attention(3, 300, device, dtype=torch.float32, empty_row=True,
                                   stale=True),
            check_decode_attention(1, 4096, device, stale=True)]   # runs of 512: two chunks
    out += [check_decode_layer(b, device) for b in (1, 8)]
    out += [check_decode_layer(b, device, n_layer=1) for b in (1, 8)]
    out += [check_decode_layer(8, device, dtype=torch.float32)]
    out += [check_decode_layer(1, device, max_len=1024, offset=1000),   # K/V in chunks
            check_decode_layer(64, device)]                             # batched
    out += [check_fused_pool(4, 8, "gap", torch.float32, device),
            check_fused_pool(16, 8, "gap", torch.bfloat16, device),
            check_fused_pool(2, 8, "cls", torch.bfloat16, device)]
    return out
