"""One layer of beam-search decode attention over the split KV cache
(kernel K4), in both modes of the TPU kernel.

Counterpart of video_caption_tpu/ops/pallas/beam_attention.py. The CUDA
kernel is ``csrc/beam_attention.cu``; ``beam_attention_ref`` is the plain
PyTorch version, the mirror of the JAX package's ``gpt2._beam_attend`` with
``ancestry_mask``: a dense head-blocked form in which the ancestry one-hot
masks every non-ancestor generated column to -1e30. The kernel instead
reads each step's one ancestor column directly; the two agree up to
summation order (csrc/beam_attention.cu).

Two modes, as in the TPU kernel:
- the generated cache already holds step t's K/V: every step nn <= t;
- deferred (``k_new``/``v_new`` given, GPT2Config.deferred_cache_write):
  column t of the cache is stale, the cache mask is strict (nn < t) and the
  step's own K/V join the softmax as one extra "self" column, last.

The kernel is the custom op ``vct::beam_attention`` (``k_new``/``v_new``
optional): its CPU kernel is the plain version, its CUDA kernel the checks
and the launch, its fake implementation the output's shape from q's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from video_caption_tpu_torch.ops import build

HEAD_DIM = 64       # the head dim the kernel is built for
THREADS = 256       # threads of a block (one block per video and head)
MAX_BEAMS = 8       # beams a block serves (8 threads a beam row in each AV group)
MAX_PREFILL = 1024  # prefill columns (GPT-2's position table)
STAGE_BYTES = 96 * 1024   # K and V rows the kernel stages at once
SMEM_LIMIT = 232448       # 227 KB: the most shared memory a block can take
AV_DIMS = 8               # dims of one beam row a thread accumulates in AV
PARTIAL_BYTES = THREADS * AV_DIMS * 4   # AV partial sums of the column groups
_NEG = -1e30

launches = 0
"""Number of times ``beam_attention`` launched its CUDA kernel (both modes)."""
launches_by_beams: Dict[int, int] = {}
"""The same launches by beam count K, counted by the wrapper itself (a CUDA
graph's replay adds to ``launches`` only)."""


@dataclass(frozen=True)
class Plan:
    """Launch geometry of ``csrc/beam_attention.cu``: grid (videos, heads) of
    THREADS-thread blocks. A block reads ``rows`` K (and V) rows: the prefill
    rows and, for each of ``steps`` generated steps, the rows of all
    ``beams`` writers of its video; it stages ``stage_rows`` of them at once
    (all of them, or the limit of STAGE_BYTES), in ``len(chunks)`` chunks of
    logical columns [l0, l1) (a prefill column is one row, a step ``beams``
    rows); ``smem`` bytes of dynamic shared memory. In AV, ``groups`` column
    groups (l = g mod groups) of 8 threads a beam row."""

    videos: int
    beams: int
    steps: int
    rows: int
    stage_rows: int
    chunks: Tuple[Tuple[int, int], ...]
    smem: int

    @property
    def groups(self) -> int:
        return THREADS // (HEAD_DIM // AV_DIMS * self.beams)


def stage_row_bytes(dtype_bytes: int) -> int:
    """A staged K or V row: 64 values and 16 bytes of padding (the 16-byte
    loads of neighbouring rows fall in different banks)."""
    return HEAD_DIM * dtype_bytes + 16


def stage_limit(dtype_bytes: int) -> int:
    """K and V rows of one head the kernel stages at once: more, and the
    columns go in chunks."""
    return STAGE_BYTES // (2 * stage_row_bytes(dtype_bytes))


def chunk_bounds(s0: int, steps: int, beams: int, stage_rows: int) -> List[Tuple[int, int]]:
    """The kernel's chunks of logical columns (``chunk_end`` in the source):
    prefill columns first, one staged row each, then whole steps of
    ``beams`` rows, at most ``stage_rows`` rows a chunk."""
    lcols, out, l0 = s0 + steps, [], 0
    while l0 < lcols:
        l1, cap = l0, stage_rows
        if l1 < s0:
            take = min(s0 - l1, cap)
            l1, cap = l1 + take, cap - take
        if l1 >= s0:
            l1 += min(lcols - l1, cap // beams)
        out.append((l0, l1))
        l0 = l1
    return out


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


def plan(videos: int, beams: int, s0: int, n: int, t: int, dtype_bytes: int,
         deferred: bool, stage_rows: Optional[int] = None) -> Plan:
    """The geometry for one call at step ``t`` of an ``n``-column generated
    cache with ``s0`` prefill columns; the shared memory is the source's
    ``layout``: K and V stages, the beams' q rows (and k_new, v_new when
    deferred), f32 logits and int32 staged-row indices of every column plus
    the self column, valid and anc as int32, and the AV partial sums of the
    column groups (PARTIAL_BYTES). ``stage_rows`` forces fewer staged rows,
    hence more chunks (``cli/sweep_plans.py``); a chunk must hold a step."""
    steps = t if deferred else t + 1
    rows = s0 + beams * steps
    most = min(rows, stage_limit(dtype_bytes))
    if stage_rows is None:
        stage_rows = most
    elif not min(rows, beams) <= stage_rows <= most:
        raise ValueError(f"stage_rows {stage_rows} outside [{min(rows, beams)}, {most}]")
    per_beam = _align16(4 * beams * (s0 + steps + 1))
    smem = 2 * stage_rows * stage_row_bytes(dtype_bytes) \
        + beams * (3 if deferred else 1) * HEAD_DIM * dtype_bytes \
        + 2 * per_beam + _align16(4 * s0) + _align16(4 * beams * steps) + PARTIAL_BYTES
    return Plan(videos, beams, steps, rows, stage_rows,
                tuple(chunk_bounds(s0, steps, beams, stage_rows)), smem)


def head_block_mask(num_heads: int, h: int, device) -> torch.Tensor:
    """[nh, H] bool: row i is True exactly on head i's slice of H."""
    h_of = torch.arange(h, device=device) // (h // num_heads)
    return h_of[None, :] == torch.arange(num_heads, device=device)[:, None]


def ancestry_mask(anc: torch.Tensor, b: int, k_beams: int, t: int) -> torch.Tensor:
    """[B, Kq, N, Kv] bool: video b's query beam kq sees its step-j ancestor
    in physical row b*K + kv, and j <= t. ``anc`` holds row indices local to
    the group's R = B*K rows."""
    n = anc.shape[1]
    anc_b = anc.reshape(b, k_beams, n)
    row_of = (torch.arange(b, device=anc.device) * k_beams)[:, None, None, None] + \
        torch.arange(k_beams, device=anc.device)[None, None, None, :]
    steps = torch.arange(n, device=anc.device)[None, None, :, None]
    return (anc_b[:, :, :, None] == row_of) & (steps <= t)


def beam_attention_ref(q: torch.Tensor, gkv: torch.Tensor, pk: torch.Tensor,
                       pv: torch.Tensor, valid: torch.Tensor, anc: torch.Tensor,
                       t: int, num_beams: int, num_heads: int,
                       k_new: Optional[torch.Tensor] = None,
                       v_new: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`beam_attention` (same arguments)."""
    dt = q.dtype
    r, h = q.shape
    b, s0 = valid.shape
    n = gkv.shape[0]
    k = num_beams
    nh = num_heads
    scale = (h // nh) ** -0.5
    hmask = head_block_mask(nh, h, q.device).to(dt)
    deferred = k_new is not None
    sel = ancestry_mask(anc, b, k, t - 1 if deferred else t)

    q_blk = (q.reshape(b, k, 1, h) * hmask).reshape(b, k * nh, h)
    lp = torch.einsum("bqh,bsh->bqs", q_blk.float(), pk.float()) * scale      # [B,K*nh,S0]
    lp = torch.where(valid[:, None, :] > 0, lp, _NEG)
    gkb = gkv[:, 0].reshape(n, b, k, h)
    gvb = gkv[:, 1].reshape(n, b, k, h)
    lg = torch.einsum("bqh,nbkh->bqnk", q_blk.float(), gkb.float()) * scale   # [B,K*nh,N,Kv]
    lg = torch.where(sel[:, :, None], lg.reshape(b, k, nh, n, k), _NEG)
    parts = [lp, lg.reshape(b, k * nh, n * k)]
    if deferred:
        # the self column: each row attends its own new K, a rowwise dot
        kn = k_new.to(dt).reshape(b, k, 1, h).expand(b, k, nh, h).reshape(b, k * nh, h)
        parts.append((q_blk.float() * kn.float()).sum(dim=-1, keepdim=True) * scale)
    attn = torch.softmax(torch.cat(parts, dim=-1), dim=-1).to(dt)
    ap, ag = attn[..., :s0], attn[..., s0:s0 + n * k]
    out_p = torch.einsum("bqs,bsh->bqh", ap, pv.to(dt))                        # [B,K*nh,H]
    agn = ag.reshape(b, k * nh, n, k).permute(2, 0, 1, 3)                      # [N,B,Q,Kv]
    per_n = torch.einsum("nbqk,nbkh->nbqh", agn.float(), gvb.float())
    out_g = per_n.sum(dim=0).to(dt)
    if deferred:
        vn = v_new.to(dt).reshape(b, k, 1, h).expand(b, k, nh, h).reshape(b, k * nh, h)
        out_g = out_g + attn[..., s0 + n * k:] * vn
    res = (out_p + out_g).reshape(b, k, nh, h)
    return (res * hmask).sum(dim=2).reshape(r, h)


def _require_rows(x: torch.Tensor, name: str) -> None:
    """A CUDA [R, H] tensor whose rows start on 16-byte boundaries, with a
    contiguous last dim (a slice of the fused QKV output is one)."""
    if x.device.type != "cuda" or x.ndim != 2 or x.stride(1) != 1:
        raise ValueError(f"{name} must be a CUDA [R, H] tensor with a contiguous last dim")
    if x.data_ptr() % 16 or (x.stride(0) * x.element_size()) % 16:
        raise ValueError(f"{name}'s rows must start on 16-byte boundaries")


@torch.library.custom_op("vct::beam_attention", mutates_args=(), device_types="cpu")
def _op(q: torch.Tensor, gkv: torch.Tensor, pk: torch.Tensor, pv: torch.Tensor,
        valid: torch.Tensor, anc: torch.Tensor, t: int, num_beams: int, num_heads: int,
        k_new: Optional[torch.Tensor], v_new: Optional[torch.Tensor]) -> torch.Tensor:
    return beam_attention_ref(q, gkv, pk, pv, valid, anc, t, num_beams, num_heads, k_new, v_new)


@_op.register_kernel("cuda")
def _cuda(q: torch.Tensor, gkv: torch.Tensor, pk: torch.Tensor, pv: torch.Tensor,
          valid: torch.Tensor, anc: torch.Tensor, t: int, num_beams: int, num_heads: int,
          k_new: Optional[torch.Tensor], v_new: Optional[torch.Tensor]) -> torch.Tensor:
    global launches
    for name, x in (("gkv", gkv), ("pk", pk), ("pv", pv), ("valid", valid), ("anc", anc)):
        build.require_cuda(x, name)
    _require_rows(q, "q")
    r, h = q.shape
    b, s0 = valid.shape
    n = gkv.shape[0]
    if h != num_heads * HEAD_DIM or r != b * num_beams:
        raise ValueError(f"q {tuple(q.shape)} does not match {num_heads} heads of "
                         f"{HEAD_DIM} and {b} videos x {num_beams} beams")
    if gkv.shape != (n, 2, r, h) or pk.shape != (b, s0, h) or pv.shape != (b, s0, h) \
            or anc.shape != (r, n):
        raise ValueError("cache shapes do not match q, valid and anc")
    if len({q.dtype, gkv.dtype, pk.dtype, pv.dtype}) != 1:
        raise TypeError("q and the caches must share a dtype")
    if valid.dtype != torch.int32 or anc.dtype != torch.int32:
        raise TypeError("valid and anc must be int32")
    if not 0 <= t < n:
        raise ValueError(f"step {t} outside the {n}-column generated cache")
    if not 0 < num_beams <= MAX_BEAMS or s0 > MAX_PREFILL:
        raise ValueError(f"the kernel takes 1-{MAX_BEAMS} beams and at most {MAX_PREFILL} "
                         f"prefill columns, got {num_beams} and {s0}")
    for name, x in (("gkv", gkv), ("pk", pk), ("pv", pv)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    deferred = k_new is not None
    if deferred:
        for name, x in (("k_new", k_new), ("v_new", v_new)):
            _require_rows(x, name)
            if x.shape != (r, h):
                raise ValueError(f"{name} has shape {tuple(x.shape)}, not {(r, h)}")
            if x.dtype != q.dtype:
                raise TypeError(f"{name} must be {q.dtype} like q, got {x.dtype}")
        if k_new.stride(0) != v_new.stride(0):
            raise ValueError("k_new and v_new must share a row stride")
    p = plan(b, num_beams, s0, n, t, q.element_size(), deferred)
    if p.smem > SMEM_LIMIT:
        raise ValueError(f"{p.smem} bytes of shared memory exceed the block's {SMEM_LIMIT}")
    out = torch.empty((r, h), dtype=q.dtype, device=q.device)
    build.launch("vct_beam_attention", q.data_ptr(), q.stride(0), gkv.data_ptr(),
                 pk.data_ptr(), pv.data_ptr(), valid.data_ptr(), anc.data_ptr(),
                 k_new.data_ptr() if deferred else None, v_new.data_ptr() if deferred else None,
                 k_new.stride(0) if deferred else 0, out.data_ptr(), r, h, num_heads,
                 num_beams, s0, n, int(t), int(deferred), p.stage_rows, p.smem,
                 build.dtype_code(q.dtype), build.stream_of(q))
    launches += 1
    launches_by_beams[num_beams] = launches_by_beams.get(num_beams, 0) + 1
    return out


@_op.register_fake
def _fake(q: torch.Tensor, gkv: torch.Tensor, pk: torch.Tensor, pv: torch.Tensor,
          valid: torch.Tensor, anc: torch.Tensor, t: int, num_beams: int, num_heads: int,
          k_new: Optional[torch.Tensor], v_new: Optional[torch.Tensor]) -> torch.Tensor:
    return q.new_empty(q.shape)


def beam_attention(q: torch.Tensor, gkv: torch.Tensor, pk: torch.Tensor, pv: torch.Tensor,
                   valid: torch.Tensor, anc: torch.Tensor, t: int, num_beams: int,
                   num_heads: int, k_new: Optional[torch.Tensor] = None,
                   v_new: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention output [R, H] for one layer of a beam step.

    q [R, H] (R = B*K; rows may be strided, the last dim contiguous), gkv
    [N, 2, R, H] this layer's generated cache, pk/pv [B, S0, H] this layer's
    prefill K/V, valid [B, S0] int32 left-pad flags, anc [R, N] int32
    ancestry (row indices local to the R rows), t the current step. Without
    ``k_new``/``v_new`` step t is already written in gkv; with them
    (deferred mode, both [R, H] in q's dtype, strided like q) column t is
    stale and they are the step's own K/V.

    CPU tensors take the plain version; CUDA tensors launch the kernel, which
    takes float32 or bfloat16, head dim 64, up to MAX_BEAMS beams and
    MAX_PREFILL prefill columns, and raises on anything else."""
    if (k_new is None) != (v_new is None):
        raise ValueError("k_new and v_new come together (deferred mode) or not at all")
    build.require_device(q, gkv, pk, pv, valid, anc)
    return _op(q, gkv, pk, pv, valid, anc, int(t), num_beams, num_heads, k_new, v_new)
