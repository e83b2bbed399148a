"""Single-token decode attention over the contiguous KV cache (kernel K5).

Counterpart of video_caption_tpu/ops/pallas/decode_attention.py. The CUDA
kernel is ``csrc/decode_attention.cu``; ``decode_attention_ref`` is the plain
PyTorch version, the mirror of the Pallas body ``_attn_kernel``: logits,
softmax and the product with V all in f32 (unlike the XLA ``_attend``, the
probabilities are NOT rounded to the compute dtype before the product), the
result in q's dtype. The mask is ``valid`` alone, which encodes causality at
one query token.

Off by default, as in the JAX package; ``GPT2Config.use_pallas_decode``
(``CompileConfig.use_pallas_decode_attention``) routes the K=1 decode step's
attention here.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from video_caption_tpu_torch.ops import build

HEAD_DIM = 64       # the head dim the kernel is built for
THREADS = 128       # threads of a block
MAX_SPLITS = 8      # blocks of one (row, head): a cluster, at most the portable size
SPLIT_BYTES = 16 * 1024   # K and V bytes of one block above which the plan splits L
STAGE_BYTES = 96 * 1024   # K and V rows a block stages at once, at most
FULL_STAGE_BYTES = 64 * 1024   # the same once the grid holds more than 2 blocks an SM
SMEM_LIMIT = 232448       # 227 KB: the most shared memory a block can take
ROW_GROUPS = 16     # column groups of the AV phase (row r of a chunk in group r mod 16)
_NEG = -1e30

launches = 0
"""Number of times ``decode_attention`` launched its CUDA kernel."""


@dataclass(frozen=True)
class Plan:
    """Launch geometry of ``csrc/decode_attention.cu``: grid (splits, heads,
    batch) of THREADS-thread blocks. The ``splits`` blocks of one (row, head)
    form one cluster; block s takes the cache columns [s * cols, min(L,
    (s + 1) * cols)) and stages them ``stage_rows`` at a time (chunks);
    ``smem`` bytes of dynamic shared memory."""

    batch: int
    heads: int
    length: int
    splits: int
    cols: int
    stage_rows: int
    smem: int

    @property
    def grid(self) -> Tuple[int, int, int]:
        return self.splits, self.heads, self.batch

    def runs(self) -> Tuple[Tuple[int, int], ...]:
        """[begin, end) of each block of a (row, head), in rank order."""
        return tuple((s * self.cols, min(self.length, (s + 1) * self.cols))
                     for s in range(self.splits))

    def chunks(self, begin: int, end: int) -> Tuple[Tuple[int, int], ...]:
        """The chunks a block stages for its run [begin, end)."""
        return tuple((c, min(end, c + self.stage_rows))
                     for c in range(begin, end, self.stage_rows))


def stage_row_bytes(dtype_bytes: int) -> int:
    """A staged K or V row: 64 values and 16 bytes of padding (the 16-byte
    reads of neighbouring rows fall in different banks)."""
    return HEAD_DIM * dtype_bytes + 16


def stage_limit(dtype_bytes: int, stage_bytes: int = STAGE_BYTES) -> int:
    """K and V rows a block stages at once: more, and its run goes in chunks."""
    return stage_bytes // (2 * stage_row_bytes(dtype_bytes))


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


def smem_bytes(stage_rows: int, splits: int, dtype_bytes: int) -> int:
    """The source's ``layout``: the K and V stages, q, the valid flags and
    the f32 logits of a chunk, the 4 warps' maxima and (acc[64], sum) sums,
    and, in a cluster, every block's (acc[64], max, sum) in rank 0."""
    return 2 * stage_rows * stage_row_bytes(dtype_bytes) + HEAD_DIM * dtype_bytes \
        + 2 * _align16(4 * stage_rows) + 16 + 4 * 4 * (HEAD_DIM + 4) \
        + (4 * splits * (HEAD_DIM + 4) if splits > 1 else 0)


def plan(batch: int, heads: int, length: int, dtype_bytes: int, n_sm: int = 132,
         splits: Optional[int] = None, stage_rows: Optional[int] = None) -> Plan:
    """The geometry for q [batch, heads, 64] over ``length`` cache columns of
    ``dtype_bytes`` bytes. One block per (row, head) while its K and V fit
    in SPLIT_BYTES (64 rows bf16, 32 f32) or the (row, head) blocks already
    fill two blocks an SM; else the fewest splits (a power of two, at most
    MAX_SPLITS) that bring a block within SPLIT_BYTES or fill the card. A
    block stages its run in the fewest chunks of equal size within
    STAGE_BYTES of K and V, or FULL_STAGE_BYTES once the grid holds more
    than two blocks an SM (smaller stages, more blocks resident an SM:
    ``cli/sweep_plans.py`` at B=64, L=300 and 1024). ``splits`` and ``stage_rows``
    force another geometry (``cli/sweep_plans.py``): the splits must leave
    no block without a column, and a chunk holds at most ``stage_limit``
    rows."""
    row_pair = 2 * HEAD_DIM * dtype_bytes
    if splits is None:
        splits = 1
        while splits < MAX_SPLITS and -(-length // splits) * row_pair > SPLIT_BYTES \
                and batch * heads * splits < 2 * n_sm:
            splits *= 2
    cols = -(-length // splits)
    if not 1 <= splits <= MAX_SPLITS or (splits - 1) * cols >= length:
        raise ValueError(f"{splits} splits of {length} columns leave a block without one")
    most = min(cols, stage_limit(dtype_bytes))
    if stage_rows is None:
        full = batch * heads * splits > 2 * n_sm
        cap = stage_limit(dtype_bytes, FULL_STAGE_BYTES if full else STAGE_BYTES)
        stage_rows = -(-cols // -(-cols // cap))
    elif not 1 <= stage_rows <= most:
        raise ValueError(f"stage_rows {stage_rows} outside [1, {most}]")
    return Plan(batch, heads, length, splits, cols, stage_rows,
                smem_bytes(stage_rows, splits, dtype_bytes))


@functools.lru_cache(maxsize=256)
def _plan_for(batch: int, heads: int, length: int, dtype_bytes: int, device: int) -> Plan:
    return plan(batch, heads, length, dtype_bytes,
                torch.cuda.get_device_properties(device).multi_processor_count)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`decode_attention` (same arguments)."""
    hd = q.shape[-1]
    logits = torch.einsum("bhd,blhd->bhl", q.float(), k_cache.float()) * (hd ** -0.5)
    logits = torch.where(valid[:, None, :] > 0, logits, _NEG)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhl,blhd->bhd", probs, v_cache.float()).to(q.dtype)


def _check_cache(name: str, t: torch.Tensor, b: int, l: int, nh: int) -> Tuple[int, ...]:
    """The cache's strides, after the checks the kernel needs."""
    st = t.stride()
    if t.device.type != "cuda" or t.shape != (b, l, nh, HEAD_DIM):
        raise ValueError(f"{name} must be a CUDA [{b}, {l}, {nh}, {HEAD_DIM}] tensor, "
                         f"got {tuple(t.shape)} on {t.device}")
    if st[3] != 1 or st[2] != HEAD_DIM:
        raise ValueError(f"{name} must hold each row's heads contiguously (strides "
                         f"[..., {HEAD_DIM}, 1]), got strides {st}")
    return st


def _launch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
            valid: torch.Tensor, p: Plan, strides: Tuple[int, ...]) -> torch.Tensor:
    """Launch the kernel under plan ``p``; ``strides`` = (q's batch stride,
    K's batch and row strides, V's batch and row strides)."""
    global launches
    qp, kp, vp = q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr()
    size = q.element_size()
    b, l = p.batch, p.length
    qs, kb, kl, vb, vl = strides
    if (qp | kp | vp) % 16 or (qs * size) % 16 or (b > 1 and (kb * size % 16 or vb * size % 16)) \
            or (l > 1 and (kl * size % 16 or vl * size % 16)):
        raise ValueError("q and the caches must start on 16-byte boundaries, with strides "
                         f"of whole 16 bytes; got pointers {qp % 16}, {kp % 16}, {vp % 16} "
                         f"bytes past one and strides {strides} of {size}-byte values")
    out = torch.empty((b, p.heads, HEAD_DIM), dtype=q.dtype, device=q.device)
    build.launch("vct_decode_attention", qp, qs, kp, kb, kl, vp, vb, vl, valid.data_ptr(),
                 out.data_ptr(), b, p.heads, l, p.splits, p.stage_rows, p.smem,
                 build.dtype_code(q.dtype), build.stream_of(q))
    launches += 1
    return out


def _check(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           valid: torch.Tensor) -> Tuple[int, ...]:
    """Raise on what the kernel does not take; the strides ``_launch`` needs."""
    qst = q.stride()
    if q.device.type != "cuda" or q.ndim != 3 or q.shape[2] != HEAD_DIM \
            or qst[2] != 1 or qst[1] != HEAD_DIM:
        raise ValueError(f"q must be a CUDA [B, nh, {HEAD_DIM}] tensor with each row's heads "
                         f"contiguous, got {tuple(q.shape)} strides {qst}")
    b, nh, _ = q.shape
    build.require_cuda(valid, "valid")
    if valid.dtype != torch.int32 or valid.ndim != 2 or valid.shape[0] != b:
        raise ValueError(f"valid must be int32 [{b}, L], got {valid.dtype} {tuple(valid.shape)}")
    l = valid.shape[1]
    kst = _check_cache("k_cache", k_cache, b, l, nh)
    vst = _check_cache("v_cache", v_cache, b, l, nh)
    if not q.dtype == k_cache.dtype == v_cache.dtype:
        raise TypeError("q and the caches must share a dtype")
    return qst[0], kst[0], kst[1], vst[0], vst[1]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Attention of one query token per row: q [B, nh, hd], K/V caches
    [B, L, nh, hd], valid [B, L] (1 where a cache column is live) ->
    [B, nh, hd] in q's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel. The
    kernel takes float32 or bfloat16, head dim 64, any L, q and the caches
    as strided views (the caches' batch and row strides are free, each row's
    heads contiguous; every pointer and stride on whole 16 bytes), so the K
    and V halves of the interleaved cache layer ``kv[layer, :, :, 0]`` /
    ``[..., 1]`` pass without a copy; it raises on anything else."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, valid)
    strides = _check(q, k_cache, v_cache, valid)
    p = _plan_for(q.shape[0], q.shape[1], valid.shape[1], q.element_size(), q.get_device())
    return _launch(q, k_cache, v_cache, valid, p, strides)
