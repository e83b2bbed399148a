"""One layer of beam-search decode attention over the split KV cache
(kernel K4, non-deferred mode).

Counterpart of video_caption_tpu/ops/pallas/beam_attention.py. The CUDA
kernel is ``csrc/beam_attention.cu``; ``beam_attention_ref`` is the plain
PyTorch version, the mirror of the JAX package's ``gpt2._beam_attend`` with
``ancestry_mask``: a dense head-blocked form in which the ancestry one-hot
masks every non-ancestor generated column to -1e30. The kernel instead
reads each step's one ancestor column directly; the two agree up to
summation order (csrc/beam_attention.cu).
"""
from __future__ import annotations

import torch

from video_caption_tpu_torch.ops import build

HEAD_DIM = 64       # the head dim the kernel is built for
_NEG = -1e30

launches = 0
"""Number of times ``beam_attention`` launched its CUDA kernel."""


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
                       t: int, num_beams: int, num_heads: int) -> torch.Tensor:
    """Plain version of :func:`beam_attention` (same arguments)."""
    dt = q.dtype
    r, h = q.shape
    b, s0 = valid.shape
    n = gkv.shape[0]
    k = num_beams
    nh = num_heads
    scale = (h // nh) ** -0.5
    hmask = head_block_mask(nh, h, q.device).to(dt)
    sel = ancestry_mask(anc, b, k, t)

    q_blk = (q.reshape(b, k, 1, h) * hmask).reshape(b, k * nh, h)
    lp = torch.einsum("bqh,bsh->bqs", q_blk.float(), pk.float()) * scale      # [B,K*nh,S0]
    lp = torch.where(valid[:, None, :] > 0, lp, _NEG)
    gkb = gkv[:, 0].reshape(n, b, k, h)
    gvb = gkv[:, 1].reshape(n, b, k, h)
    lg = torch.einsum("bqh,nbkh->bqnk", q_blk.float(), gkb.float()) * scale   # [B,K*nh,N,Kv]
    lg = torch.where(sel[:, :, None], lg.reshape(b, k, nh, n, k), _NEG)
    lg = lg.reshape(b, k * nh, n * k)
    attn = torch.softmax(torch.cat([lp, lg], dim=-1), dim=-1).to(dt)
    ap, ag = attn[..., :s0], attn[..., s0:]
    out_p = torch.einsum("bqs,bsh->bqh", ap, pv.to(dt))                        # [B,K*nh,H]
    agn = ag.reshape(b, k * nh, n, k).permute(2, 0, 1, 3)                      # [N,B,Q,Kv]
    per_n = torch.einsum("nbqk,nbkh->nbqh", agn.float(), gvb.float())
    res = (out_p + per_n.sum(dim=0).to(dt)).reshape(b, k, nh, h)
    return (res * hmask).sum(dim=2).reshape(r, h)


def beam_attention(q: torch.Tensor, gkv: torch.Tensor, pk: torch.Tensor, pv: torch.Tensor,
                   valid: torch.Tensor, anc: torch.Tensor, t: int, num_beams: int,
                   num_heads: int) -> torch.Tensor:
    """Attention output [R, H] for one layer of a beam step.

    q [R, H] (R = B*K; rows may be strided, the last dim contiguous), gkv
    [N, 2, R, H] this layer's generated cache with step t already written,
    pk/pv [B, S0, H] this layer's prefill K/V, valid [B, S0] int32 left-pad
    flags, anc [R, N] int32 ancestry (row indices local to the R rows),
    t the current step.

    CPU tensors take the plain version; CUDA tensors launch the kernel, which
    takes float32 or bfloat16, head dim 64 and any R, and raises on anything
    else."""
    global launches
    if q.device.type == "cpu":
        return beam_attention_ref(q, gkv, pk, pv, valid, anc, t, num_beams, num_heads)
    for name, x in (("gkv", gkv), ("pk", pk), ("pv", pv), ("valid", valid), ("anc", anc)):
        build.require_cuda(x, name)
    if q.device.type != "cuda" or q.ndim != 2 or q.stride(1) != 1:
        raise ValueError("q must be a CUDA [R, H] tensor with a contiguous last dim")
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
    out = torch.empty((r, h), dtype=q.dtype, device=q.device)
    build.launch("vct_beam_attention", q.data_ptr(), q.stride(0), gkv.data_ptr(),
                 pk.data_ptr(), pv.data_ptr(), valid.data_ptr(), anc.data_ptr(),
                 out.data_ptr(), r, h, num_heads, num_beams, s0, n, int(t),
                 build.dtype_code(q.dtype), build.stream_of(q))
    launches += 1
    return out
