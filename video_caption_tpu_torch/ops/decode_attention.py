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

import torch

from video_caption_tpu_torch.ops import build

HEAD_DIM = 64       # the head dim the kernel is built for
_NEG = -1e30

launches = 0
"""Number of times ``decode_attention`` launched its CUDA kernel."""


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`decode_attention` (same arguments)."""
    hd = q.shape[-1]
    logits = torch.einsum("bhd,blhd->bhl", q.float(), k_cache.float()) * (hd ** -0.5)
    logits = torch.where(valid[:, None, :] > 0, logits, _NEG)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhl,blhd->bhd", probs, v_cache.float()).to(q.dtype)


def _check_cache(name: str, t: torch.Tensor, b: int, l: int, nh: int) -> None:
    if t.device.type != "cuda" or t.shape != (b, l, nh, HEAD_DIM):
        raise ValueError(f"{name} must be a CUDA [{b}, {l}, {nh}, {HEAD_DIM}] tensor, "
                         f"got {tuple(t.shape)} on {t.device}")
    if t.stride(3) != 1 or t.stride(2) != HEAD_DIM:
        raise ValueError(f"{name} must hold each row's heads contiguously (strides "
                         f"[..., {HEAD_DIM}, 1]), got strides {t.stride()}")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Attention of one query token per row: q [B, nh, hd], K/V caches
    [B, L, nh, hd], valid [B, L] (1 where a cache column is live) ->
    [B, nh, hd] in q's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel. The
    kernel takes float32 or bfloat16, head dim 64, q and the caches as
    strided views (the caches' batch and row strides are free, each row's
    heads contiguous), so the K and V halves of the interleaved cache layer
    ``kv[layer, :, :, 0]`` / ``[..., 1]`` pass without a copy; it raises on
    anything else."""
    global launches
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, valid)
    if q.device.type != "cuda" or q.ndim != 3 or q.shape[2] != HEAD_DIM \
            or q.stride(2) != 1 or q.stride(1) != HEAD_DIM:
        raise ValueError(f"q must be a CUDA [B, nh, {HEAD_DIM}] tensor with each row's heads "
                         f"contiguous, got {tuple(q.shape)} strides {q.stride()}")
    b, nh, _ = q.shape
    build.require_cuda(valid, "valid")
    if valid.dtype != torch.int32 or valid.ndim != 2 or valid.shape[0] != b:
        raise ValueError(f"valid must be int32 [{b}, L], got {valid.dtype} {tuple(valid.shape)}")
    l = valid.shape[1]
    _check_cache("k_cache", k_cache, b, l, nh)
    _check_cache("v_cache", v_cache, b, l, nh)
    if len({q.dtype, k_cache.dtype, v_cache.dtype}) != 1:
        raise TypeError("q and the caches must share a dtype")
    out = torch.empty((b, nh, HEAD_DIM), dtype=q.dtype, device=q.device)
    build.launch("vct_decode_attention", q.data_ptr(), q.stride(0), k_cache.data_ptr(),
                 k_cache.stride(0), k_cache.stride(1), v_cache.data_ptr(), v_cache.stride(0),
                 v_cache.stride(1), valid.data_ptr(), out.data_ptr(), b, nh, l,
                 build.dtype_code(q.dtype), build.stream_of(q))
    launches += 1
    return out
