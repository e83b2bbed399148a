"""A whole K=1 GPT-2 decode step over the flat KV cache (kernel K6).

Counterpart of video_caption_tpu/ops/pallas/decode_layer.py. The CUDA
kernel is ``csrc/decode_layer.cu`` (one cooperative launch per step, every
layer inside); ``gpt2_decode_step_ref`` is the plain PyTorch version, the
mirror of the Pallas body ``_decode_step_kernel`` in its rounding order:
LayerNorm in f32 then cast; each product accumulated in f32, cast, and only
then its bias added in the compute dtype; attention probabilities cast
before the product with V (accumulated in f32); both residual adds in the
compute dtype; tanh-GELU in f32.

The flat cache is ``kvf [n_layer, max_len, B, 2H]`` (K in ``[..., :H]``, V in
``[..., H:]``); the step writes its K/V row at ``offset`` IN PLACE. Weights
arrive as ``models/gpt2.prepare_decode_params`` leaves them: LayerNorm
weights in f32, the rest in the compute dtype, projections ``[in, out]``.

Off by default, as in the JAX package; ``GPT2Config.use_pallas_decode_layer``
(``CompileConfig.use_pallas_decode_layer``) selects the flat cache and this
step for greedy/sampled decode.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from video_caption_tpu_torch.ops import build

HEAD_DIM = 64       # the head dim the kernel is built for
_NEG = -1e30

LN_KEYS = ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias")

launches = 0
"""Number of times ``gpt2_decode_step`` launched its CUDA kernel."""


def _ln(xf: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps) * scale + bias


def _product(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated in f32 (both operands upcast: products of bf16
    values are exact in f32), cast to x's dtype, then ``+ b`` in that dtype."""
    return (x.float() @ w.float()).to(x.dtype) + b


def gpt2_decode_step_ref(x: torch.Tensor, kvf: torch.Tensor, valid: torch.Tensor, offset: int,
                         blocks: Dict[str, torch.Tensor], num_heads: int,
                         ln_eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`gpt2_decode_step` (same arguments and result)."""
    dt = x.dtype
    b, h = x.shape
    n_layer, max_len = kvf.shape[:2]
    hd = h // num_heads
    row = torch.arange(max_len, device=x.device)[:, None]
    mask = (row <= offset) & (valid.t() > 0)                               # [L, B]
    for layer in range(n_layer):
        blk = {k: v[layer] for k, v in blocks.items()}
        xn = _ln(x.float(), blk["ln1_scale"], blk["ln1_bias"], ln_eps).to(dt)
        qkv = _product(xn, blk["attn_w"], blk["attn_b"])
        kvf[layer, offset] = qkv[:, h:]
        kc = kvf[layer, :, :, :h].float().reshape(max_len, b, num_heads, hd)
        vc = kvf[layer, :, :, h:].float().reshape(max_len, b, num_heads, hd)
        q = qkv[:, :h].float().reshape(b, num_heads, hd)
        logits = (q[None] * kc).sum(dim=-1) * (hd ** -0.5)                 # [L, B, nh]
        logits = torch.where(mask[:, :, None], logits, _NEG)
        attn = torch.softmax(logits, dim=0).to(dt)
        heads = (attn.float()[..., None] * vc).sum(dim=0).to(dt)           # [B, nh, hd]
        x = x + _product(heads.reshape(b, h), blk["proj_w"], blk["proj_b"])
        mn = _ln(x.float(), blk["ln2_scale"], blk["ln2_bias"], ln_eps).to(dt)
        m = _product(mn, blk["fc_w"], blk["fc_b"])
        m = F.gelu(m.float(), approximate="tanh").to(dt)
        x = x + _product(m, blk["out_w"], blk["out_b"])
    return x, kvf


def gpt2_decode_step(x: torch.Tensor, kvf: torch.Tensor, valid: torch.Tensor, offset: int,
                     blocks: Dict[str, torch.Tensor], num_heads: int,
                     ln_eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every layer of one decode step: x [B, H] in the compute dtype, kvf
    [n_layer, max_len, B, 2H] (its row ``offset`` written in place), valid
    [B, max_len] int32, ``blocks`` the stacked layer weights (LayerNorm in
    f32, the rest in x's dtype). Returns (x_out [B, H], kvf).

    CPU tensors take the plain version; CUDA tensors launch the kernel, which
    takes float32 or bfloat16, head dim 64 and contiguous tensors, and raises
    on anything else (a grid the card cannot hold resident at once included)."""
    global launches
    if x.device.type == "cpu":
        return gpt2_decode_step_ref(x, kvf, valid, offset, blocks, num_heads, ln_eps)
    build.require_cuda(x, "x")
    build.require_cuda(kvf, "kvf")
    build.require_cuda(valid, "valid")
    b, h = x.shape
    n_layer, max_len = kvf.shape[:2]
    if h != num_heads * HEAD_DIM:
        raise ValueError(f"width {h} is not {num_heads} heads of {HEAD_DIM}")
    if kvf.shape != (n_layer, max_len, b, 2 * h) or kvf.dtype != x.dtype:
        raise ValueError(f"kvf must be [n_layer, max_len, {b}, {2 * h}] in {x.dtype}, got "
                         f"{tuple(kvf.shape)} {kvf.dtype}")
    if valid.dtype != torch.int32 or valid.shape != (b, max_len):
        raise ValueError(f"valid must be int32 [{b}, {max_len}], got {valid.dtype} "
                         f"{tuple(valid.shape)}")
    if not 0 <= offset < max_len:
        raise ValueError(f"offset {offset} outside the {max_len}-row cache")
    shapes = {"ln1_scale": (h,), "ln1_bias": (h,), "ln2_scale": (h,), "ln2_bias": (h,),
              "attn_w": (h, 3 * h), "attn_b": (3 * h,), "proj_w": (h, h), "proj_b": (h,),
              "fc_w": (h, 4 * h), "fc_b": (4 * h,), "out_w": (4 * h, h), "out_b": (h,)}
    for name, shape in shapes.items():
        t = blocks[name]
        build.require_cuda(t, name)
        want = torch.float32 if name in LN_KEYS else x.dtype
        if t.shape != (n_layer, *shape) or t.dtype != want:
            raise ValueError(f"{name} must be {want} {(n_layer, *shape)}, got {t.dtype} "
                             f"{tuple(t.shape)} (prepare_decode_params casts them)")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(x)
    q = torch.empty_like(x)
    attn = torch.empty_like(x)
    hid = torch.empty((b, 4 * h), dtype=x.dtype, device=x.device)
    build.launch("vct_decode_layer", x.data_ptr(), out.data_ptr(), kvf.data_ptr(),
                 valid.data_ptr(), *(blocks[k].data_ptr() for k in ("ln1_scale", "ln1_bias")),
                 *(blocks[k].data_ptr() for k in ("attn_w", "attn_b", "proj_w", "proj_b")),
                 *(blocks[k].data_ptr() for k in ("ln2_scale", "ln2_bias")),
                 *(blocks[k].data_ptr() for k in ("fc_w", "fc_b", "out_w", "out_b")),
                 q.data_ptr(), attn.data_ptr(), hid.data_ptr(), b, h, num_heads, n_layer,
                 max_len, int(offset), float(ln_eps), build.dtype_code(x.dtype),
                 build.stream_of(x))
    launches += 1
    return out, kvf
