"""ViT encoder attention over the raw fused-QKV activation (kernel K1).

Counterpart of video_caption_tpu/ops/pallas/encoder_attention.py. The CUDA
kernel is ``csrc/encoder_attention.cu``; ``encoder_attention_ref`` is the
plain PyTorch version, the mirror of the JAX package's ``_xla_reference``.
The kernel is the custom op ``vct::encoder_attention``: its CPU kernel is
the plain version, its CUDA kernel the launch, and its fake implementation
gives the output's shape from the input's alone, so ``torch.export`` traces
through it. The op is differentiable: its backward
(``encoder_attention_bwd``) recomputes the f32 probabilities from the saved
``qkv`` and differentiates the plain version's arithmetic in closed form, as
the JAX package's ``_attention_bwd`` takes ``jax.vjp`` of ``_xla_reference``.
"""
from __future__ import annotations

import torch

from video_caption_tpu_torch.ops import build

launches = 0
"""Number of times ``encoder_attention`` launched its CUDA kernel."""

HEAD_DIM = 64       # the head dim the kernel is built for
MAX_SEQ = 256       # a warp holds its rows' logits against every key in registers
                    # (16 tiles of 16 keys), in bf16 and f32 alike


def encoder_attention_ref(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[N, S, 3H] -> [N, S, H]: f32 logits and softmax, probabilities cast to
    the input dtype, AV in the input dtype, heads merged."""
    n, s, h3 = qkv.shape
    h = h3 // 3
    hd = h // num_heads
    r = qkv.reshape(n, s, 3, num_heads, hd)
    q = r[:, :, 0].transpose(1, 2)
    k = r[:, :, 1].transpose(1, 2)
    v = r[:, :, 2].transpose(1, 2)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (hd ** -0.5)
    attn = torch.softmax(logits, dim=-1).to(qkv.dtype)
    out = torch.matmul(attn, v)
    return out.transpose(1, 2).reshape(n, s, h)


def _launch(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    global launches
    build.require_cuda(qkv, "qkv")
    if qkv.ndim != 3 or qkv.shape[-1] != 3 * num_heads * HEAD_DIM:
        raise ValueError(f"qkv must be [N, S, 3 * {num_heads} * {HEAD_DIM}], got {tuple(qkv.shape)}")
    n, s, h3 = qkv.shape
    if not 0 < s <= MAX_SEQ:
        raise ValueError(f"sequence length {s} outside 1..{MAX_SEQ}")
    if n > 65535:
        raise ValueError(f"{n} frames: the kernel's grid takes at most 65535")
    if qkv.data_ptr() % 16:
        raise ValueError("qkv must be 16-byte aligned: the kernel loads it in 16-byte chunks")
    out = torch.empty((n, s, h3 // 3), dtype=qkv.dtype, device=qkv.device)
    if n == 0:
        return out
    build.launch("vct_encoder_attention", qkv.data_ptr(), out.data_ptr(), n, s, h3 // 3,
                 num_heads, build.dtype_code(qkv.dtype), build.stream_of(qkv))
    launches += 1
    return out


def encoder_attention_bwd(qkv: torch.Tensor, grad_out: torch.Tensor, num_heads: int) -> torch.Tensor:
    """d(qkv) [N, S, 3H] for ``grad_out`` [N, S, H], rounding where the plain
    version rounds: the probabilities recomputed in f32 and cast to the
    dtype, dV = P^T dO and dP = dO V^T in the dtype, the softmax VJP in f32,
    dQ and dK from the logits' gradient scaled by hd^-0.5, in f32, cast to
    the dtype."""
    n, s, h3 = qkv.shape
    hd = h3 // 3 // num_heads
    dt = qkv.dtype
    r = qkv.reshape(n, s, 3, num_heads, hd)
    q, k, v = (r[:, :, i].transpose(1, 2) for i in range(3))           # [N,nh,S,hd]
    qf, kf = q.float(), k.float()
    probs = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) * (hd ** -0.5), dim=-1)
    do = grad_out.reshape(n, s, num_heads, hd).transpose(1, 2).to(dt)
    dv = torch.matmul(probs.to(dt).transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2)).float()
    dlogits = probs * (dp - (dp * probs).sum(dim=-1, keepdim=True)) * (hd ** -0.5)
    dq = torch.matmul(dlogits, kf).to(dt)
    dk = torch.matmul(dlogits.transpose(-1, -2), qf).to(dt)
    return torch.stack([dq, dk, dv], dim=2).transpose(1, 3).reshape(n, s, h3)


@torch.library.custom_op("vct::encoder_attention", mutates_args=(), device_types="cpu")
def _op(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    return encoder_attention_ref(qkv, num_heads)


@_op.register_kernel("cuda")
def _cuda(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    return _launch(qkv, num_heads)


@_op.register_fake
def _fake(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    n, s, h3 = qkv.shape
    return qkv.new_empty((n, s, h3 // 3))


def _setup_context(ctx, inputs, output) -> None:
    qkv, ctx.num_heads = inputs
    ctx.save_for_backward(qkv)


def _backward(ctx, grad):
    (qkv,) = ctx.saved_tensors
    return encoder_attention_bwd(qkv, grad, ctx.num_heads), None


_op.register_autograd(_backward, setup_context=_setup_context)


def encoder_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Fused-QKV activation [N, S, 3H] -> attention output [N, S, H],
    differentiable.

    CPU tensors take the plain version; CUDA tensors launch the kernel, which
    takes float32 or bfloat16, head dim 64, S <= MAX_SEQ (256), N <= 65535
    frames and qkv 16-byte aligned, and raises on anything else."""
    build.require_device(qkv)
    return _op(qkv, num_heads)
