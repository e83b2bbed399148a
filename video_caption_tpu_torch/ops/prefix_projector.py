"""Prefix mapper projection ``y = x @ W + b`` (kernel K2).

Counterpart of video_caption_tpu/ops/pallas/prefix_projector.py. The CUDA
kernel is ``csrc/prefix_projector.cu``; ``prefix_project_ref`` is the plain
PyTorch version. ``prefix_project`` is differentiable: its backward
(``prefix_project_bwd``) is the JAX package's closed-form ``_project_bwd``.
"""
from __future__ import annotations

import torch

from video_caption_tpu_torch.ops import build

launches = 0
"""Number of times ``prefix_project`` launched its CUDA kernel."""


def prefix_project_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """W and b cast to x's dtype, as the TPU wrapper casts them."""
    return x @ w.to(x.dtype) + b.to(x.dtype)


def _launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    global launches
    for name, t in (("x", x), ("w", w), ("b", b)):
        build.require_cuda(t, name)
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if w.dtype != b.dtype:
        raise TypeError(f"w and b must share a dtype, got {w.dtype} and {b.dtype}")
    if x.ndim != 2 or w.ndim != 2 or b.shape != (w.shape[1],) or x.shape[1] != w.shape[0]:
        raise ValueError(f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)} "
                         "do not form x @ w + b")
    rows, (din, dout) = x.shape[0], w.shape
    y = torch.empty((rows, dout), dtype=torch.float32, device=x.device)
    if rows == 0:
        return y
    build.launch("vct_prefix_project", x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                 rows, din, dout, build.dtype_code(w.dtype), build.stream_of(x))
    launches += 1
    return y


def prefix_project_bwd(x: torch.Tensor, w: torch.Tensor, grad: torch.Tensor,
                       b_dtype: torch.dtype) -> tuple:
    """(dx, dW, db) for ``grad`` [B, d_out], in f32: dx = g W^T, dW = x^T g,
    db = sum of g over rows, each cast to its input's dtype."""
    gf = grad.float()
    dx = (gf @ w.float().t()).to(x.dtype)
    dw = (x.float().t() @ gf).to(w.dtype)
    return dx, dw, gf.sum(dim=0).to(b_dtype)


class _PrefixProject(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.b_dtype = b.dtype
        if x.device.type == "cpu":
            return prefix_project_ref(x, w, b)
        return _launch(x, w, b)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        return prefix_project_bwd(x, w, grad, ctx.b_dtype)


def prefix_project(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, d_in] @ [d_in, d_out] + [d_out] -> [B, d_out], differentiable.

    CPU tensors take the plain version; CUDA tensors launch the kernel, which
    takes x in float32 and W, b both float32 or both bfloat16, and raises on
    anything else."""
    return _PrefixProject.apply(x, w, b)
