"""Prefix mapper projection ``y = x @ W + b`` (kernel K2).

Counterpart of video_caption_tpu/ops/pallas/prefix_projector.py. The CUDA
kernel is ``csrc/prefix_projector.cu``; ``prefix_project_ref`` is the plain
PyTorch version. The kernel is the custom op ``vct::prefix_project`` (CPU
kernel: the plain version; CUDA kernel: the launch; a fake implementation
from shapes alone). It is differentiable: its backward
(``prefix_project_bwd``) is the JAX package's closed-form ``_project_bwd``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from video_caption_tpu_torch.ops import build

launches = 0
"""Number of times ``prefix_project`` launched its CUDA kernel."""

THREADS = 256          # threads of a block: column groups x K lanes x row groups
COLS = 32              # output columns of a block
MAX_ROWS_PER_THREAD = 8
MAX_KC = 256           # K rows of W a block stages at once
PAD = 4                # floats of padding per shared-memory row


@dataclass(frozen=True)
class Plan:
    """Launch geometry of ``csrc/prefix_projector.cu``: ``blocks`` blocks of
    THREADS threads, each a slab of COLS columns of W, staged ``kc`` K rows at
    a time; thread (group g, K lane l, row group q) sums K rows l, l + klanes,
    ... of a chunk for rows q + i * rowgroups (i < rows_per_thread) of each
    pass of ``row_chunk`` rows; ``smem`` bytes of dynamic shared memory."""

    vec: int           # columns of one 16-byte load of W
    groups: int        # 16-byte column groups of a slab
    rowgroups: int
    rows_per_thread: int
    klanes: int
    kc: int
    row_chunk: int
    blocks: int
    smem: int


def plan(rows: int, din: int, dout: int, w_bytes: int) -> Plan:
    """The geometry for x [rows, din] @ W [din, dout] with W of ``w_bytes``
    bytes: up to 4 rows one row group of 256 / groups K lanes, a thread
    taking every row (the rows rounded up to a power of two); each doubling
    of the rows past 4 doubles the row groups and halves the K lanes, up to
    8 row groups (so a warp stays within one), then up to 8 rows a thread.
    On the H100 4 rows a thread beat 8 at R = 8 (``cli/sweep_plans.py``)."""
    vec = 16 // w_bytes
    groups = COLS // vec
    rowgroups = 1
    while rowgroups < 8 and rowgroups * 4 < rows:
        rowgroups *= 2
    rows_per_thread = 1
    while rows_per_thread < MAX_ROWS_PER_THREAD and rows_per_thread * rowgroups < rows:
        rows_per_thread *= 2
    klanes = THREADS // (groups * rowgroups)
    kc = min(din, MAX_KC)
    row_chunk = rowgroups * rows_per_thread
    smem = 4 * (COLS + kc * (COLS + PAD) + row_chunk * kc + klanes * (row_chunk * COLS + PAD))
    return Plan(vec, groups, rowgroups, rows_per_thread, klanes, kc, row_chunk, -(-dout // COLS),
                smem)


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
    p = plan(rows, din, dout, w.element_size())
    x_vec = x.data_ptr() % 16 == 0 and din % 4 == 0       # else the kernel's scalar loads
    w_vec = w.data_ptr() % 16 == 0 and dout % p.vec == 0
    build.launch("vct_prefix_project", x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                 rows, din, dout, build.dtype_code(w.dtype), p.rowgroups, p.rows_per_thread,
                 p.kc, int(x_vec), int(w_vec), build.stream_of(x))
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


@torch.library.custom_op("vct::prefix_project", mutates_args=(), device_types="cpu")
def _op(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return prefix_project_ref(x, w, b)


@_op.register_kernel("cuda")
def _cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _launch(x, w, b)


@_op.register_fake
def _fake(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return x.new_empty((x.shape[0], w.shape[1]))


def _setup_context(ctx, inputs, output) -> None:
    x, w, b = inputs
    ctx.save_for_backward(x, w)
    ctx.b_dtype = b.dtype


def _backward(ctx, grad):
    x, w = ctx.saved_tensors
    return prefix_project_bwd(x, w, grad, ctx.b_dtype)


_op.register_autograd(_backward, setup_context=_setup_context)


def prefix_project(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, d_in] @ [d_in, d_out] + [d_out] -> [B, d_out], differentiable.

    CPU tensors take the plain version; CUDA tensors launch the kernel, which
    takes x in float32 and W, b both float32 or both bfloat16, and raises on
    anything else."""
    build.require_device(x, w, b)
    return _op(x, w, b)
