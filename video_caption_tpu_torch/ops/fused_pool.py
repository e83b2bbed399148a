"""Fused spatial pool + temporal mean of the ViT token stream (kernel K7).

Counterpart of video_caption_tpu/ops/pallas/fused_pool.py. The CUDA kernel is
``csrc/fused_pool.cu``; ``fused_pool_ref`` is the plain PyTorch version, the
mirror of the JAX package's ``_xla_pool``. ``fused_pool_temporal`` is
differentiable: its backward (``fused_pool_bwd``) is the closed-form
broadcast of the JAX package's ``_pool_bwd``, so training through the
encoder keeps the kernel in its forward.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from video_caption_tpu_torch.ops import build

launches = 0
"""Number of times ``fused_pool_temporal`` launched its CUDA kernel."""

MODES = ("cls", "gap")
THREADS = 256        # threads of a block: column groups x row lanes
MAX_SPLITS = 8       # blocks of a cluster (the portable maximum)
MIN_LANE_ROWS = 4    # rows a row lane reads at least, once a video is split


@dataclass(frozen=True)
class Plan:
    """Launch geometry of ``csrc/fused_pool.cu``: grid (splits, tiles, batch)
    of THREADS-thread blocks; a block sums ``tile_vecs`` groups of ``vec``
    columns over pooled rows [split * rows_per_split, +rows_per_split) of its
    video, its thread (group g, lane l) rows l, l + lanes, ...; the splits
    blocks of a (video, tile) form one cluster."""

    batch: int
    vec: int             # columns of one 16-byte load
    tile_vecs: int
    lanes: int
    tiles: int
    rows: int            # pooled rows of a video
    splits: int
    rows_per_split: int

    @property
    def blocks(self) -> int:
        return self.splits * self.tiles * self.batch


def plan(batch: int, frames: int, seq: int, h: int, dtype_bytes: int, n_sm: int = 132,
         mode: str = "gap") -> Plan:
    """The geometry for tokens [batch * frames, seq, h] of ``dtype_bytes``
    bytes. Tiles of 8 groups (128 bytes of a row per warp), and the fewest
    splits (a power of two, at most MAX_SPLITS, each row lane reading at
    least MIN_LANE_ROWS rows) that give 2.5 blocks per SM: on the H100 ~384
    blocks of 256 threads read fastest (``cli/sweep_plans.py``). Tiles of 4
    groups only where 8 fall short and 4 reach it."""
    vec = 16 // dtype_bytes
    groups = -(-h // vec)
    rows = frames * (seq - 1 if mode == "gap" else 1)
    target = 5 * n_sm // 2

    def geometry(tile_vecs):
        lanes, tiles = THREADS // tile_vecs, -(-groups // tile_vecs)
        most = min(MAX_SPLITS, max(1, rows // (lanes * MIN_LANE_ROWS)))
        splits = 1
        while 2 * splits <= most and batch * tiles * splits < target:
            splits *= 2
        return Plan(batch, vec, tile_vecs, lanes, tiles, rows, splits, -(-rows // splits))

    p = geometry(8)
    if p.blocks < target and geometry(4).blocks >= target:
        p = geometry(4)
    return p


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(tokens: torch.Tensor, batch: int, frames: int, mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if tokens.ndim != 3 or tokens.shape[0] != batch * frames or batch <= 0 or frames <= 0:
        raise ValueError(f"tokens must be [batch * frames, S, H] = [{batch} * {frames}, S, H], "
                         f"got {tuple(tokens.shape)}")
    if mode == "gap" and tokens.shape[1] < 2:
        raise ValueError("gap pooling needs the CLS token and at least one patch token")


def fused_pool_ref(tokens: torch.Tensor, batch: int, frames: int, mode: str) -> torch.Tensor:
    """[B*T, S, H] -> [B, H] in the tokens' dtype: each frame's mean (gap: of
    tokens 1..S-1; cls: token 0) in f32, then the mean over frames."""
    _check(tokens, batch, frames, mode)
    if mode == "gap":
        per_frame = tokens[:, 1:, :].float().mean(dim=1)
    else:
        per_frame = tokens[:, 0, :].float()
    return per_frame.reshape(batch, frames, -1).mean(dim=1).to(tokens.dtype)


def _launch(tokens: torch.Tensor, batch: int, frames: int, mode: str) -> torch.Tensor:
    global launches
    build.require_cuda(tokens, "tokens")
    _check(tokens, batch, frames, mode)
    _, s, h = tokens.shape
    out = torch.empty((batch, h), dtype=tokens.dtype, device=tokens.device)
    if h == 0:
        return out
    size = tokens.element_size()
    p = plan(batch, frames, s, h, size, _sm_count(tokens.get_device()), mode)
    vector = tokens.data_ptr() % 16 == 0 and h % p.vec == 0   # else the kernel's scalar loads
    build.launch("vct_fused_pool", tokens.data_ptr(), out.data_ptr(), batch, frames, s, h,
                 int(mode == "gap"), build.dtype_code(tokens.dtype), p.tile_vecs, p.splits,
                 p.rows_per_split, int(vector), build.stream_of(tokens))
    launches += 1
    return out


def fused_pool_bwd(grad: torch.Tensor, seq: int, frames: int, mode: str,
                   dtype: torch.dtype = None) -> torch.Tensor:
    """Gradient of the pool for ``grad`` [B, H]: [B*T, S, H] in ``dtype``
    (the tokens'; grad's by default), ``grad / T / (S-1)`` on tokens 1..S-1
    of every frame (gap) or ``grad / T`` on token 0 (cls), zeros elsewhere;
    the f32 divisions of ``_xla_pool``'s two means."""
    b, h = grad.shape
    share = grad.float() / frames
    if mode == "gap":
        share = share / (seq - 1)
    out = torch.zeros((b, frames, seq, h), dtype=dtype or grad.dtype, device=grad.device)
    rows = slice(1, None) if mode == "gap" else slice(0, 1)
    out[:, :, rows, :] = share.to(out.dtype)[:, None, None, :]
    return out.reshape(b * frames, seq, h)


class _FusedPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tokens, batch, frames, mode):
        ctx.geometry = (tokens.shape[1], frames, mode, tokens.dtype)
        if tokens.device.type == "cpu":
            return fused_pool_ref(tokens, batch, frames, mode)
        return _launch(tokens, batch, frames, mode)

    @staticmethod
    def backward(ctx, grad):
        return fused_pool_bwd(grad.contiguous(), *ctx.geometry), None, None, None


def fused_pool_temporal(tokens: torch.Tensor, batch: int, frames: int,
                        mode: str = "cls") -> torch.Tensor:
    """[B*T, S, H] -> [B, H] in the tokens' dtype, differentiable.

    CPU tensors take the plain version; CUDA tensors launch the kernel, which
    takes float32 or bfloat16 tokens of any H, and raises on anything else."""
    return _FusedPool.apply(tokens, batch, frames, mode)
