"""Temporal mean pool: [B,T,D] -> [B,D] (counterpart of
video_caption_tpu/ops/temporal_pool.py; reference mirror op:
core/operators/temporal_pool.py:7-15). Plain PyTorch: the JAX op is no
Pallas kernel."""
from __future__ import annotations

import torch


def temporal_mean_pool(x: torch.Tensor) -> torch.Tensor:
    if x.ndim != 3:
        raise ValueError(f"expected [B,T,D], got {tuple(x.shape)}")
    return x.mean(dim=1)
