"""Prefix normalization between the projection and the mapper
(counterpart of video_caption_tpu/ops/prefix_norm.py).

``emb -> layer_norm(emb) * ln_scale * in_weight`` with each factor applied
only when > 0; the LayerNorm runs in f32 with eps 1e-5 and no affine terms.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def apply_prefix_norm(emb: torch.Tensor, ln_scale: Optional[float] = 0.6,
                      in_weight: Optional[float] = 0.4) -> torch.Tensor:
    if emb.ndim == 2:
        emb = emb[:, None, :]
    if ln_scale is not None and ln_scale > 0:
        y = F.layer_norm(emb.float(), (emb.shape[-1],), eps=1e-5)
        emb = (y * ln_scale).to(emb.dtype)
    if in_weight is not None and in_weight > 0:
        emb = emb * in_weight
    return emb
