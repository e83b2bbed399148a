"""The device half of the 4:2:0 wire: raw YCbCr planes -> RGB, bit-exact
with libjpeg and so with the PIL decode path (counterpart of
video_caption_tpu/preprocessing/yuv420.py).

JPEGs that are 4:2:0 at exactly the model's size ship as their raw decoded
planes (Y at full resolution, Cb and Cr at a quarter: 1.5 bytes a pixel
instead of RGB's 3); the native loader stops decoding at the plane stage
(frame_loader.cpp ``vct_load_frames_yuv420``) and this module finishes the
decode on the tensor's device:

- **h2v2 fancy upsample** (libjpeg jdsample.c ``h2v2_fancy_upsample``, what
  PIL uses): ``colsum = 3 * near_row + far_row``, then horizontally
  ``(3 * this + prev + 8) >> 4`` and ``(3 * this + next + 7) >> 4`` with the
  edges clamped;
- **YCbCr -> RGB** (jdcolor.c ``build_ycc_rgb_table``): fixed point with 16
  fraction bits and the ``ONE_HALF`` rounding bias. libjpeg's
  ``RIGHT_SHIFT`` of the negative green term is arithmetic, and so is
  torch's ``>>`` on int32.

Elementwise and gather int32 operations in plain PyTorch, as the JAX package
has them in plain ``jnp``: on the card they run inside the engine's chunk
graph (engine.py), so no kernel of their own.
"""
from __future__ import annotations

import numpy as np
import torch

# jdcolor.c's constants: FIX(x) = int(x * 65536 + 0.5)
_FIX_1_40200 = 91881    # Cr -> R
_FIX_1_77200 = 116130   # Cb -> B
_FIX_0_34414 = 22554    # Cb -> G (negative)
_FIX_0_71414 = 46802    # Cr -> G (negative)
_ONE_HALF = 1 << 15


def packed_plane_len(size: int) -> int:
    """Bytes a frame of the packed layout (Y | Cb | Cr)."""
    cs = (size + 1) // 2
    return size * size + 2 * cs * cs


def _fancy_upsample_h2v2(c: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """libjpeg's h2v2 fancy upsample of int32 chroma [..., h2, w2] ->
    [..., out_h, out_w] (out_h is 2*h2, or 2*h2-1 for an odd size; so is
    the width)."""
    h2, w2 = c.shape[-2], c.shape[-1]
    # output row v weighs its near input row v//2 3:1 against the row above
    # (even v) or below (odd v), clamped at the edges
    v = torch.arange(out_h, device=c.device)
    near = v // 2
    far = (near + 2 * (v % 2) - 1).clamp(0, h2 - 1)
    colsum = 3 * c.index_select(-2, near) + c.index_select(-2, far)
    j = torch.arange(w2, device=c.device)
    left = colsum.index_select(-1, (j - 1).clamp(min=0))
    right = colsum.index_select(-1, (j + 1).clamp(max=w2 - 1))
    even = (3 * colsum + left + 8) >> 4
    odd = (3 * colsum + right + 7) >> 4
    out = torch.stack([even, odd], dim=-1).reshape(*c.shape[:-2], out_h, 2 * w2)
    return out[..., :out_w]


def yuv420_packed_to_rgb_chw(packed: torch.Tensor, size: int) -> torch.Tensor:
    """[T, packed_plane_len] uint8 planes -> [T, 3, size, size] uint8 RGB on
    the same device, bit-equal to libjpeg's full decode."""
    t = packed.shape[0]
    cs = (size + 1) // 2
    ysz = size * size
    x = packed.to(torch.int32)
    y = x[:, :ysz].reshape(t, size, size)
    cb = _fancy_upsample_h2v2(x[:, ysz:ysz + cs * cs].reshape(t, cs, cs), size, size) - 128
    cr = _fancy_upsample_h2v2(x[:, ysz + cs * cs:].reshape(t, cs, cs), size, size) - 128
    r = y + ((_FIX_1_40200 * cr + _ONE_HALF) >> 16)
    b = y + ((_FIX_1_77200 * cb + _ONE_HALF) >> 16)
    g = y + ((-_FIX_0_34414 * cb - _FIX_0_71414 * cr + _ONE_HALF) >> 16)
    return torch.stack([r, g, b], dim=1).clamp(0, 255).to(torch.uint8)


def yuv420_packed_to_rgb_chw_np(packed: np.ndarray, size: int) -> np.ndarray:
    """numpy in, numpy out: ``yuv420_packed_to_rgb_chw`` on the CPU (the
    training loader's conversion of a mixed batch, and the tests' mirror)."""
    return yuv420_packed_to_rgb_chw(torch.from_numpy(np.ascontiguousarray(packed)), size).numpy()
