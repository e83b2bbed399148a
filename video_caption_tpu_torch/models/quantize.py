"""Weight-only int8 for the GPT-2 decoder (counterpart of
video_caption_tpu/models/quantize.py).

The four matmul weights of every block (attn_w, proj_w, fc_w, out_w) are
stored as int8 with one f32 scale per output channel; embeddings (wte
doubles as the LM head), LayerNorms and biases keep their dtype. The
tensors stay int8 in device memory: every use dequantizes in the JAX
order, ``(q.float() * scale).to(dtype)``, and the product then runs in
``dtype`` (plain PyTorch ops, as XLA's dequantize-then-matmul is in the
JAX package).

Scheme: symmetric per output channel, ``scale = max(max|w[:, o]|, 1e-8) /
127``, ``q = clip(round(w / scale), -127, 127)`` with round half to even
(``torch.round``, as ``jnp.round``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

QUANTIZED_BLOCK_WEIGHTS = ("attn_w", "proj_w", "fc_w", "out_w")


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[..., in, out] -> {"q": int8, "scale": f32 [..., out]} (symmetric)."""
    wf = w.float()
    scale = wf.abs().amax(dim=-2).clamp_min(1e-8) / 127.0
    q = torch.round(wf / scale[..., None, :]).clamp(-127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def dequantize_weight(qw: Dict[str, torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """int8 + scales -> the weight in ``dtype``."""
    return (qw["q"].float() * qw["scale"][..., None, :]).to(dtype)


def quantize_gpt2_blocks(decoder_params: Dict[str, Any]) -> Dict[str, Any]:
    """The stacked block matmul weights in quantized form: ``attn_w`` ->
    ``attn_w_q`` (int8 [d, in, out]) + ``attn_w_s`` (f32 [d, out])."""
    blocks = dict(decoder_params["blocks"])
    for name in QUANTIZED_BLOCK_WEIGHTS:
        if name in blocks:
            qw = quantize_weight(blocks.pop(name))
            blocks[name + "_q"] = qw["q"]
            blocks[name + "_s"] = qw["scale"]
    return {**decoder_params, "blocks": blocks}


def is_quantized(blocks: Dict[str, Any]) -> bool:
    return any(name + "_q" in blocks for name in QUANTIZED_BLOCK_WEIGHTS)


def is_scale(blocks: Dict[str, Any], key: str) -> bool:
    """Whether ``key`` of a block tree is a quantized weight's f32 scale,
    which no dtype cast may touch."""
    return key.endswith("_s") and key[:-2] + "_q" in blocks


def block_weight(blk: Dict[str, torch.Tensor], name: str, dtype: torch.dtype) -> torch.Tensor:
    """A block matmul weight in ``dtype``, dequantized when stored int8."""
    if name + "_q" in blk:
        return dequantize_weight({"q": blk[name + "_q"], "scale": blk[name + "_s"]}, dtype)
    return blk[name].to(dtype)


def quantization_error(w: torch.Tensor) -> float:
    """Max relative reconstruction error of the scheme on ``w``."""
    back = dequantize_weight(quantize_weight(w), torch.float32)
    denom = w.float().abs().max().clamp_min(1e-8)
    return float((back - w.float()).abs().max() / denom)
