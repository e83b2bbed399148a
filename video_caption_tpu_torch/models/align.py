"""Dual-encoder video<->text alignment model (counterpart of
video_caption_tpu/models/align.py).

Video branch: frame-wise ViT -> temporal pool -> Linear proj -> L2-normalize;
text branch: Embedding -> 2-layer bidirectional Transformer encoder (8
heads) -> masked mean -> proj -> L2-normalize; cosine-embedding loss. The
stage-1 joint step (cli/train_full.py ``--model vit``) trains it end to end,
the encoder included: with ``pool="gap"`` its forward runs the attention and
fused pool kernels, and its backward their closed-form gradients.

Parameters keep the JAX package's tree (blocks stacked along a leading
layer axis, weights stored ``[in, out]``); the text branch runs in f32, as
in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import torch
import torch.nn.functional as F

from video_caption_tpu_torch.models import vit as vt

Params = Dict[str, Any]


@dataclass(frozen=True)
class AlignConfig:
    vit: vt.ViTConfig = field(default_factory=vt.ViTConfig)
    vocab_size: int = 50257
    max_text_len: int = 64
    text_dim: int = 256
    text_layers: int = 2
    text_heads: int = 8
    embed_dim: int = 256          # shared retrieval space
    temporal_mode: str = "mean"
    """Video-branch temporal pooling: "mean" (``vit_encode``: the temporal
    mean, through the fused pool kernel with gap) or "diff" (concat of the
    temporal mean and last-minus-first frame features of the per-frame
    path, so the projection's input is 2 * vit.out_dim wide)."""


def init_align_params(gen: torch.Generator, cfg: AlignConfig, device) -> Params:
    """Random parameters with the shapes and stddevs of the JAX init, drawn
    from ``gen`` on ``device`` (the values differ from the JAX init's)."""
    d, td = cfg.text_layers, cfg.text_dim

    def nrm(*shape):
        return torch.randn(shape, generator=gen, device=device) * 0.02

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    def ones(*shape):
        return torch.ones(shape, device=device)

    vproj_in = cfg.vit.out_dim * (2 if cfg.temporal_mode == "diff" else 1)
    return {
        "vit": vt.init_vit_params(gen, cfg.vit, device),
        "video_proj": {"w": nrm(vproj_in, cfg.embed_dim), "b": zeros(cfg.embed_dim)},
        "tok_embed": nrm(cfg.vocab_size, td),
        "pos_embed": nrm(cfg.max_text_len, td),
        "text_blocks": {
            "ln1_scale": ones(d, td), "ln1_bias": zeros(d, td),
            "qkv_w": nrm(d, td, 3 * td), "qkv_b": zeros(d, 3 * td),
            "proj_w": nrm(d, td, td), "proj_b": zeros(d, td),
            "ln2_scale": ones(d, td), "ln2_bias": zeros(d, td),
            "fc1_w": nrm(d, td, 4 * td), "fc1_b": zeros(d, 4 * td),
            "fc2_w": nrm(d, 4 * td, td), "fc2_b": zeros(d, td),
        },
        "text_proj": {"w": nrm(td, cfg.embed_dim), "b": zeros(cfg.embed_dim)},
    }


def _l2(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)


def encode_video(params: Params, video: torch.Tensor, cfg: AlignConfig) -> torch.Tensor:
    """[B,T,3,H,W] -> L2-normalized [B, embed_dim] f32."""
    if cfg.temporal_mode == "diff":
        b, t = video.shape[0], video.shape[1]
        pf = vt.vit_encode_frames(params["vit"], video.reshape(b * t, *video.shape[2:]), cfg.vit)
        pf = vt.linear(pf, params["vit"]["head"]["w"], params["vit"]["head"]["b"])
        pf = pf.reshape(b, t, -1).float()
        feat = torch.cat([pf.mean(dim=1), pf[:, -1] - pf[:, 0]], dim=-1)
    else:
        feat = vt.vit_encode(params["vit"], video, cfg.vit)
    return _l2(feat @ params["video_proj"]["w"] + params["video_proj"]["b"])


def encode_text(params: Params, ids: torch.Tensor, mask: torch.Tensor,
                cfg: AlignConfig) -> torch.Tensor:
    """[B,L] tokens + [B,L] mask -> L2-normalized [B, embed_dim]: pre-LN
    blocks (LayerNorm eps 1e-5) with bidirectional attention under a
    key-padding mask, then the masked mean over tokens."""
    b, length = ids.shape
    heads = cfg.text_heads
    hd = cfg.text_dim // heads
    x = params["tok_embed"][ids.long()] + params["pos_embed"][None, :length]
    keep = (mask > 0)[:, None, None, :]
    blocks = params["text_blocks"]
    for layer in range(cfg.text_layers):
        blk = {k: v[layer] for k, v in blocks.items()}
        h = F.layer_norm(x, (cfg.text_dim,), blk["ln1_scale"], blk["ln1_bias"], 1e-5)
        qkv = (h @ blk["qkv_w"] + blk["qkv_b"]).reshape(b, length, 3, heads, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", qkv[:, :, 0], qkv[:, :, 1]) * (hd ** -0.5)
        attn = torch.softmax(torch.where(keep, logits, -1e30), dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", attn, qkv[:, :, 2]).reshape(b, length, -1)
        x = x + o @ blk["proj_w"] + blk["proj_b"]
        h = F.layer_norm(x, (cfg.text_dim,), blk["ln2_scale"], blk["ln2_bias"], 1e-5)
        h = F.gelu(h @ blk["fc1_w"] + blk["fc1_b"], approximate="tanh")
        x = x + h @ blk["fc2_w"] + blk["fc2_b"]
    maskf = mask.to(x.dtype)
    pooled = (x * maskf[..., None]).sum(dim=1) / maskf.sum(dim=1, keepdim=True).clamp(min=1)
    return _l2(pooled @ params["text_proj"]["w"] + params["text_proj"]["b"])


def cosine_embedding_loss(v_emb: torch.Tensor, t_emb: torch.Tensor, target: torch.Tensor,
                          margin: float = 0.0) -> torch.Tensor:
    """torch CosineEmbeddingLoss semantics on L2-normalized embeddings:
    target +1 -> 1 - cos; target -1 -> max(0, cos - margin)."""
    cos = (v_emb * t_emb).sum(dim=-1)
    return torch.where(target > 0, 1.0 - cos, (cos - margin).clamp(min=0.0)).mean()
