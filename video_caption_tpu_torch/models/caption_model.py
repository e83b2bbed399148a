"""Composite caption model: ViT encoder + optional projection + prefix norm +
prefix mapper + GPT-2 (counterpart of video_caption_tpu/models/caption_model.py).

The mapper product runs through the prefix-projector kernel
(ops/prefix_projector.py) on the GPU. ``compute_loss`` is the teacher-forcing
loss of the mapper trainer (training/mapper_trainer.py). ``encode_video``
also takes the packed 4:2:0 wire (preprocessing/yuv420.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import torch

from video_caption_tpu_torch.models import gpt2 as g2
from video_caption_tpu_torch.models import vit as vt
from video_caption_tpu_torch.ops.prefix_norm import apply_prefix_norm
from video_caption_tpu_torch.ops.prefix_projector import prefix_project
from video_caption_tpu_torch.preprocessing.yuv420 import yuv420_packed_to_rgb_chw

Params = Dict[str, Any]


@dataclass(frozen=True)
class CaptionModelConfig:
    vit: vt.ViTConfig = field(default_factory=vt.ViTConfig)
    gpt2: g2.GPT2Config = field(default_factory=g2.GPT2Config)
    prefix_len: int = 4
    video_dim: int = 256
    proj_hidden: int = 0          # MLP adapter width (0 = identity)
    ln_scale: float = 0.6
    in_weight: float = 0.4
    freeze_encoder: bool = False
    """Training: the encoder (and its adapters) runs under ``no_grad``, the
    counterpart of the JAX package's ``stop_gradient``; no backward pass is
    built through it."""

    @property
    def mapper_out(self) -> int:
        return self.gpt2.n_embd * self.prefix_len


def init_caption_model(seed: int, cfg: CaptionModelConfig, device) -> Params:
    """Random parameters with the shapes and stddevs of the JAX
    ``init_caption_model``, drawn from a torch.Generator on ``device`` seeded
    with ``seed`` (the values differ from the JAX init's)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def nrm(*shape):
        return torch.randn(shape, generator=gen, device=device) * 0.02

    params: Params = {
        "encoder": vt.init_vit_params(gen, cfg.vit, device),
        "mapper": {"w": nrm(cfg.video_dim, cfg.mapper_out),
                   "b": torch.zeros(cfg.mapper_out, device=device)},
        "decoder": g2.init_gpt2_params(gen, cfg.gpt2, device),
    }
    if cfg.vit.out_dim != cfg.video_dim:
        params["proj"] = {"w": nrm(cfg.vit.out_dim, cfg.video_dim),
                          "b": torch.zeros(cfg.video_dim, device=device)}
    if cfg.proj_hidden > 0:
        params["proj_mlp"] = {
            "fc1": {"w": nrm(cfg.video_dim, cfg.proj_hidden),
                    "b": torch.zeros(cfg.proj_hidden, device=device)},
            "fc2": {"w": nrm(cfg.proj_hidden, cfg.video_dim),
                    "b": torch.zeros(cfg.video_dim, device=device)},
        }
    return params


def _f32_linear(x: torch.Tensor, p: Params) -> torch.Tensor:
    return x @ p["w"].float() + p["b"].float()


def _adapt(params: Params, emb: torch.Tensor) -> torch.Tensor:
    """The optional projection / MLP adapter after the encoder (f32)."""
    if "proj" in params:
        emb = _f32_linear(emb, params["proj"])
    if "proj_mlp" in params:
        m = params["proj_mlp"]
        emb = _f32_linear(torch.relu(_f32_linear(emb, m["fc1"])), m["fc2"])
    return emb


def encode_video(params: Params, video: torch.Tensor, cfg: CaptionModelConfig) -> torch.Tensor:
    """[B,T,3,H,W] (f32 or uint8), or [B,T,plane_len] packed 4:2:0 planes
    (the device finishes their JPEG decode bit-exactly first) -> projected
    video embedding [B, video_dim] f32."""
    if video.ndim == 3:
        b, t = video.shape[0], video.shape[1]
        size = cfg.vit.image_size
        video = yuv420_packed_to_rgb_chw(video.reshape(b * t, -1), size).reshape(
            b, t, 3, size, size)
    return _adapt(params, vt.vit_encode(params["encoder"], video, cfg.vit))


def map_prefix(params: Params, emb: torch.Tensor, cfg: CaptionModelConfig) -> torch.Tensor:
    """Normalized video embedding -> prefix token embeddings [B,P,H]."""
    if emb.ndim == 3:
        emb = emb[:, 0, :]
    out = prefix_project(emb.contiguous(), params["mapper"]["w"], params["mapper"]["b"])
    return out.reshape(emb.shape[0], cfg.prefix_len, cfg.gpt2.n_embd)


def video_to_prefix(params: Params, video: torch.Tensor, cfg: CaptionModelConfig) -> torch.Tensor:
    """encode -> proj -> prefix norm -> mapper -> [B,P,H] f32."""
    emb = apply_prefix_norm(encode_video(params, video, cfg), cfg.ln_scale, cfg.in_weight)
    return map_prefix(params, emb, cfg)


def encode_frames(params: Params, frames: torch.Tensor, cfg: CaptionModelConfig) -> torch.Tensor:
    """Per-frame half of the visual branch: [C,3,H,W] -> [C, embed_dim]."""
    return vt.vit_encode_frames(params["encoder"], frames, cfg.vit)


def frames_to_prefix(params: Params, per_frame: torch.Tensor,
                     cfg: CaptionModelConfig) -> torch.Tensor:
    """Finish the visual branch from per-frame features [B,T,embed_dim]:
    ``frames_to_prefix(encode_frames(...)) == video_to_prefix(video)``."""
    emb = _adapt(params, vt.vit_finish(params["encoder"], per_frame, cfg.vit))
    return map_prefix(params, apply_prefix_norm(emb, cfg.ln_scale, cfg.in_weight), cfg)


def build_decoder_inputs(params: Params, prefix: torch.Tensor, input_ids: torch.Tensor,
                         cfg: CaptionModelConfig) -> torch.Tensor:
    """concat(prefix_embeds, wte(input_ids)); a vocab-sharded ``wte`` (the
    training placement under TP) through the vocab-parallel lookup."""
    tok = g2.embed_tokens(params["decoder"], input_ids, cfg.gpt2)
    return torch.cat([prefix.to(tok.dtype), tok], dim=1)


def compute_loss(params: Params, video: torch.Tensor, input_ids: torch.Tensor,
                 attn_mask: torch.Tensor, cfg: CaptionModelConfig,
                 labels: torch.Tensor = None) -> torch.Tensor:
    """Teacher-forcing loss: the prefix positions get attention 1 and label
    -100, positions are ``cumsum(mask) - 1`` clamped at 0, caption padding
    is ignored. Under a mesh (``cfg.gpt2.mesh``) the batch is this data
    rank's rows and the loss its share (``g2.lm_loss``): the data ranks'
    losses sum to the whole batch's."""
    b = video.shape[0]
    if cfg.freeze_encoder:
        with torch.no_grad():
            emb = encode_video(params, video, cfg)
        prefix = map_prefix(params, apply_prefix_norm(emb, cfg.ln_scale, cfg.in_weight), cfg)
    else:
        prefix = video_to_prefix(params, video, cfg)
    p = prefix.shape[1]
    embeds = build_decoder_inputs(params, prefix, input_ids, cfg)
    dev = input_ids.device
    full_mask = torch.cat([torch.ones((b, p), dtype=torch.int32, device=dev),
                           attn_mask.to(torch.int32)], dim=1)
    positions = (torch.cumsum(full_mask, dim=1) - 1).clamp(min=0)
    logits = g2.gpt2_logits_nocache(params["decoder"], embeds, positions, full_mask, cfg.gpt2)
    if labels is None:
        labels = torch.where(attn_mask > 0, input_ids, -100)
    full_labels = torch.cat([torch.full((b, p), -100, dtype=labels.dtype, device=dev), labels],
                            dim=1)
    return g2.lm_loss(logits, full_labels, cfg.gpt2.mesh,
                      vocab_parallel=g2.vocab_sharded(params["decoder"], cfg.gpt2))
