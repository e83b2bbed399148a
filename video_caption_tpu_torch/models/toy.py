"""Tiny stand-in models for pipeline smoke tests (counterpart of
video_caption_tpu/models/toy.py):

- ``SimpleVideoCaptioner``: mean-pool video -> Linear -> per-position vocab
  logits,
- ``TinyCaptioner``: video-conditioned GRU language model,
- ``SimpleAlignModel``: mean-pooled video and text through small MLPs,
  cosine-embedding alignment (``cli/train_full.py --model simple``).

They exercise data -> loss -> optimizer cheaply, before the real model.
Parameters are drawn from a ``torch.Generator`` with the JAX init's shapes
and stddevs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

Params = Dict[str, Any]


@dataclass(frozen=True)
class ToyConfig:
    vocab_size: int = 128
    hidden: int = 64
    max_len: int = 16


def _normal(gen, device, *shape):
    return torch.randn(shape, generator=gen, device=device) * 0.02


def _dense(gen, device, d_in, d_out):
    return {"w": _normal(gen, device, d_in, d_out), "b": torch.zeros(d_out, device=device)}


def _linear(x, p):
    return x @ p["w"] + p["b"]


# --- SimpleVideoCaptioner ----------------------------------------------------

def init_simple_vc(gen: torch.Generator, cfg: ToyConfig, device,
                   video_feat_dim: int = 3 * 32 * 32) -> Params:
    return {"enc": _dense(gen, device, video_feat_dim, cfg.hidden),
            "head": _dense(gen, device, cfg.hidden, cfg.vocab_size * cfg.max_len)}


def simple_vc_logits(params: Params, video: torch.Tensor, cfg: ToyConfig) -> torch.Tensor:
    """[B,T,3,H,W] -> [B, max_len, vocab] logits."""
    b = video.shape[0]
    feat = video.reshape(b, video.shape[1], -1).mean(dim=1)
    h = torch.relu(_linear(feat, params["enc"]))
    return _linear(h, params["head"]).reshape(b, cfg.max_len, cfg.vocab_size)


# --- TinyCaptioner (GRU LM) --------------------------------------------------

def init_tiny_captioner(gen: torch.Generator, cfg: ToyConfig, device,
                        video_feat_dim: int = 3 * 32 * 32) -> Params:
    h = cfg.hidden
    return {
        "video_proj": _dense(gen, device, video_feat_dim, h),
        "embed": _normal(gen, device, cfg.vocab_size, h),
        "gru_rz": _dense(gen, device, 2 * h, 2 * h),   # reset/update gates
        "gru_n": _dense(gen, device, 2 * h, h),        # candidate state
        "head": _dense(gen, device, h, cfg.vocab_size),
    }


def tiny_captioner_logits(params: Params, video: torch.Tensor, ids: torch.Tensor,
                          cfg: ToyConfig) -> torch.Tensor:
    """Video-conditioned GRU LM: [B,T,3,H,W], [B,L] -> [B,L,vocab]."""
    b = ids.shape[0]
    feat = video.reshape(b, video.shape[1], -1).mean(dim=1)
    h = torch.tanh(_linear(feat, params["video_proj"]))
    x = params["embed"][ids.long()]                      # [B,L,H]
    states = []
    for t in range(ids.shape[1]):
        xt = x[:, t]
        r, z = torch.sigmoid(_linear(torch.cat([xt, h], dim=-1), params["gru_rz"])).chunk(2, -1)
        n = torch.tanh(_linear(torch.cat([xt, r * h], dim=-1), params["gru_n"]))
        h = (1 - z) * n + z * h
        states.append(h)
    return _linear(torch.stack(states, dim=1), params["head"])


# --- SimpleAlignModel --------------------------------------------------------

def init_simple_align(gen: torch.Generator, cfg: ToyConfig, device, d: int = 256) -> Params:
    """Video mean over (T,H,W) -> [B,3] -> Linear(3,d); text embedding
    masked-mean -> Linear(d,d)."""
    return {"vid_proj": _dense(gen, device, 3, d),
            "txt_emb": _normal(gen, device, cfg.vocab_size, d),
            "txt_proj": _dense(gen, device, d, d)}


def _l2(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)


def simple_align_embeddings(params: Params, video: torch.Tensor, ids: torch.Tensor,
                            mask: torch.Tensor):
    v = _linear(video.mean(dim=(1, 3, 4)), params["vid_proj"])          # [B,3] -> [B,d]
    maskf = mask.float()
    tfeat = params["txt_emb"][ids.long()] * maskf[..., None]
    t = tfeat.sum(dim=1) / maskf.sum(dim=1, keepdim=True).clamp(min=1.0)
    return _l2(v), _l2(_linear(t, params["txt_proj"]))


def simple_align_loss(params: Params, video: torch.Tensor, ids: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    v, t = simple_align_embeddings(params, video, ids, mask)
    return (1.0 - (v * t).sum(dim=-1)).mean()
