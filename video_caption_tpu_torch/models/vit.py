"""ViT-B/16 frame encoder (counterpart of video_caption_tpu/models/vit.py).

``[B,T,3,H,W] -> (B*T) frames -> ViT trunk -> pool (cls | gap) -> temporal
mean -> Linear(768->256)``, output in f32. Parameters keep the JAX package's
layout: blocks stacked along a leading depth axis and every linear weight
stored ``[in, out]``, so the weight bridge (models/convert.py) moves arrays
as they are. The attention of every block runs through the hand-written
kernel (ops/encoder_attention.py) on the GPU; with ``pool="gap"`` the whole
token stream reaches the fused pool kernel (ops/fused_pool.py). Both are
differentiable, so the encoder trains (models/align.py) with the kernels in
its forward; ``remat`` recomputes each block in the backward pass.

Under a mesh with a model axis (``ViTConfig.mesh``, parallel/mesh.py) a
block holds its rank's head group: the fused QKV product and fc1 are column
parallel (their input through ``copy_to_model``), the attention kernel runs
on the local heads, and proj and fc2 are row parallel (``row_linear``).

Rounding points follow the JAX package: LayerNorm in f32 then cast back, the
tanh-GELU in f32, attention probabilities cast to the compute dtype before
AV, the encoder output cast to f32. The LayerNorms and the f32 GELU run
through ops/norm_act.py, whose kernels do the f32 math in registers on bf16
tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from video_caption_tpu_torch.ops.encoder_attention import encoder_attention
from video_caption_tpu_torch.ops.norm_act import gelu, layer_norm
from video_caption_tpu_torch.parallel.collectives import (column_input, row_output,
                                                          tensor_parallel)
from video_caption_tpu_torch.ops.fused_pool import fused_pool_temporal

Params = Dict[str, Any]


@dataclass(frozen=True)
class ViTConfig:
    """Geometry of ``vit_base_patch16_224``."""

    image_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    pool: str = "cls"
    out_dim: int = 256
    dtype: torch.dtype = torch.bfloat16   # compute dtype
    gelu_approx: bool = True              # tanh-approx GELU (reference parity)
    gelu_f32: bool = True                 # GELU evaluated in f32
    remat: bool = False
    """Recompute each block in the backward pass (training only): the
    forward keeps only the blocks' inputs, and the backward reruns each
    block, the attention kernel included, before differentiating it."""
    mesh: Any = None
    """The rank's ``parallel.mesh.Mesh``: with a model axis above 1 the
    blocks hold the rank's head group (tensor parallel)."""

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def local_heads(self) -> int:
        """Heads of this rank: all of them, or its group under TP."""
        return self.num_heads // self.mesh.model if tensor_parallel(self.mesh) else self.num_heads


def trunc_normal(shape, std: float, gen: torch.Generator, device) -> torch.Tensor:
    """jax.nn.initializers.truncated_normal(std): a normal truncated at two
    standard deviations, rescaled so the result has standard deviation std."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t * (std / 0.87962566103423978)


def init_vit_params(gen: torch.Generator, cfg: ViTConfig, device) -> Params:
    """Random parameters with the shapes and stddevs of the JAX init."""
    h, d = cfg.embed_dim, cfg.depth
    patch_dim = cfg.patch_size * cfg.patch_size * cfg.in_chans
    mlp = cfg.mlp_ratio * h

    def tn(*shape):
        return trunc_normal(shape, 0.02, gen, device)

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    def ones(*shape):
        return torch.ones(shape, device=device)

    return {
        "patch_embed": {"w": tn(patch_dim, h), "b": zeros(h)},
        "cls_token": tn(1, 1, h),
        "pos_embed": tn(1, cfg.seq_len, h),
        "blocks": {
            "ln1_scale": ones(d, h), "ln1_bias": zeros(d, h),
            "qkv_w": tn(d, h, 3 * h), "qkv_b": zeros(d, 3 * h),
            "proj_w": tn(d, h, h), "proj_b": zeros(d, h),
            "ln2_scale": ones(d, h), "ln2_bias": zeros(d, h),
            "fc1_w": tn(d, h, mlp), "fc1_b": zeros(d, mlp),
            "fc2_w": tn(d, mlp, h), "fc2_b": zeros(d, h),
        },
        "norm_scale": ones(h),
        "norm_bias": zeros(h),
        "head": {"w": tn(h, cfg.out_dim), "b": zeros(cfg.out_dim)},
    }


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` for a weight stored [in, out], in x's dtype."""
    return F.linear(x, w.to(x.dtype).t(), b.to(x.dtype))


def row_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, mesh) -> torch.Tensor:
    """``linear`` of a row-parallel product: under TP this rank's partial
    product over its input columns, all-reduced over ``model``, then the
    replicated bias added once."""
    if not tensor_parallel(mesh):
        return linear(x, w, b)
    return row_output(F.linear(x, w.to(x.dtype).t()), b, mesh)


def _block(x: torch.Tensor, blk: Params, cfg: ViTConfig) -> torch.Tensor:
    mesh = cfg.mesh
    qkv = linear(column_input(layer_norm(x, blk["ln1_scale"], blk["ln1_bias"], 1e-6), mesh),
                 blk["qkv_w"], blk["qkv_b"])                      # [N,S,3H] (local heads)
    x = x + row_linear(encoder_attention(qkv, cfg.local_heads), blk["proj_w"], blk["proj_b"],
                       mesh)
    y = linear(column_input(layer_norm(x, blk["ln2_scale"], blk["ln2_bias"], 1e-6), mesh),
               blk["fc1_w"], blk["fc1_b"])
    approx = "tanh" if cfg.gelu_approx else "none"
    y = gelu(y, approx) if cfg.gelu_f32 else F.gelu(y, approximate=approx)
    return x + row_linear(y, blk["fc2_w"], blk["fc2_b"], mesh)


def vit_trunk(params: Params, images: torch.Tensor, cfg: ViTConfig,
              *, cls_only: bool = False) -> torch.Tensor:
    """[N,3,H,W] -> [N, seq_len, embed_dim] after the final norm, or only
    the CLS token [N, 1, embed_dim] with ``cls_only`` (sliced before the
    final per-token norm, so the values are the same)."""
    dt = cfg.dtype
    p = cfg.patch_size
    pe_w = params["patch_embed"]["w"].to(dt)                 # [(c ky kx), H]
    conv_w = pe_w.t().reshape(-1, cfg.in_chans, p, p)        # [H, c, ky, kx]
    x = F.conv2d(images.to(dt), conv_w, stride=p)            # [N,H,gh,gw]
    x = x.flatten(2).transpose(1, 2) + params["patch_embed"]["b"].to(dt)
    n = x.shape[0]
    cls = params["cls_token"].to(dt).expand(n, 1, cfg.embed_dim)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"].to(dt)
    blocks = params["blocks"]
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in range(cfg.depth):
        blk = {k: v[layer] for k, v in blocks.items()}
        if remat:
            x = checkpoint(_block, x, blk, cfg, use_reentrant=False, preserve_rng_state=False)
        else:
            x = _block(x, blk, cfg)
    if cls_only:
        x = x[:, :1, :]
    return layer_norm(x, params["norm_scale"], params["norm_bias"], 1e-6)


def pool_temporal(tokens: torch.Tensor, batch: int, frames: int, cfg: ViTConfig) -> torch.Tensor:
    """Spatial pool + temporal mean: [B*T, S, H] -> [B, H] with f32
    accumulation. The CLS-only trunk output (S == 1) takes its mean here;
    the full stream goes through the fused pool kernel."""
    if tokens.shape[1] == 1:
        if cfg.pool != "cls":
            raise ValueError(f"single-token trunk output is only valid for pool='cls' "
                             f"(got pool={cfg.pool!r}): gap pooling excludes token 0")
        per_frame = tokens[:, 0, :].float()
        return per_frame.reshape(batch, frames, -1).mean(dim=1).to(tokens.dtype)
    return fused_pool_temporal(tokens, batch, frames, cfg.pool)


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _channel_constants(values, video: torch.Tensor) -> torch.Tensor:
    """[3] f32 on video's device, filled there: a copy from host memory
    cannot be captured into a CUDA graph."""
    out = torch.empty(3, dtype=torch.float32, device=video.device)
    for c, v in enumerate(values):
        out[c].fill_(v)
    return out


def normalize_pixels(video: torch.Tensor) -> torch.Tensor:
    """uint8 [..,3,H,W] pixels -> ImageNet-normalized f32."""
    x = video.float() / 255.0
    shape = (1,) * (video.ndim - 3) + (3, 1, 1)
    mean = _channel_constants(IMAGENET_MEAN, video).reshape(shape)
    std = _channel_constants(IMAGENET_STD, video).reshape(shape)
    return (x - mean) / std


def vit_encode_frames(params: Params, frames: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """Per-frame half of ``vit_encode``: [C,3,H,W] (uint8 or float) ->
    per-frame pooled features [C, embed_dim] in the compute dtype: the CLS
    token, or with gap the f32 mean of the patch tokens. The JAX package
    takes that mean in plain XLA; here it is the fused pool kernel at one
    frame a video (its plain version on the CPU), differentiable, so the
    alignment model's ``temporal_mode="diff"`` runs the kernel forward and
    its backward."""
    if frames.dtype == torch.uint8:
        frames = normalize_pixels(frames)
    if cfg.pool == "cls":
        return vit_trunk(params, frames, cfg, cls_only=True)[:, 0, :]
    return fused_pool_temporal(vit_trunk(params, frames, cfg), frames.shape[0], 1, "gap")


def vit_finish(params: Params, per_frame: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """Temporal half of ``vit_encode``: [B,T,embed_dim] -> [B, out_dim] f32."""
    pooled = per_frame.float().mean(dim=1).to(per_frame.dtype)
    return linear(pooled, params["head"]["w"], params["head"]["b"]).float()


def vit_encode(params: Params, video: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """[B,T,3,H,W] (uint8 or float) -> [B, out_dim] f32."""
    if video.dtype == torch.uint8:
        video = normalize_pixels(video)
    b, t = video.shape[0], video.shape[1]
    tokens = vit_trunk(params, video.reshape(b * t, *video.shape[2:]), cfg,
                       cls_only=cfg.pool == "cls")
    pooled = pool_temporal(tokens, b, t, cfg)
    return linear(pooled, params["head"]["w"], params["head"]["b"]).float()
