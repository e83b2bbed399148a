"""The captioner's forward pass in float32, plain PyTorch, no kernels, no
cache, no batching across requests.

- frames: ``frame_*.jpg`` sorted by name, every ``len // T``-th taken (the
  last repeated where there are fewer than T), decoded by PIL to RGB and
  resized bilinearly where they are not at the model's size;
- ViT-B/16 (timm ``vit_base_patch16_224``): pixels / 255 normalised by the
  ImageNet mean and std, 16x16 patches, CLS token and learned positions,
  pre-LN blocks (LayerNorm eps 1e-6, softmax attention, tanh-GELU MLP), the
  final LayerNorm of the CLS token, its mean over the frames, the head;
- the prefix: LayerNorm without affine terms (eps 1e-5), times ``ln_scale``
  and ``in_weight``, then the mapper to ``prefix_len`` GPT-2 embeddings;
- GPT-2 (huggingface.co/gpt2): ``[prefix, prompt, generated]`` with
  positions 0.., pre-LN blocks (eps 1e-5), causal attention, tanh-GELU MLP,
  final LayerNorm, logits over the tied ``wte`` (the unpadded vocabulary).

Weights are read in the parameter layout the benchmark made them in
(``caption_bench/weights.py``) and cast to float32. TF32 is off while the
reference runs.
"""
from __future__ import annotations

import contextlib
from pathlib import Path
from typing import List

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@contextlib.contextmanager
def exact_float32():
    """float32 products without TF32, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def frame_files(frames_dir: str, num_frames: int) -> List[Path]:
    files = sorted(p for p in Path(frames_dir).iterdir()
                   if p.name.startswith("frame_") and p.name.endswith(".jpg"))
    if not files:
        raise FileNotFoundError(f"no frame_*.jpg under {frames_dir}")
    picks = files[::max(len(files) // num_frames, 1)][:num_frames]
    return picks + [picks[-1]] * (num_frames - len(picks))


def decode_frames(frames_dir: str, num_frames: int, size: int) -> np.ndarray:
    """uint8 [T, 3, size, size]."""
    out = []
    for path in frame_files(frames_dir, num_frames):
        with Image.open(path) as img:
            rgb = img.convert("RGB")
            if rgb.size != (size, size):
                rgb = rgb.resize((size, size), Image.BILINEAR)
            out.append(np.asarray(rgb, np.uint8).transpose(2, 0, 1))
    return np.stack(out)


def _f(w: torch.Tensor) -> torch.Tensor:
    return w.float()


def _ln(x, scale, bias, eps):
    return F.layer_norm(x, (x.shape[-1],), _f(scale), _f(bias), eps)


def _attention(x: torch.Tensor, w_qkv, b_qkv, heads: int, causal: bool) -> torch.Tensor:
    """x [N,S,H] -> attention output [N,S,H] before the output projection."""
    n, s, h = x.shape
    qkv = (x @ _f(w_qkv) + _f(b_qkv)).reshape(n, s, 3, heads, h // heads)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))         # [N,nh,S,hd]
    logits = q @ k.transpose(-1, -2) * (h // heads) ** -0.5
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~mask, float("-inf"))
    out = torch.softmax(logits, dim=-1) @ v
    return out.transpose(1, 2).reshape(n, s, h)


def vit_embedding(w: dict, frames_u8: torch.Tensor, vit: dict) -> torch.Tensor:
    """uint8 [T,3,S,S] -> the video embedding [out_dim] (float32)."""
    x = frames_u8.float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device).reshape(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=x.device).reshape(1, 3, 1, 1)
    x = (x - mean) / std
    p, h, c = vit["patch_size"], vit["embed_dim"], vit["in_chans"]
    conv_w = _f(w["patch_embed"]["w"]).t().reshape(h, c, p, p)
    tokens = F.conv2d(x, conv_w, stride=p).flatten(2).transpose(1, 2) + _f(w["patch_embed"]["b"])
    t = tokens.shape[0]
    cls = _f(w["cls_token"]).expand(t, 1, h)
    x = torch.cat([cls, tokens], dim=1) + _f(w["pos_embed"])
    blocks = w["blocks"]
    for i in range(vit["depth"]):
        a = _attention(_ln(x, blocks["ln1_scale"][i], blocks["ln1_bias"][i], 1e-6),
                       blocks["qkv_w"][i], blocks["qkv_b"][i], vit["num_heads"], causal=False)
        x = x + a @ _f(blocks["proj_w"][i]) + _f(blocks["proj_b"][i])
        m = _ln(x, blocks["ln2_scale"][i], blocks["ln2_bias"][i], 1e-6)
        m = F.gelu(m @ _f(blocks["fc1_w"][i]) + _f(blocks["fc1_b"][i]), approximate="tanh")
        x = x + m @ _f(blocks["fc2_w"][i]) + _f(blocks["fc2_b"][i])
    cls_out = _ln(x[:, 0], w["norm_scale"], w["norm_bias"], 1e-6)         # [T, H]
    return cls_out.mean(dim=0) @ _f(w["head"]["w"]) + _f(w["head"]["b"])


def prefix_embeddings(w: dict, emb: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The video embedding [video_dim] -> prefix [prefix_len, n_embd]."""
    y = emb
    if cfg["ln_scale"] > 0:
        y = F.layer_norm(y, (y.shape[-1],), eps=1e-5) * cfg["ln_scale"]
    if cfg["in_weight"] > 0:
        y = y * cfg["in_weight"]
    out = y @ _f(w["mapper"]["w"]) + _f(w["mapper"]["b"])
    return out.reshape(cfg["prefix_len"], cfg["gpt2"]["n_embd"])


def gpt2_logits(w: dict, embeds: torch.Tensor, gpt2: dict) -> torch.Tensor:
    """Input embeddings [S, H] (positions 0..S-1) -> logits [S, vocab]."""
    s = embeds.shape[0]
    x = (embeds + _f(w["wpe"][:s]))[None]
    blocks = w["blocks"]
    for i in range(gpt2["n_layer"]):
        a = _attention(_ln(x, blocks["ln1_scale"][i], blocks["ln1_bias"][i], 1e-5),
                       blocks["attn_w"][i], blocks["attn_b"][i], gpt2["n_head"], causal=True)
        x = x + a @ _f(blocks["proj_w"][i]) + _f(blocks["proj_b"][i])
        m = _ln(x, blocks["ln2_scale"][i], blocks["ln2_bias"][i], 1e-5)
        m = F.gelu(m @ _f(blocks["fc_w"][i]) + _f(blocks["fc_b"][i]), approximate="tanh")
        x = x + m @ _f(blocks["out_w"][i]) + _f(blocks["out_b"][i])
    x = _ln(x[0], w["lnf_scale"], w["lnf_bias"], 1e-5)
    return x @ _f(w["wte"]).t()


def prompt_ids(prompt: str, eos_id: int) -> List[int]:
    """The byte-level prompt ids the program serves with no GPT-2 vocabulary
    files: the UTF-8 bytes, or the EOS id as BOS for an empty prompt."""
    return list(prompt.encode("utf-8")) if prompt else [eos_id]


def row_logits(w: dict, prefix: torch.Tensor, prompt: List[int], served: List[int],
               gpt2: dict) -> torch.Tensor:
    """Logits [len(served), vocab] that predict each served token from the
    prefix, the prompt and the served tokens before it."""
    ids = torch.tensor(prompt + served[:-1], dtype=torch.long, device=prefix.device)
    embeds = torch.cat([prefix, _f(w["decoder"]["wte"][ids])])
    logits = gpt2_logits(w["decoder"], embeds, gpt2)
    start = prefix.shape[0] + len(prompt) - 1
    return logits[start:start + len(served)]
