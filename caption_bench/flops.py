"""Operations and bytes: the model's FLOPs per video, each kernel's bound
by its op's contract, and the card's published peaks.

Model FLOPs count the multiply-adds (2 FLOPs each) the algorithm needs for
one video: the ViT over every frame (patch embedding, QKV, attention,
projection, MLP), the head, the mapper, and for every decode row the
prefill of its prompt (the LM head at its last position only) and each of
its ``max_new_tokens - 1`` steps (the blocks, attention over the tokens so
far, the LM head over the vocabulary). A beam group runs ``num_beams`` rows
an instance; rows a program adds for its own layout (dead rows of a
unified decode, padding videos of a bucket) are not counted. The formulas
are those of ``video_caption_tpu_torch/bench/roofline.py`` (copied, the
prefill's LM head cut to the one position a decode reads).

A kernel's bound is the larger of its FLOPs over the bf16 peak and its
bytes (every input byte the call needs read once, every output byte
written once) over the HBM peak, counted from the arguments of one call of
its op (``torch.ops.vct.*``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12},
}
"""Published dense peaks (NVIDIA's data sheet, SXM part, 700 W), by the
name ``torch.cuda.get_device_name`` gives."""


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    return PEAKS.get(device_name)


def encode_flops(cfg: dict) -> float:
    """One video's visual branch: T frames through the ViT, the head on the
    frames' mean, the mapper."""
    v = cfg["vit"]
    h, depth = v["embed_dim"], v["depth"]
    patches = (v["image_size"] // v["patch_size"]) ** 2
    s = patches + 1
    patch_dim = v["patch_size"] ** 2 * v["in_chans"]
    per_frame = 2 * patches * patch_dim * h
    mlp = v["mlp_ratio"] * h
    per_frame += depth * (2 * s * h * 3 * h + 2 * s * h * h + 2 * 2 * s * h * mlp + 4 * s * s * h)
    head = 2 * h * v["out_dim"]
    mapper = 2 * cfg["video_dim"] * cfg["prefix_len"] * cfg["gpt2"]["n_embd"]
    return cfg["num_frames"] * per_frame + head + mapper


def _gpt2_token_flops(g: dict, context: int) -> float:
    """One token through the blocks, attending over ``context`` tokens."""
    h = g["n_embd"]
    return g["n_layer"] * (24 * h * h + 4 * h * context)


def decode_row_flops(cfg: dict, prompt_len: int, steps: int) -> Tuple[float, float]:
    """(prefill of one instance, every step of one row) of a decode whose
    prompt is ``prompt_len`` tokens and which serves ``steps`` tokens."""
    g = cfg["gpt2"]
    h, vocab = g["n_embd"], g["vocab_size"]
    s0 = cfg["prefix_len"] + prompt_len
    head = 2 * h * vocab
    prefill = g["n_layer"] * (24 * h * h * s0 + 2 * s0 * s0 * h) + head
    per_row = sum(_gpt2_token_flops(g, s0 + t) + head for t in range(1, steps))
    return prefill, per_row


def video_flops(cfg: dict, prompt_lens: Sequence[int], policies: Sequence) -> float:
    """Model FLOPs of one video: encode, then each preset's prompt as an
    instance of its policy (``reference.judge.Policy``)."""
    total = encode_flops(cfg)
    for n, pol in zip(prompt_lens, policies):
        prefill, per_row = decode_row_flops(cfg, n, pol.max_new_tokens)
        total += prefill + pol.num_beams * per_row
    return total


def _bytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def lm_head_cost(args, out) -> Tuple[float, float]:
    """``vct::lm_head_stats(x [R,H], wte_t [H,Vp], vocab)``: the logits of
    the real vocabulary, the weight's real columns read once, the op's one
    float32 output written once."""
    x, wte_t, vocab = args[0], args[1], int(args[2])
    r, h = x.shape
    flops = 2.0 * r * h * vocab
    read = _bytes(x) + h * vocab * wte_t.element_size()
    return flops, read + _bytes(out)


def beam_attention_cost(args, kwargs, out) -> Tuple[float, float]:
    """``vct::beam_attention(q [R,H], gkv [N,2,R,H], pk [B,S0,H], pv,
    prefill_valid [B,S0], anc [R,N], t, num_beams, heads, k_new?, v_new?)``:
    each row attends to its video's valid prefill columns and to the t + 1
    generated columns its ancestry names (t, and its own new K/V, in the
    deferred mode); K/V are read once, the shared prefill once a video."""
    q, gkv, pk, pv, valid, anc = args[:6]
    t = int(args[6])
    k_new = args[9] if len(args) > 9 else kwargs.get("k_new")
    r, h = q.shape
    e = q.element_size()
    cols = t if k_new is not None else t + 1
    valid_cols = float(valid.sum())
    b = valid.shape[0]
    flops = 4.0 * h * (r / b * valid_cols + r * (cols + (1 if k_new is not None else 0)))
    gen = r * cols * 2 * h * gkv.element_size()
    new = 2 * r * h * e if k_new is not None else 0
    prefill = valid_cols * 2 * h * pk.element_size()
    small = _bytes(valid) + r * (t + 1) * anc.element_size()
    return flops, _bytes(q) + gen + new + prefill + small + _bytes(out)


COSTS = {
    "lm_head_stats": lambda args, kwargs, out: lm_head_cost(args, out),
    "beam_attention": beam_attention_cost,
}
"""Op name (``torch.ops.vct.<name>``) -> cost of one call."""


def bound_seconds(flops: float, nbytes: float, pk: Dict[str, float]) -> float:
    return max(flops / pk["bf16_flops"], nbytes / pk["hbm_bytes"])
