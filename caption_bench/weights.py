"""Seeded random weights in the port's parameter layout, made on the device.

Every weight matrix is drawn from N(0, std^2) (``std`` from the
configuration file) in ONE ``torch.randn`` call on the device, in the dtype
the model is served in, and cut into views; LayerNorm scales are ones and
biases zeros. Each leaf starts at a 128-byte boundary of the buffer, as a
kernel that reads a weight by pointer expects. The program and the
reference are handed the same tensors.

The layout (the JAX package's, which the port keeps): blocks stacked along
a leading depth axis, every linear weight stored ``[in, out]``, the patch
embedding ``[(c, ky, kx), H]``, a fused QKV ``[H, 3H]`` whose output splits
as ``(3, heads, head_dim)``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

_ALIGN = 128

Spec = Dict[str, object]


def _vit_spec(v: dict) -> Spec:
    h, d = v["embed_dim"], v["depth"]
    mlp = v["mlp_ratio"] * h
    patch_dim = v["patch_size"] ** 2 * v["in_chans"]
    seq = (v["image_size"] // v["patch_size"]) ** 2 + 1
    return {
        "patch_embed": {"w": ("normal", (patch_dim, h)), "b": ("zeros", (h,))},
        "cls_token": ("normal", (1, 1, h)),
        "pos_embed": ("normal", (1, seq, h)),
        "blocks": {
            "ln1_scale": ("ones", (d, h)), "ln1_bias": ("zeros", (d, h)),
            "qkv_w": ("normal", (d, h, 3 * h)), "qkv_b": ("zeros", (d, 3 * h)),
            "proj_w": ("normal", (d, h, h)), "proj_b": ("zeros", (d, h)),
            "ln2_scale": ("ones", (d, h)), "ln2_bias": ("zeros", (d, h)),
            "fc1_w": ("normal", (d, h, mlp)), "fc1_b": ("zeros", (d, mlp)),
            "fc2_w": ("normal", (d, mlp, h)), "fc2_b": ("zeros", (d, h)),
        },
        "norm_scale": ("ones", (h,)),
        "norm_bias": ("zeros", (h,)),
        "head": {"w": ("normal", (h, v["out_dim"])), "b": ("zeros", (v["out_dim"],))},
    }


def _gpt2_spec(g: dict) -> Spec:
    h, d = g["n_embd"], g["n_layer"]
    mlp = 4 * h
    return {
        "wte": ("normal", (g["vocab_size"], h)),
        "wpe": ("normal", (g["n_positions"], h)),
        "blocks": {
            "ln1_scale": ("ones", (d, h)), "ln1_bias": ("zeros", (d, h)),
            "attn_w": ("normal", (d, h, 3 * h)), "attn_b": ("zeros", (d, 3 * h)),
            "proj_w": ("normal", (d, h, h)), "proj_b": ("zeros", (d, h)),
            "ln2_scale": ("ones", (d, h)), "ln2_bias": ("zeros", (d, h)),
            "fc_w": ("normal", (d, h, mlp)), "fc_b": ("zeros", (d, mlp)),
            "out_w": ("normal", (d, mlp, h)), "out_b": ("zeros", (d, h)),
        },
        "lnf_scale": ("ones", (h,)),
        "lnf_bias": ("zeros", (h,)),
    }


def param_spec(cfg: dict) -> Spec:
    """{leaf path: (init, shape)} as a tree, from a configuration file."""
    if cfg["vit"]["out_dim"] != cfg["video_dim"]:
        raise ValueError("the benchmark's configurations project nothing: vit.out_dim must "
                         "equal video_dim")
    p, h = cfg["prefix_len"], cfg["gpt2"]["n_embd"]
    return {
        "encoder": _vit_spec(cfg["vit"]),
        "mapper": {"w": ("normal", (cfg["video_dim"], p * h)), "b": ("zeros", (p * h,))},
        "decoder": _gpt2_spec(cfg["gpt2"]),
    }


def _leaves(spec: Spec, path: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], str, tuple]]:
    out = []
    for key, value in spec.items():
        if isinstance(value, dict):
            out += _leaves(value, path + (key,))
        else:
            out.append((path + (key,), value[0], value[1]))
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def make_params(cfg: dict, seed: int, device, dtype: torch.dtype) -> dict:
    """The parameter tree of ``cfg``: normal leaves from one draw of a
    generator on ``device`` seeded with ``seed``, scaled by
    ``cfg["weights"]["std"]``; ones and zeros filled in place."""
    leaves = _leaves(param_spec(cfg))
    align = _ALIGN // torch.tensor([], dtype=dtype).element_size()
    offsets, total = [], 0
    for _, init, shape in leaves:
        offsets.append(total)
        total += -(-_numel(shape) // align) * align
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.randn(total, generator=gen, device=device, dtype=dtype)
    buf.mul_(cfg["weights"]["std"])
    tree: dict = {}
    for (path, init, shape), off in zip(leaves, offsets):
        leaf = buf[off:off + _numel(shape)].view(shape)
        if init == "ones":
            leaf.fill_(1)
        elif init == "zeros":
            leaf.zero_()
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree

