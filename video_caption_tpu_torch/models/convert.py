"""The weight bridge (counterpart of video_caption_tpu/models/convert.py).

The port keeps the JAX package's parameter tree: the same nesting, blocks
stacked along a leading layer axis, every linear weight stored ``[in, out]``.
So moving weights between the packages moves arrays as they are:

- ``params_from_jax_numpy`` takes the JAX tree with its leaves turned into
  numpy arrays (``jax.tree.map(np.asarray, params)``);
- ``params_to_numpy`` gives the port's tree back as numpy;
- ``load_reference_state`` reads the reference torch key space (timm ViT,
  HF GPT-2 Conv1D, tied LM head) that the JAX package's
  ``export_torch_state`` writes, so one ``{"model_state": ...}`` ``.pt`` file
  loads into both packages;
- ``export_torch_state`` writes the port's tree into that key space, and
  ``save_torch_checkpoint`` the reference-format ``.pt`` around it (the
  trainers' checkpoints, training/checkpoint.py, and
  tools/export_checkpoint.py); ``load_torch_checkpoint`` reads such a file
  back as its state dict;
- ``align_params_from_jax_numpy`` takes the JAX alignment model's tree
  (models/align.py).
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, Mapping

import numpy as np
import torch

from video_caption_tpu_torch.models.caption_model import CaptionModelConfig
from video_caption_tpu_torch.models.quantize import is_scale

log = logging.getLogger(__name__)

Params = Dict[str, Any]


def params_from_jax_numpy(tree: Mapping, cfg: CaptionModelConfig, device,
                          dtype: torch.dtype = None) -> Params:
    """JAX parameter tree (numpy leaves) -> the port's tree of tensors on
    ``device``; floating leaves are cast to ``dtype`` when given. A decoder
    quantized by the JAX package (``quantize_gpt2_blocks``) comes across as
    it is: ``*_q`` int8, ``*_s`` f32 (never cast), not quantized again."""
    del cfg  # the layouts are shared; cfg documents which model the tree is

    def conv(x, scale=False):
        if isinstance(x, Mapping):
            return {k: conv(v, is_scale(x, k)) for k, v in x.items()}
        t = torch.from_numpy(np.array(x, copy=True))
        if dtype is not None and t.is_floating_point() and not scale:
            t = t.to(dtype)
        return t.to(device)

    return conv(tree)


def align_params_from_jax_numpy(tree: Mapping, device, dtype: torch.dtype = None) -> Params:
    """JAX alignment-model tree (``init_align_params``, numpy leaves) -> the
    port's tree of tensors: the layouts are shared, so arrays move as they
    are."""
    return params_from_jax_numpy(tree, None, device, dtype)


def params_to_numpy(params: Mapping) -> Dict[str, Any]:
    """The port's tree -> the same tree with numpy leaves (float32 for
    floating leaves)."""
    out: Dict[str, Any] = {}
    for k, v in params.items():
        if isinstance(v, Mapping):
            out[k] = params_to_numpy(v)
        else:
            t = v.detach().cpu()
            out[k] = (t.float() if t.is_floating_point() else t).numpy()
    return out


def _t(x: Any) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    return t.detach().cpu().float()


def _linear(state: Mapping, prefix: str) -> Params:
    """torch nn.Linear [out, in] -> [in, out]."""
    return {"w": _t(state[f"{prefix}.weight"]).t().contiguous(),
            "b": _t(state[f"{prefix}.bias"])}


_VIT_BLOCK_KEYS = (
    ("ln1_scale", "norm1.weight", False), ("ln1_bias", "norm1.bias", False),
    ("qkv_w", "attn.qkv.weight", True), ("qkv_b", "attn.qkv.bias", False),
    ("proj_w", "attn.proj.weight", True), ("proj_b", "attn.proj.bias", False),
    ("ln2_scale", "norm2.weight", False), ("ln2_bias", "norm2.bias", False),
    ("fc1_w", "mlp.fc1.weight", True), ("fc1_b", "mlp.fc1.bias", False),
    ("fc2_w", "mlp.fc2.weight", True), ("fc2_b", "mlp.fc2.bias", False),
)
_GPT2_BLOCK_KEYS = (
    ("ln1_scale", "ln_1.weight"), ("ln1_bias", "ln_1.bias"),
    ("attn_w", "attn.c_attn.weight"), ("attn_b", "attn.c_attn.bias"),
    ("proj_w", "attn.c_proj.weight"), ("proj_b", "attn.c_proj.bias"),
    ("ln2_scale", "ln_2.weight"), ("ln2_bias", "ln_2.bias"),
    ("fc_w", "mlp.c_fc.weight"), ("fc_b", "mlp.c_fc.bias"),
    ("out_w", "mlp.c_proj.weight"), ("out_b", "mlp.c_proj.bias"),
)


def _timm_vit(state: Mapping, prefix: str, depth: int) -> Params:
    g = lambda k: _t(state[prefix + k])  # noqa: E731
    conv_w = g("patch_embed.proj.weight")                 # [out, in, kh, kw]
    params: Params = {
        "patch_embed": {"w": conv_w.reshape(conv_w.shape[0], -1).t().contiguous(),
                        "b": g("patch_embed.proj.bias")},
        "cls_token": g("cls_token"),
        "pos_embed": g("pos_embed"),
        "norm_scale": g("norm.weight"),
        "norm_bias": g("norm.bias"),
    }
    params["blocks"] = {
        ours: torch.stack([g(f"blocks.{i}.{theirs}").t() if transpose
                           else g(f"blocks.{i}.{theirs}") for i in range(depth)])
        for ours, theirs, transpose in _VIT_BLOCK_KEYS
    }
    return params


def _hf_gpt2(state: Mapping, prefix: str, n_layer: int) -> Params:
    """HF GPT2LMHeadModel keys; Conv1D weights are already [in, out]."""
    g = lambda k: _t(state[prefix + k])  # noqa: E731
    params: Params = {
        "wte": g("transformer.wte.weight"),
        "wpe": g("transformer.wpe.weight"),
        "lnf_scale": g("transformer.ln_f.weight"),
        "lnf_bias": g("transformer.ln_f.bias"),
    }
    params["blocks"] = {
        ours: torch.stack([g(f"transformer.h.{i}.{theirs}") for i in range(n_layer)])
        for ours, theirs in _GPT2_BLOCK_KEYS
    }
    return params


def export_torch_state(params: Mapping, cfg: CaptionModelConfig) -> Dict[str, torch.Tensor]:
    """The port's caption-model tree -> the reference state-dict key space
    (timm ViT, HF GPT-2, mapper) as f32 CPU tensors: the inverse of
    ``load_reference_state`` and the counterpart of the JAX package's
    ``export_torch_state``, key for key. A Linear ``proj`` adapter has no
    reference key and is left out with a warning."""
    out: Dict[str, torch.Tensor] = {}
    enc = params.get("encoder")
    if enc:
        p = cfg.vit.patch_size
        pre = "encoder.backbone."
        out[pre + "patch_embed.proj.weight"] = \
            _t(enc["patch_embed"]["w"]).t().reshape(-1, cfg.vit.in_chans, p, p).contiguous()
        out[pre + "patch_embed.proj.bias"] = _t(enc["patch_embed"]["b"])
        out[pre + "cls_token"] = _t(enc["cls_token"])
        out[pre + "pos_embed"] = _t(enc["pos_embed"])
        out[pre + "norm.weight"] = _t(enc["norm_scale"])
        out[pre + "norm.bias"] = _t(enc["norm_bias"])
        blocks = {k: _t(v) for k, v in enc["blocks"].items()}
        for i in range(cfg.vit.depth):
            for ours, theirs, transpose in _VIT_BLOCK_KEYS:
                v = blocks[ours][i]
                v = v.t().contiguous() if transpose else v.contiguous()
                out[f"{pre}blocks.{i}.{theirs}"] = v
                # the reference encoder aliases its backbone's blocks, so its
                # state dict holds each block tensor under both prefixes
                out[f"encoder.blocks.{i}.{theirs}"] = v
        if "head" in enc:
            out["encoder.proj.weight"] = _t(enc["head"]["w"]).t().contiguous()
            out["encoder.proj.bias"] = _t(enc["head"]["b"])
    if "mapper" in params:
        out["decoder.mapper.0.weight"] = _t(params["mapper"]["w"]).t().contiguous()
        out["decoder.mapper.0.bias"] = _t(params["mapper"]["b"])
    dec = params.get("decoder")
    if dec:
        pre = "decoder.model."
        out[pre + "transformer.wte.weight"] = _t(dec["wte"])
        out[pre + "transformer.wpe.weight"] = _t(dec["wpe"])
        out[pre + "transformer.ln_f.weight"] = _t(dec["lnf_scale"])
        out[pre + "transformer.ln_f.bias"] = _t(dec["lnf_bias"])
        out[pre + "lm_head.weight"] = out[pre + "transformer.wte.weight"]   # tied
        blocks = {k: _t(v) for k, v in dec["blocks"].items()}
        for i in range(cfg.gpt2.n_layer):
            for ours, theirs in _GPT2_BLOCK_KEYS:
                # HF Conv1D stores [in, out], the port's layout
                out[f"{pre}transformer.h.{i}.{theirs}"] = blocks[ours][i].contiguous()
    if "proj_mlp" in params:
        m = params["proj_mlp"]
        for key, layer in (("proj.0", m["fc1"]), ("proj.2", m["fc2"])):
            out[f"{key}.weight"] = _t(layer["w"]).t().contiguous()
            out[f"{key}.bias"] = _t(layer["b"])
    if "proj" in params:
        log.warning("params carry a Linear adapter ('proj') with no reference key space; "
                    "not exported")
    return out


def _layers(state: Mapping, prefix: str) -> int:
    """Blocks ``<prefix><i>.`` the state holds (0 where it holds none)."""
    idx = {int(k[len(prefix):].split(".", 1)[0]) for k in state if k.startswith(prefix)}
    return max(idx) + 1 if idx else 0


def _unwrap(state_dict: Mapping) -> Dict[str, Any]:
    """The state dict of a ``{"model_state": ...}`` payload (or the state
    itself), legacy ``vit.*`` keys read as ``encoder.backbone.*``."""
    if "model_state" in state_dict:
        state_dict = state_dict["model_state"]
    return {("encoder.backbone." + k[4:] if k.startswith("vit.") else k): v
            for k, v in state_dict.items()}


def load_reference_state(state_dict: Mapping, cfg: CaptionModelConfig = None) -> Params:
    """Reference state dict (optionally wrapped as ``{"model_state": ...}``)
    -> the families of the port's tree it holds, as f32 CPU tensors. Legacy
    ``vit.*`` keys are read as ``encoder.backbone.*``. The LM head is tied to
    ``wte``. Families the state lacks are left out (the caller keeps their
    random init) with a warning. The stacks hold ``cfg``'s depths, or with
    no ``cfg`` every block the state holds."""
    state = _unwrap(state_dict)
    depth = cfg.vit.depth if cfg else _layers(state, "encoder.backbone.blocks.")
    n_layer = cfg.gpt2.n_layer if cfg else _layers(state, "decoder.model.transformer.h.")
    params: Params = {}
    if any(k.startswith("encoder.backbone.") for k in state):
        params["encoder"] = _timm_vit(state, "encoder.backbone.", depth)
        if "encoder.proj.weight" in state:
            params["encoder"]["head"] = _linear(state, "encoder.proj")
    else:
        log.warning("state has no encoder.backbone.* keys; encoder not loaded")
    if "decoder.mapper.0.weight" in state:
        params["mapper"] = _linear(state, "decoder.mapper.0")
    elif "decoder.mapper.weight" in state:
        params["mapper"] = _linear(state, "decoder.mapper")
    else:
        log.warning("state has no decoder.mapper.* keys; mapper not loaded")
    if any(k.startswith("decoder.model.") for k in state):
        params["decoder"] = _hf_gpt2(state, "decoder.model.", n_layer)
    else:
        log.warning("state has no decoder.model.* keys; decoder not loaded")
    if "proj.0.weight" in state:
        params["proj_mlp"] = {"fc1": _linear(state, "proj.0"), "fc2": _linear(state, "proj.2")}
    return params


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference-format ``.pt`` (a state dict, or ``{"model_state": ...}``)
    -> its state dict, legacy ``vit.*`` keys read as ``encoder.backbone.*``.
    Only the safe load (``weights_only=True``): the port unpickles no code."""
    return _unwrap(torch.load(path, map_location="cpu", weights_only=True))


def save_payload(payload: Mapping, path) -> None:
    """``torch.save`` to ``<path>.tmp``, then renamed over ``path``: a reader
    never sees half a file."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(dict(payload), tmp)
    tmp.replace(path)


def save_torch_checkpoint(path, params: Mapping, cfg: CaptionModelConfig, step: int = 0,
                          epoch: int = 0, best_val: float = float("inf"), args=None,
                          opt_state: Any = None) -> None:
    """Write a reference-format checkpoint ``{"model_state", "step", "epoch",
    "best_val", "args"}`` (the reference's train_caption_mapper payload),
    loadable by the reference's model loader and by both packages'
    ``load_params``; ``opt_state`` (CPU tensors) is kept beside it where
    given."""
    payload = {"model_state": export_torch_state(params, cfg), "step": step, "epoch": epoch,
               "best_val": best_val, "args": args or {}}
    if opt_state is not None:
        payload["opt_state"] = opt_state
    save_payload(payload, path)
    log.info("saved reference-format checkpoint to %s (%d tensors)", path,
             len(payload["model_state"]))


def merge_params(init: Params, loaded: Params) -> Params:
    """Overlay loaded families onto an initialized tree (strict=False
    semantics: what the checkpoint lacks keeps its init); loaded leaves move
    to the device and dtype of the leaf they replace, or of the tree."""
    device = next(_leaves(init)).device

    def overlay(dst, src):
        out = dict(dst)
        for k, v in src.items():
            if isinstance(v, Mapping):
                out[k] = overlay(dst.get(k, {}), v)
            else:
                like = dst.get(k)
                out[k] = v.to(device=device, dtype=like.dtype if like is not None else v.dtype)
        return out

    return overlay(init, loaded)


def _leaves(tree: Mapping):
    for v in tree.values():
        if isinstance(v, Mapping):
            yield from _leaves(v)
        else:
            yield v

