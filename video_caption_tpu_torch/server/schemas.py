"""The request schema (counterpart of video_caption_tpu/server/schemas.py),
on a dataclass: the same fields and defaults as the JAX package's pydantic
``InferRequest``, and a payload that does not fit raises ValueError or
TypeError (the server answers 422). The response models serve the FastAPI
app, which is not ported; the stdlib server answers plain JSON.

Validation follows pydantic's lax mode on the types used here: a str field
takes a str; an int field an int, a float without a fraction or a string of
an int; a float field a number or a string of one; a bool field a bool, 0 or
1, or one of pydantic's words for true and false. Fields the schema does not
know are ignored, as pydantic ignores them.

The CUDA-era fields (``device``, ``vit_enable_*``, ``*cupy*``) are accepted
and ignored (inference_service logs them): the port runs its own kernels.
"""
from __future__ import annotations

import typing
from dataclasses import dataclass, fields
from typing import Optional

from video_caption_tpu_torch.config import serving_inference_config

# request defaults are the serving defaults: preset2 "detailed"
_DEFAULT = serving_inference_config()
_TRUE = frozenset(("1", "on", "t", "true", "y", "yes"))
_FALSE = frozenset(("0", "off", "f", "false", "n", "no"))


def _coerce(name: str, value, kind):
    """``value`` as ``kind`` (str, int, float or bool) or ValueError."""
    bad = ValueError(f"{name}: {value!r} is not a valid {kind.__name__}")
    if kind is str:
        if not isinstance(value, str):
            raise bad
        return value
    if kind is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, (int, float)) and value in (0, 1):
            return bool(value)
        if isinstance(value, str) and value.strip().lower() in _TRUE | _FALSE:
            return value.strip().lower() in _TRUE
        raise bad
    if isinstance(value, str):
        try:
            value = float(value) if kind is float else int(value.strip())
        except ValueError:
            raise bad from None
    if not isinstance(value, (int, float)):
        raise bad
    if kind is int:
        if isinstance(value, float) and not value.is_integer():
            raise bad
        return int(value)
    return float(value)


@dataclass(frozen=True)
class InferRequest:
    frames_dir: str
    ckpt: str = _DEFAULT.ckpt
    stage: str = _DEFAULT.stage
    vit_name: str = _DEFAULT.vit_name
    gpt2_name: str = _DEFAULT.gpt2_name
    prefix_len: int = _DEFAULT.prefix_len
    num_frames: int = _DEFAULT.num_frames
    image_size: int = _DEFAULT.image_size
    ln_scale: float = _DEFAULT.ln_scale
    in_weight: float = _DEFAULT.in_weight
    preset1: str = _DEFAULT.preset1
    preset2: str = _DEFAULT.preset2
    preset3: str = _DEFAULT.preset3
    prompt1: str = _DEFAULT.prompt1
    prompt2: str = _DEFAULT.prompt2
    prompt3: str = _DEFAULT.prompt3
    backend: str = _DEFAULT.backend
    compute_dtype: str = _DEFAULT.compile.dtype
    use_pallas_fused_pool: bool = _DEFAULT.compile.use_pallas_fused_pool
    use_pallas_prefix_projector: bool = _DEFAULT.compile.use_pallas_prefix_projector
    # CUDA-era compatibility fields: accepted, ignored
    vit_enable_fp16: Optional[bool] = None
    vit_enable_attention_fastpath: Optional[bool] = None
    vit_prefer_channels_last: Optional[bool] = None
    vit_enable_torch_compile: Optional[bool] = None
    vit_enable_mlp_bias_gelu_fusion: Optional[bool] = None
    vit_enable_residual_layernorm_fusion: Optional[bool] = None
    vit_enable_cupy_fused_pool: Optional[bool] = None
    vit_cupy_pool_force_fp16: Optional[bool] = None
    use_cupy_prefix_projector: Optional[bool] = None
    cupy_prefix_force_fp16: Optional[bool] = None
    vit_torch_compile_mode: Optional[str] = None
    device: Optional[str] = None

    def __post_init__(self):
        """Coerce every field to its annotated type (or raise ValueError)."""
        hints = typing.get_type_hints(type(self))
        for f in fields(self):
            kind, value = hints[f.name], getattr(self, f.name)
            if typing.get_origin(kind) is typing.Union:          # Optional[X]
                if value is None:
                    continue
                kind = next(a for a in typing.get_args(kind) if a is not type(None))
            object.__setattr__(self, f.name, _coerce(f.name, value, kind))

    @classmethod
    def from_payload(cls, body) -> "InferRequest":
        """A request from a decoded JSON object; unknown keys are ignored, a
        missing ``frames_dir`` raises TypeError."""
        if not isinstance(body, dict):
            raise TypeError(f"the request body must be a JSON object, not {type(body).__name__}")
        known = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in body.items() if k in known})
