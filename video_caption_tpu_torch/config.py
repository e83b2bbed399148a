"""The port's configuration: the JAX package's JAX-free config module, imported
as it is (``InferenceConfig`` is the port's config too). The port honours
``ckpt``, ``num_frames``, ``image_size``, ``prefix_len``, ``ln_scale``,
``in_weight``, ``preset1..3``, ``prompt1..3`` and ``compile.dtype``; it raises
for ``compile.quantize_decoder_int8`` and ``mesh.num_devices > 1``, and
ignores the schedule-only knobs of the TPU build, whose tokens are identical
either way."""
from video_caption_tpu.config import (  # noqa: F401
    InferenceConfig, default_inference_config, serving_inference_config,
)
