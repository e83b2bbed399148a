"""Runtime utilities (counterpart of video_caption_tpu/utils/; canonical
homes: env.py, memory.py, config.py — re-exported here to match the
models/ops/utils package layout). The JAX package's
``enable_compilation_cache`` (XLA's persistent cache of compiled programs)
has no counterpart: the port's nvcc outputs in ``build/cuda_kernels/``
already persist across processes."""

from video_caption_tpu_torch.config import (  # noqa: F401
    CompileConfig,
    InferenceConfig,
    MemoryConfig,
    MeshConfig,
    default_inference_config,
)
from video_caption_tpu_torch.env import (  # noqa: F401
    RuntimeNotReady,
    assert_core_runtime_ready,
    assert_frontend_runtime_ready,
    assert_server_runtime_ready,
    device_summary,
)
from video_caption_tpu_torch.memory import DeviceMemorySnapshot, MemoryManager, is_oom_error  # noqa: F401
