"""Device ops of the port: the hand-written CUDA kernels of the caption path
(each beside its plain PyTorch version), the prefix norm and the temporal
mean pool (re-exported here, as in video_caption_tpu/ops/)."""

from video_caption_tpu_torch.ops.temporal_pool import temporal_mean_pool  # noqa: F401
