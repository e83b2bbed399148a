"""Native (C++) host-side components with build-on-first-use + graceful
Python fallback — the same fallback contract as the reference's CuPy
operators (cupy_vit_pool.py:139-152)."""

from video_caption_tpu_torch.native.loader import load_frames_native, native_available  # noqa: F401
