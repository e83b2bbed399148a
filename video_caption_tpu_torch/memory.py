"""Device-memory observability and OOM guard (counterpart of
video_caption_tpu/memory.py).

``snapshot`` reads ``torch.cuda.memory_stats`` of the card: bytes held by
tensors, bytes the caching allocator reserved, and the peak of the former.
On the CPU every field is None, as on a JAX backend without
``memory_stats``. The guard logs a snapshot on an out-of-memory error and
re-raises it.
"""
from __future__ import annotations

import contextlib
import logging
from dataclasses import dataclass
from typing import Optional

import torch

from video_caption_tpu_torch.config import MemoryConfig

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class DeviceMemorySnapshot:
    bytes_in_use: Optional[int]
    bytes_limit: Optional[int]
    peak_bytes_in_use: Optional[int]
    bytes_reserved: Optional[int] = None

    @property
    def mb_in_use(self) -> Optional[float]:
        return None if self.bytes_in_use is None else self.bytes_in_use / 2**20


def is_oom_error(err: BaseException) -> bool:
    if isinstance(err, torch.cuda.OutOfMemoryError):
        return True
    msg = str(err)
    return "RESOURCE_EXHAUSTED" in msg or "Out of memory" in msg or "out of memory" in msg


class MemoryManager:
    """Memory of one device: the card unless ``device`` names the CPU."""

    def __init__(self, config: MemoryConfig | None = None, device="cuda"):
        self.config = config or MemoryConfig()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but no CUDA device is available")

    def snapshot(self) -> DeviceMemorySnapshot:
        if self.device.type != "cuda":
            return DeviceMemorySnapshot(None, None, None, None)
        stats = torch.cuda.memory_stats(self.device)
        return DeviceMemorySnapshot(
            bytes_in_use=stats.get("allocated_bytes.all.current", 0),
            bytes_limit=torch.cuda.get_device_properties(self.device).total_memory,
            peak_bytes_in_use=stats.get("allocated_bytes.all.peak", 0),
            bytes_reserved=stats.get("reserved_bytes.all.current", 0),
        )

    @contextlib.contextmanager
    def oom_guard(self):
        """Log a snapshot and re-raise on device OOM."""
        try:
            yield
        except Exception as err:
            if is_oom_error(err):
                snap = self.snapshot()
                log.error("device OOM; in_use=%s reserved=%s limit=%s", snap.bytes_in_use,
                          snap.bytes_reserved, snap.bytes_limit)
            raise
