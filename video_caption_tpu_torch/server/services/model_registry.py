"""Engine cache (counterpart of
video_caption_tpu/server/services/model_registry.py): one resident engine
per distinct config, keyed by ``config.cache_key()``, so a repeat config
reuses its loaded weights and captured graphs."""
from __future__ import annotations

import logging
import threading
from typing import Dict

from video_caption_tpu_torch.config import InferenceConfig
from video_caption_tpu_torch.engine import InferenceEngine

log = logging.getLogger(__name__)


class ModelRegistry:
    """Engines on ``device`` (the card unless a caller passes the CPU)."""

    def __init__(self, device="cuda"):
        self.device = device
        self._engines: Dict[str, InferenceEngine] = {}
        self._lock = threading.Lock()

    def get_engine(self, config: InferenceConfig) -> InferenceEngine:
        key = config.cache_key()
        with self._lock:
            engine = self._engines.get(key)
            if engine is None:
                log.info("building engine for config %s on %s", key, self.device)
                engine = InferenceEngine(config, device=self.device)
                self._engines[key] = engine
            return engine

    def __len__(self) -> int:
        return len(self._engines)

    def clear(self) -> None:
        """Drop every cached engine (a rebuild then reads the environment's
        settings again, the video cache budget among them)."""
        with self._lock:
            self._engines.clear()


MODEL_REGISTRY = ModelRegistry()
