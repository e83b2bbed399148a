"""Server settings (counterpart of video_caption_tpu/server/settings.py)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ServerSettings:
    host: str = "127.0.0.1"
    port: int = 8001
    api_prefix: str = "/api/v1"
    allow_origins: tuple = ("*",)


SETTINGS = ServerSettings()
