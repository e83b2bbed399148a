"""Chainlit chat frontend (counterpart of
video_caption_tpu/frontend/chainlit_app.py; reference:
frontend/chainlit_app.py:40-81).

Flow: user pastes a frames_dir path -> validate it is a directory -> REST
call to the backend -> markdown reply with BEST plus the three candidates.
Run with: ``chainlit run video_caption_tpu_torch/frontend/chainlit_app.py``.
No model or torch imports are allowed in this module.
"""
from __future__ import annotations

from pathlib import Path

from video_caption_tpu_torch.frontend.api_client import BackendError, infer_caption

try:
    import chainlit as cl
except ImportError:  # pragma: no cover - chainlit not in hermetic images
    cl = None


def format_result(payload: dict) -> str:
    best = payload.get("BEST", {})
    lines = [
        f"**BEST ({best.get('key', '?')}):** {best.get('text', '')}",
        "",
        f"- S1: {payload.get('S1', '')}",
        f"- S2: {payload.get('S2', '')}",
        f"- S3: {payload.get('S3', '')}",
    ]
    return "\n".join(lines)


def handle_message(text: str) -> str:
    frames_dir = text.strip().strip('"')
    if not frames_dir:
        return "Please paste the path of a frames directory (frame_*.jpg)."
    if not Path(frames_dir).is_dir():
        return f"`{frames_dir}` is not a directory on the backend host."
    try:
        return format_result(infer_caption(frames_dir))
    except BackendError as err:
        return f"Inference failed: {err}"


if cl is not None:  # pragma: no cover - interactive surface

    @cl.on_chat_start
    async def on_start():
        await cl.Message(
            content="Paste a frames directory path (containing frame_*.jpg) to caption it."
        ).send()

    @cl.on_message
    async def on_message(message: "cl.Message"):
        reply = handle_message(message.content)
        await cl.Message(content=reply).send()
