"""REST client for the caption backend (counterpart of
video_caption_tpu/frontend/api_client.py; reference:
frontend/api_client.py:11-27).

Posts to ``$VIDEO_CAPTION_BACKEND_URL/api/v1/infer`` (default
http://127.0.0.1:8001, read at import; the port's server is
``python -m video_caption_tpu_torch.cli.serve``) with a 180s timeout. httpx
when available, stdlib urllib otherwise — the frontend must not require
heavyweight deps.
"""
from __future__ import annotations

import json
import os
import urllib.error
import urllib.request
from typing import Dict

BACKEND_URL = os.environ.get("VIDEO_CAPTION_BACKEND_URL", "http://127.0.0.1:8001")
TIMEOUT_S = 180.0


class BackendError(RuntimeError):
    pass


def _post_json(url: str, payload: Dict) -> Dict:
    try:
        import httpx

        resp = httpx.post(url, json=payload, timeout=TIMEOUT_S)
        if resp.status_code >= 400:
            try:
                detail = resp.json().get("detail", resp.text)
            except Exception:
                detail = resp.text
            raise BackendError(f"backend error {resp.status_code}: {detail}")
        return resp.json()
    except ImportError:
        pass
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT_S) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as err:
        try:
            detail = json.loads(err.read()).get("detail", str(err))
        except Exception:
            detail = str(err)
        raise BackendError(f"backend error {err.code}: {detail}") from err
    except urllib.error.URLError as err:
        raise BackendError(f"backend unreachable at {url}: {err.reason}") from err


def infer_caption(frames_dir: str, **overrides) -> Dict:
    """frames_dir -> {"S1","S2","S3","BEST":{key,text}}."""
    payload = {"frames_dir": frames_dir, **overrides}
    return _post_json(f"{BACKEND_URL}/api/v1/infer", payload)


def check_health() -> bool:
    try:
        with urllib.request.urlopen(f"{BACKEND_URL}/health", timeout=5) as resp:
            return json.loads(resp.read()).get("status") == "ok"
    except Exception:
        return False
