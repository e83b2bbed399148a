"""Query an mp4 against the retrieval index (counterpart of
video_caption_tpu/retrieval/query_video.py; reference:
scripts/query_video.py:22-143): extract frames on the host (ffmpeg, cv2
fallback) -> encode on the card -> top-k neighbors with captions from
meta.json.
"""
from __future__ import annotations

import argparse
import json
import logging
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

log = logging.getLogger(__name__)


def extract_frames_from_video(video_path: str, out_dir: str, fps: int = 2) -> int:
    """ffmpeg first, cv2 fallback (reference :22-60). Returns frame count."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if shutil.which("ffmpeg"):
        cmd = ["ffmpeg", "-y", "-loglevel", "error", "-i", video_path,
               "-vf", f"fps={fps}", str(out / "frame_%06d.jpg")]
        subprocess.run(cmd, check=True)
        return len(list(out.glob("frame_*.jpg")))
    import cv2

    cap = cv2.VideoCapture(video_path)
    native_fps = cap.get(cv2.CAP_PROP_FPS) or 30
    step = max(int(round(native_fps / fps)), 1)
    count = saved = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if count % step == 0:
            saved += 1
            cv2.imwrite(str(out / f"frame_{saved:06d}.jpg"), frame)
        count += 1
    cap.release()
    return saved


def query_video(
    video_path: str, index_dir: str, top_k: int = 5,
    num_frames: int = 8, image_size: int = 224, device="cuda",
) -> List[Dict]:
    from video_caption_tpu_torch.config import default_inference_config
    from video_caption_tpu_torch.engine import load_params, model_config_from_inference
    from video_caption_tpu_torch.models import caption_model as cm
    from video_caption_tpu_torch.preprocessing.frame_loader import load_video_array
    from video_caption_tpu_torch.retrieval.index import load_index

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA device is available")
    with tempfile.TemporaryDirectory() as tmp:
        n = extract_frames_from_video(video_path, tmp)
        if n == 0:
            raise RuntimeError(f"no frames extracted from {video_path}")
        video = torch.from_numpy(load_video_array(tmp, num_frames, image_size)).to(device)

    cfg = default_inference_config(num_frames=num_frames, image_size=image_size)
    mc = model_config_from_inference(cfg)
    params = load_params(cfg, mc, 0, device)
    with torch.inference_mode():
        emb = cm.encode_video(params, video, mc).float().cpu().numpy()
    emb = emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-12)

    index, meta = load_index(index_dir)
    scores, idx = index.search(emb, top_k)
    return [
        {"rank": j + 1, "score": float(scores[0, j]),
         "video_id": meta[int(idx[0, j])]["video_id"],
         "caption": meta[int(idx[0, j])]["caption"]}
        for j in range(idx.shape[1])
    ]


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser()
    p.add_argument("--video", required=True)
    p.add_argument("--index_dir", required=True)
    p.add_argument("--top_k", type=int, default=5)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for row in query_video(args.video, args.index_dir, args.top_k, device=args.device):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
