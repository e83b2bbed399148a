"""Frozen-encoder feature extraction (counterpart of
video_caption_tpu/retrieval/features.py; reference:
scripts/extract_features.py:17-55): one L2-normalized embedding per video,
saved as .npy files plus a consolidated features matrix.

Videos are encoded in batches (``cm.encode_video`` on ``device``, the card
by default): a batch of V videos of T frames runs the ViT over V*T frames
at once, where the reference runs one video a forward."""
from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch

log = logging.getLogger(__name__)


def extract_features(
    ann_path: str,
    out_dir: str,
    num_frames: int = 8,
    image_size: int = 224,
    batch_size: int = 8,
    limit: int = 0,
    encoder=None,
    device="cuda",
) -> Tuple[np.ndarray, List[str]]:
    """Returns (features [N,D] L2-normalized, video_ids); writes per-video
    .npy files + features.npy + ids.json under out_dir. ``encoder`` maps a
    batch of videos [V,T,3,S,S] f32 on ``device`` to embeddings [V,D];
    by default the configured checkpoint's (or seeded random) encoder."""
    from video_caption_tpu_torch.data.data_loader import MSVDDataset

    device = torch.device(device)
    if encoder is None:
        from video_caption_tpu_torch.config import default_inference_config
        from video_caption_tpu_torch.engine import load_params, model_config_from_inference
        from video_caption_tpu_torch.models import caption_model as cm

        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but no CUDA device is available")
        cfg = default_inference_config(num_frames=num_frames, image_size=image_size)
        mc = model_config_from_inference(cfg)
        params = load_params(cfg, mc, 0, device)

        def encoder(video):
            return cm.encode_video(params, video, mc)

    ds = MSVDDataset(ann_path, num_frames=num_frames, image_size=image_size,
                     captions_per_video=1)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    feats, ids = [], []
    batch_videos, batch_ids = [], []

    def flush():
        if not batch_videos:
            return
        videos = torch.from_numpy(np.stack(batch_videos)).to(device)
        with torch.inference_mode():
            emb = encoder(videos).float().cpu().numpy()
        emb = emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-12)
        for vid, e in zip(batch_ids, emb):
            np.save(out / f"{vid}.npy", e)
            feats.append(e)
            ids.append(vid)
        batch_videos.clear()
        batch_ids.clear()

    seen = set()
    for sample in ds.samples:
        vid = sample["video_id"]
        if vid in seen:
            continue
        seen.add(vid)
        if limit and len(seen) > limit:
            break
        batch_videos.append(ds.load_video(sample["frames_dir"]))
        batch_ids.append(vid)
        if len(batch_videos) == batch_size:
            flush()
    flush()

    features = np.stack(feats) if feats else np.zeros((0, 0), np.float32)
    np.save(out / "features.npy", features)
    (out / "ids.json").write_text(json.dumps(ids))
    log.info("extracted %d features to %s", len(ids), out)
    return features, ids
