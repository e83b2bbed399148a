"""Caption an mp4/avi directly (counterpart of
video_caption_tpu/cli/caption_video.py, the same flags plus ``--device``;
reference: scripts/generate_caption.py:126-196): extract frames to a temp
dir (ffmpeg, cv2 fallback) then run the standard engine pipeline.

Usage: python -m video_caption_tpu_torch.cli.caption_video --video clip.mp4
"""
from __future__ import annotations

import argparse
import json
import logging
import tempfile


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser()
    p.add_argument("--video", required=True)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--num_frames", type=int, default=8)
    p.add_argument("--fps", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--emit_json", action="store_true")
    args = p.parse_args(argv)

    from video_caption_tpu_torch.config import default_inference_config
    from video_caption_tpu_torch.engine import InferenceEngine
    from video_caption_tpu_torch.retrieval.query_video import extract_frames_from_video

    overrides = {"num_frames": args.num_frames}
    if args.ckpt:
        overrides["ckpt"] = args.ckpt
    engine = InferenceEngine(default_inference_config(**overrides), device=args.device)

    with tempfile.TemporaryDirectory() as tmp:
        n = extract_frames_from_video(args.video, tmp, fps=args.fps)
        if n == 0:
            raise SystemExit(f"no frames extracted from {args.video}")
        logging.info("extracted %d frames", n)
        payload = engine.infer(tmp).to_api_dict()

    if args.emit_json:
        print(json.dumps(payload))
    else:
        print(f"BEST[{payload['BEST']['key']}]: {payload['BEST']['text']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
