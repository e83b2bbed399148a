"""One-video CLI inference on the PyTorch/CUDA port (counterpart of
video_caption_tpu/cli/infer_once.py: the same flags and JSON output, plus
``--device``).

Usage:
    python -m video_caption_tpu_torch.cli.infer_once --frames_dir PATH [--emit_json]
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Single-video caption inference (PyTorch/CUDA)")
    p.add_argument("--frames_dir", required=True)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--num_frames", type=int, default=8)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--prefix_len", type=int, default=4)
    p.add_argument("--ln_scale", type=float, default=0.6)
    p.add_argument("--in_weight", type=float, default=0.4)
    p.add_argument("--preset1", default="precise")
    p.add_argument("--preset2", default="precise")
    p.add_argument("--preset3", default="natural")
    p.add_argument("--prompt1", default="")
    p.add_argument("--prompt2", default="State the main action in one short sentence:")
    p.add_argument("--prompt3", default="Write a short, natural caption:")
    p.add_argument("--device", default="cuda")
    p.add_argument("--emit_json", action="store_true")
    return p


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    args = build_parser().parse_args(argv)

    from video_caption_tpu_torch.config import default_inference_config
    from video_caption_tpu_torch.engine import InferenceEngine

    overrides = dict(
        num_frames=args.num_frames, image_size=args.image_size,
        prefix_len=args.prefix_len, ln_scale=args.ln_scale, in_weight=args.in_weight,
        preset1=args.preset1, preset2=args.preset2, preset3=args.preset3,
        prompt1=args.prompt1, prompt2=args.prompt2, prompt3=args.prompt3,
    )
    if args.ckpt:
        overrides["ckpt"] = args.ckpt
    engine = InferenceEngine(default_inference_config(**overrides), device=args.device)
    t0 = time.time()
    result = engine.infer(args.frames_dir)
    logging.info("inference done in %.2fs best=%s", time.time() - t0, result.best_key)
    payload = result.to_api_dict()
    if args.emit_json:
        print(json.dumps(payload))
    else:
        for key in ("S1", "S2", "S3"):
            print(f"{key}: {payload[key]}")
        print(f"BEST[{payload['BEST']['key']}]: {payload['BEST']['text']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
