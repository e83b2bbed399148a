"""Multiprocess frame extraction at fixed fps (counterpart of
video_caption_tpu/scripts/extract_frames.py; reference:
scripts/extract_frames.py + extract_frames_mp.py): ffmpeg ``-vf fps=N`` into
``frame_%06d.jpg`` per video, ThreadPoolExecutor parallelism,
``--only-missing`` skip, cv2 fallback when ffmpeg is absent.

    python -m video_caption_tpu_torch.scripts.extract_frames --videos_dir V \\
        --out_root FRAMES
"""
from __future__ import annotations

import argparse
import logging
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor, as_completed
from pathlib import Path
from typing import List, Tuple

log = logging.getLogger(__name__)


def extract_one(video_path: Path, out_dir: Path, fps: int = 2,
                only_missing: bool = True) -> Tuple[str, int]:
    if only_missing and list(out_dir.glob("frame_*.jpg")):
        return video_path.stem, -1  # skipped
    out_dir.mkdir(parents=True, exist_ok=True)
    if shutil.which("ffmpeg"):
        subprocess.run(
            ["ffmpeg", "-y", "-loglevel", "error", "-i", str(video_path),
             "-vf", f"fps={fps}", str(out_dir / "frame_%06d.jpg")],
            check=True,
        )
    else:
        from video_caption_tpu_torch.retrieval.query_video import extract_frames_from_video

        extract_frames_from_video(str(video_path), str(out_dir), fps)
    return video_path.stem, len(list(out_dir.glob("frame_*.jpg")))


def extract_all(videos_dir: str, out_root: str, fps: int = 2,
                workers: int = 4, only_missing: bool = True) -> List[Tuple[str, int]]:
    videos = [
        p for p in Path(videos_dir).iterdir()
        if p.suffix.lower() in {".avi", ".mp4", ".mkv", ".webm", ".mov"}
    ]
    results = []
    with ThreadPoolExecutor(max_workers=workers) as pool:
        futures = {
            pool.submit(extract_one, v, Path(out_root) / v.stem, fps, only_missing): v
            for v in videos
        }
        for fut in as_completed(futures):
            vid, n = fut.result()
            results.append((vid, n))
            if n >= 0:
                log.info("%s: %d frames", vid, n)
    return results


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser()
    p.add_argument("--videos_dir", required=True)
    p.add_argument("--out_root", required=True)
    p.add_argument("--fps", type=int, default=2)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--only-missing", action="store_true", default=True)
    args = p.parse_args(argv)
    extract_all(args.videos_dir, args.out_root, args.fps, args.workers, args.only_missing)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
