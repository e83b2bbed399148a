"""MSVD source-video fetch + clip (counterpart of
video_caption_tpu/scripts/msvd_fetch_youtube.py; reference:
scripts/msvd_fetch_youtube.py, msvd_make_frames.py): yt-dlp full videos,
ffmpeg clip by the ``<ytid>_<start>_<end>`` id pattern, frames at fps=8.
Only the fetch needs the network, and it is gated on yt-dlp being
installed; the clip/frame stages work on any local videos.
"""
from __future__ import annotations

import argparse
import logging
import re
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

log = logging.getLogger(__name__)

_ID_RE = re.compile(r"^(?P<ytid>.+)_(?P<start>\d+)_(?P<end>\d+)$")


def parse_clip_id(video_id: str) -> Optional[Tuple[str, int, int]]:
    m = _ID_RE.match(video_id)
    if not m:
        return None
    return m["ytid"], int(m["start"]), int(m["end"])


def fetch_full_video(ytid: str, out_dir: str) -> Optional[Path]:
    try:
        import yt_dlp  # noqa: F401
    except ImportError:
        log.error("yt-dlp not installed; cannot fetch %s", ytid)
        return None
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    target = out / f"{ytid}.mp4"
    if target.exists():
        return target
    cmd = ["yt-dlp", "-f", "mp4", "-o", str(target), f"https://www.youtube.com/watch?v={ytid}"]
    subprocess.run(cmd, check=True)
    return target


def clip_video(full_path: Path, start: int, end: int, out_path: Path) -> bool:
    if not shutil.which("ffmpeg"):
        log.error("ffmpeg not available")
        return False
    out_path.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run(
        ["ffmpeg", "-y", "-loglevel", "error", "-ss", str(start), "-to", str(end),
         "-i", str(full_path), "-c", "copy", str(out_path)],
        check=True,
    )
    return out_path.exists()


def make_frames(clip_path: Path, frames_dir: Path, fps: int = 8) -> int:
    """fps=8 frame dump (msvd_make_frames.py:9-11)."""
    from video_caption_tpu_torch.retrieval.query_video import extract_frames_from_video

    return extract_frames_from_video(str(clip_path), str(frames_dir), fps=fps)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser()
    p.add_argument("--video_ids", nargs="+", required=True,
                   help="MSVD ids like ytid_start_end")
    p.add_argument("--cache_dir", default="data/raw/youtube")
    p.add_argument("--clips_dir", default="data/raw/clips")
    p.add_argument("--frames_root", default="data/processed/frames")
    p.add_argument("--fps", type=int, default=8)
    args = p.parse_args(argv)
    for vid in args.video_ids:
        parsed = parse_clip_id(vid)
        if not parsed:
            log.warning("skip %s: not a <ytid>_<start>_<end> id", vid)
            continue
        ytid, start, end = parsed
        full = fetch_full_video(ytid, args.cache_dir)
        if full is None:
            continue
        clip = Path(args.clips_dir) / f"{vid}.mp4"
        if clip_video(full, start, end, clip):
            n = make_frames(clip, Path(args.frames_root) / vid, args.fps)
            log.info("%s: %d frames", vid, n)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
