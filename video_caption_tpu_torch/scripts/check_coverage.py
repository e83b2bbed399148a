"""Frame-coverage verification (counterpart of
video_caption_tpu/scripts/check_coverage.py; reference:
scripts/check_train_test_val.py:4-17, test_cover_valtest.py,
re_check_test_val.py): percentage of annotation records whose frames_dir
actually contains frame_*.jpg, with failure lists — the data-repair loop's
measuring stick ("coverage 13.3% -> 96.6%", exp_log_1001.md).

Also provides the annotation-repair pass (reference: filter_missing_frames.py,
patch_frames_dir.py): drop or re-point records with missing frames.

    python -m video_caption_tpu_torch.scripts.check_coverage --ann_path A.json
"""
from __future__ import annotations

import argparse
import difflib
import json
import logging
from pathlib import Path
from typing import Dict, List, Tuple

from video_caption_tpu_torch.preprocessing.frame_loader import list_frames

log = logging.getLogger(__name__)


def check_coverage(ann_path: str) -> Tuple[float, List[str]]:
    records = json.loads(Path(ann_path).read_text(encoding="utf-8"))
    missing = [
        rec.get("video_id", "?") for rec in records
        if not rec.get("frames_dir") or not list_frames(rec["frames_dir"])
    ]
    total = max(len(records), 1)
    coverage = (total - len(missing)) / total
    log.info("%s: %d/%d covered (%.1f%%)", ann_path, total - len(missing), total,
             coverage * 100)
    return coverage, missing


def repair_annotations(
    ann_path: str, frames_root: str, out_path: str, fuzzy: bool = True,
) -> Dict[str, int]:
    """Re-point frames_dir at <frames_root>/<video_id> (difflib fuzzy match
    like patch_frames_dir.py:14-15), then drop still-missing records."""
    records = json.loads(Path(ann_path).read_text(encoding="utf-8"))
    available = {p.name: p for p in Path(frames_root).iterdir() if p.is_dir()}
    patched = dropped = 0
    kept = []
    for rec in records:
        vid = rec.get("video_id", "")
        if rec.get("frames_dir") and list_frames(rec["frames_dir"]):
            kept.append(rec)
            continue
        target = available.get(vid)
        if target is None and fuzzy:
            close = difflib.get_close_matches(vid, list(available), n=1, cutoff=0.8)
            target = available.get(close[0]) if close else None
        if target is not None and list_frames(target):
            rec["frames_dir"] = str(target)
            patched += 1
            kept.append(rec)
        else:
            dropped += 1
    Path(out_path).write_text(json.dumps(kept, indent=1))
    stats = {"kept": len(kept), "patched": patched, "dropped": dropped}
    log.info("repair: %s", stats)
    return stats


def alias_frame_names(frames_dir: str, pattern: str = "*.jpg") -> int:
    """Hardlink non-canonical frame files to ``frame_%05d.jpg`` names
    (reference: scripts/msvd_compat_frame_names*.py — frame-name aliasing via
    hardlink so the canonical ``frame_*.jpg`` glob finds them)."""
    d = Path(frames_dir)
    existing = set(p.name for p in d.glob("frame_*.jpg"))
    if existing:
        return 0
    created = 0
    for i, src in enumerate(sorted(d.glob(pattern)), start=1):
        if src.name.startswith("frame_"):
            continue
        dst = d / f"frame_{i:05d}.jpg"
        if not dst.exists():
            try:
                dst.hardlink_to(src)
            except OSError:
                import shutil

                shutil.copy2(src, dst)
            created += 1
    if created:
        log.info("aliased %d frames in %s", created, d)
    return created


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser()
    p.add_argument("--ann_path", required=True, nargs="+")
    p.add_argument("--repair_frames_root", default="")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    for ann in args.ann_path:
        coverage, missing = check_coverage(ann)
        if missing[:10]:
            log.info("first missing: %s", missing[:10])
        if args.repair_frames_root:
            repair_annotations(ann, args.repair_frames_root,
                               args.out or ann.replace(".json", ".repaired.json"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
