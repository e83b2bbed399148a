"""MSVD dataset preparation (counterpart of
video_caption_tpu/scripts/prepare_msvd.py; reference: scripts/prepare_msvd.py,
msvd_prepare.py): turns either (a) a directory of videos + an
``annotations.txt`` of "video_id caption" lines (Kaggle layout), or (b) an
already-extracted frames tree, into the canonical layout:

    <out>/<split>/frames/<video_id>/frame_%05d.jpg
    <out>/<split>/annotations.json   # [{video_id, split, captions[],
                                     #   num_frames, fps, frames_dir}]

Decoding uses cv2 (the reference prefers decord/PyAV — unavailable here);
sampling is uniform center-of-bin (prepare_msvd.py:106-112), frames are
resized to 224 BICUBIC and saved JPEG q95 (:115-124).
"""
from __future__ import annotations

import argparse
import json
import logging
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

log = logging.getLogger(__name__)


def parse_annotations_txt(path: str) -> Dict[str, List[str]]:
    """'video_id caption...' lines -> {video_id: [captions]} (msvd_prepare.py)."""
    grouped: Dict[str, List[str]] = defaultdict(list)
    for line in Path(path).read_text(encoding="utf-8", errors="replace").splitlines():
        line = line.strip()
        if not line:
            continue
        vid, _, caption = line.partition(" ")
        if caption:
            grouped[vid].append(caption.strip())
    return dict(grouped)


def uniform_bin_indices(total: int, num: int) -> List[int]:
    """Center-of-bin sampling, exact reference semantics
    (prepare_msvd.py:106-112 uniform_indices: [0] degenerate cases,
    all frames when num >= total, else clamped bin centers)."""
    if total <= 0:
        return []
    if num <= 1 or total <= 1:
        return [0]
    if num >= total:
        return list(range(total))
    step = total / float(num)
    return [min(total - 1, int(i * step + step / 2)) for i in range(num)]


def extract_video_frames(
    video_path: str, out_dir: Path, num_frames: int = 32,
    image_size: int = 224, quality: int = 95,
) -> int:
    import cv2

    cap = cv2.VideoCapture(str(video_path))
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    picks = set(uniform_bin_indices(total, num_frames))
    out_dir.mkdir(parents=True, exist_ok=True)
    saved = idx = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if idx in picks:
            saved += 1
            resized = cv2.resize(frame, (image_size, image_size), interpolation=cv2.INTER_CUBIC)
            cv2.imwrite(str(out_dir / f"frame_{saved:05d}.jpg"), resized,
                        [cv2.IMWRITE_JPEG_QUALITY, quality])
        idx += 1
    cap.release()
    return saved


def default_split(video_ids: List[str]) -> Dict[str, str]:
    """Deterministic MSVD-style split: train 1576 / val 197 / test 197
    proportions (experiments/exp_log.md:14-16)."""
    ordered = sorted(video_ids)
    n = len(ordered)
    n_train = int(n * 1576 / 1970) if n >= 10 else max(n - 2, 1)
    n_val = int(n * 197 / 1970) if n >= 10 else max((n - n_train) // 2, 0)
    split = {}
    for i, vid in enumerate(ordered):
        split[vid] = "train" if i < n_train else ("val" if i < n_train + n_val else "test")
    return split


def prepare(
    videos_dir: str, annotations_txt: str, out_root: str,
    num_frames: int = 32, image_size: int = 224, limit: int = 0,
    splits: Optional[Dict[str, str]] = None,
) -> Dict[str, int]:
    captions = parse_annotations_txt(annotations_txt)
    videos = {
        p.stem: p for p in Path(videos_dir).iterdir()
        if p.suffix.lower() in {".avi", ".mp4", ".mkv", ".webm", ".mov"}
    }
    vids = [v for v in captions if v in videos]
    if limit:
        vids = vids[:limit]
    splits = splits or default_split(vids)

    records_by_split: Dict[str, List[Dict]] = defaultdict(list)
    for vid in vids:
        split = splits.get(vid, "train")
        frames_dir = Path(out_root) / split / "frames" / vid
        n = extract_video_frames(str(videos[vid]), frames_dir, num_frames, image_size)
        records_by_split[split].append({
            "video_id": vid, "split": split, "captions": captions[vid],
            "num_frames": n, "fps": 0, "frames_dir": str(frames_dir),
        })
        log.info("%s: %d frames, %d captions", vid, n, len(captions[vid]))

    counts = {}
    for split, records in records_by_split.items():
        ann = Path(out_root) / split / "annotations.json"
        ann.parent.mkdir(parents=True, exist_ok=True)
        ann.write_text(json.dumps(records, indent=1))
        counts[split] = len(records)
    log.info("split sizes: %s", counts)
    return counts


# ---------------------------------------------------------------------------
# HF-datasets variant (reference: scripts/prepare_msvd.py:30-212 — loads
# friedrichor/MSVD through `datasets`, decodes each clip with decord/PyAV,
# center-of-bin samples, saves BICUBIC-resized JPEGs + annotation records)
# ---------------------------------------------------------------------------


def get_video_path(example: Dict) -> str:
    """HF Video column -> local file path (reference: prepare_msvd.py:49-63)."""
    v = example.get("video")
    if isinstance(v, dict) and "path" in v:
        return v["path"]
    if isinstance(v, str):
        return v
    for k in ("video_path", "path"):
        if k in example:
            return example[k]
    raise ValueError(f"Cannot locate video path in example keys: {sorted(example)}")


def get_captions(example: Dict) -> List[str]:
    """Caption columns, lowercased+stripped (reference: prepare_msvd.py:65-74)."""
    for key in ("sentences", "captions", "descriptions", "texts"):
        if key in example and example[key]:
            return [str(s).strip().lower() for s in example[key] if str(s).strip()]
    if "sentence" in example:
        return [str(example["sentence"]).strip().lower()]
    return []


def read_frames_decord(video_path: str, num_frames: int) -> List:
    """decord batch read at sampled indices (reference: prepare_msvd.py:75-87)."""
    import decord  # gated optional
    from PIL import Image

    vr = decord.VideoReader(video_path)
    total = len(vr)
    if total == 0:
        return []
    idxs = uniform_bin_indices(total, num_frames)
    frames = vr.get_batch(idxs).asnumpy()
    return [Image.fromarray(frames[i]) for i in range(frames.shape[0])]


def read_frames_pyav(video_path: str, num_frames: int) -> List:
    """PyAV full-decode then sample (reference: prepare_msvd.py:90-104)."""
    import av  # gated optional

    container = av.open(video_path)
    raw = [frame.to_image() for frame in container.decode(container.streams.video[0])]
    container.close()
    if not raw:
        return []
    return [raw[i] for i in uniform_bin_indices(len(raw), num_frames)]


def read_frames_auto(video_path: str, num_frames: int) -> List:
    """First available decoder: decord -> PyAV. Raises with install hints when
    neither exists (this environment ships no video decoder)."""
    errors = []
    for reader in (read_frames_decord, read_frames_pyav):
        try:
            return reader(video_path, num_frames)
        except ImportError as exc:
            errors.append(f"{reader.__name__}: {exc}")
    raise RuntimeError(
        "no video decoder available (`pip install decord` or `pip install av`); "
        + "; ".join(errors)
    )


def save_frames(imgs: List, out_dir: Path, size: int = 224, quality: int = 95) -> List[str]:
    """BICUBIC resize + JPEG save, reference naming (prepare_msvd.py:115-124)."""
    from PIL import Image

    out_dir.mkdir(parents=True, exist_ok=True)
    names = []
    for i, img in enumerate(imgs):
        if size is not None:
            img = img.resize((size, size), Image.BICUBIC)
        fn = out_dir / f"frame_{i:05d}.jpg"
        img.save(fn, quality=quality)
        names.append(str(fn))
    return names


def load_msvd_hf(name: str = "friedrichor/MSVD") -> Dict[str, List[Dict]]:
    """HF dataset -> {split: [example, ...]} (reference: prepare_msvd.py:30-47)."""
    from datasets import load_dataset

    ds = load_dataset(name)
    if hasattr(ds, "items"):
        return {split: list(d) for split, d in ds.items()}
    return {"train": list(ds)}


def prepare_hf(
    name: str, out_root: str, num_frames: int = 12, image_size: int = 224,
    subset: int = 0, overwrite: bool = False,
    reader=read_frames_auto, loader=load_msvd_hf,
) -> Dict[str, int]:
    """Full HF-datasets preparation loop with the reference's skip/resume
    semantics (prepare_msvd.py:155-212): existing frame dirs are reused
    unless --overwrite; caption-less or undecodable clips are skipped.
    ``reader``/``loader`` are injectable for tests and alternate decoders."""
    out = Path(out_root)
    counts: Dict[str, int] = {}
    for split_name, items in loader(name).items():
        if subset:
            items = items[:subset]
        split_dir = out / split_name
        split_dir.mkdir(parents=True, exist_ok=True)
        records: List[Dict] = []
        for ex in items:
            try:
                vid = str(ex.get("video_id") or ex.get("id") or ex.get("name") or "")
                video_path = get_video_path(ex)
                if not vid:
                    vid = Path(video_path).stem
                caps = get_captions(ex)
                if not caps:
                    continue
                frames_dir = split_dir / vid
                if frames_dir.exists() and not overwrite:
                    existing = sorted(frames_dir.glob("frame_*.jpg"))
                    if existing:
                        records.append({
                            "video_id": vid, "split": split_name, "captions": caps,
                            "num_frames": len(existing), "fps": 0,
                            "frames_dir": str(frames_dir),
                        })
                        continue
                imgs = reader(video_path, num_frames)
                if not imgs:
                    continue
                files = save_frames(imgs, frames_dir, size=image_size)
                records.append({
                    "video_id": vid, "split": split_name, "captions": caps,
                    "num_frames": len(files), "fps": 0, "frames_dir": str(frames_dir),
                })
            except Exception as exc:
                log.warning("skipping %s: %s", ex.get("video_id", "?"), exc)
                continue
        ann = split_dir / "annotations.json"
        ann.write_text(json.dumps(records, ensure_ascii=False, indent=2), encoding="utf-8")
        counts[split_name] = len(records)
    log.info("HF prep split sizes: %s", counts)
    return counts


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser()
    p.add_argument("--videos_dir", help="Kaggle layout: directory of video files")
    p.add_argument("--annotations_txt", help="Kaggle layout: 'video_id caption' lines")
    p.add_argument("--hf_name", help="HF-datasets layout: dataset name (e.g. friedrichor/MSVD)")
    p.add_argument("--out_root", default="data/processed/msvd")
    p.add_argument("--num_frames", type=int, default=32)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--overwrite", action="store_true")
    args = p.parse_args(argv)
    if args.hf_name:
        prepare_hf(args.hf_name, args.out_root, args.num_frames, args.image_size,
                   subset=args.limit, overwrite=args.overwrite)
        return 0
    if not (args.videos_dir and args.annotations_txt):
        p.error("either --hf_name or (--videos_dir and --annotations_txt) is required")
    prepare(args.videos_dir, args.annotations_txt, args.out_root,
            args.num_frames, args.image_size, args.limit)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
