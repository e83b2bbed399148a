"""Video-caption dataset + dataloader (the port's own copy of
video_caption_tpu/data/data_loader.py: the same samples, batches, shuffle
order and prefetch thread for the same seed and annotations; only its
imports point at the port's modules). Batches are host numpy; the trainers
move them to the device.

The reference imports ``src/data/data_loader.py`` everywhere but never
committed it (SURVEY critical fact #1); this module reconstructs the
interface from its call sites:

- ``build_dataloader(ann_path, tokenizer, batch_size, max_len, num_frame,
  image_size, shuffle, num_wokers)`` (sic — the misspelled kwarg is accepted
  for drop-in compatibility, src/cli/train.py:84-93),
- batches: ``{"video": [B,T,3,H,W] float32, "caption_ids": [B,L] int32,
  "attention_mask": [B,L] int32, "video_id": list[str]}``
  (scripts/check_dataloader.py:25-29),
- ``_sample_indices`` always returns exactly ``num_frames``: cyclic pad when
  short, uniform center-of-bin subsample when long (exp_log_1001.md),
- records whose frames_dir has no frames are dropped with a warning
  (exp_log_1002.md "Dropped N samples without frames").

Annotation format (scripts/prepare_msvd.py:186-212): a JSON list of records
``{"video_id", "split", "captions": [...], "frames_dir", ...}``; flat
records with a single ``"caption"`` are also accepted.

Batches are host numpy with static shapes (fixed T and L); a background
thread prefetches the next batch while the device runs the current one.
"""
from __future__ import annotations

import json
import logging
import queue
import random
import threading
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from video_caption_tpu_torch.preprocessing.frame_loader import list_frames, load_image

log = logging.getLogger(__name__)


def _sample_indices(total: int, num_frames: int) -> List[int]:
    """Exactly ``num_frames`` indices: cyclic pad when short, uniform
    center-of-bin when long (the reference dataloader-fix contract)."""
    if total <= 0:
        return []
    if total < num_frames:
        return [i % total for i in range(num_frames)]
    edges = np.linspace(0, total, num_frames + 1)
    return [int((edges[i] + edges[i + 1]) // 2) for i in range(num_frames)]


class MSVDDataset:
    """(video_id, frames_dir, caption) samples — one sample per caption."""

    def __init__(
        self,
        ann_path: str,
        num_frames: int = 8,
        image_size: int = 224,
        split: Optional[str] = None,
        captions_per_video: int = 0,   # 0 = all captions
        uint8_pixels: bool = False,    # ship raw pixels, normalize on device
        yuv420_wire: bool = False,     # ship raw 4:2:0 planes (1.5 B/px)
    ):
        self.num_frames = num_frames
        self.image_size = image_size
        self.uint8_pixels = uint8_pixels
        self.yuv420_wire = yuv420_wire
        records = json.loads(Path(ann_path).read_text(encoding="utf-8"))
        if isinstance(records, dict):
            records = records.get("annotations", records.get("records", []))
        self.samples: List[Dict[str, Any]] = []
        dropped = 0
        for rec in records:
            if split and rec.get("split") and rec["split"] != split:
                continue
            frames_dir = rec.get("frames_dir", "")
            if not frames_dir or not list_frames(frames_dir):
                dropped += 1
                continue
            captions = rec.get("captions") or ([rec["caption"]] if "caption" in rec else [])
            if captions_per_video > 0:
                captions = captions[:captions_per_video]
            for cap in captions:
                self.samples.append(
                    {"video_id": rec["video_id"], "frames_dir": frames_dir, "caption": cap}
                )
        if dropped:
            log.warning("Dropped %d samples without frames", dropped)

    def __len__(self) -> int:
        return len(self.samples)

    def load_video(self, frames_dir: str) -> np.ndarray:
        files = list_frames(frames_dir)
        picks = [files[i] for i in _sample_indices(len(files), self.num_frames)]
        if self.yuv420_wire:
            # the serving engine's wire: canonical 4:2:0 JPEGs ship as raw
            # decoded planes [T, plane_len] (1.5 B/px, half the uint8 RGB
            # bytes) and the step finishes the decode on the device
            # (models/caption_model.encode_video -> preprocessing/yuv420.py).
            # Other videos ship RGB; DataLoader._make_batch unifies a mixed
            # batch.
            from video_caption_tpu_torch.native.loader import load_frames_native_yuv420

            packed = load_frames_native_yuv420(picks, self.image_size)
            if packed is not None:
                return packed
        if self.uint8_pixels or self.yuv420_wire:
            from video_caption_tpu_torch.preprocessing.frame_loader import load_image_u8

            return np.stack([load_image_u8(p, self.image_size) for p in picks])
        return np.stack([load_image(p, self.image_size) for p in picks])

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        s = self.samples[idx]
        return {
            "video": self.load_video(s["frames_dir"]),
            "caption": s["caption"],
            "video_id": s["video_id"],
        }


class DataLoader:
    """Batched iterator with fixed-shape tokenized captions and optional
    background prefetch (replaces torch DataLoader workers)."""

    def __init__(
        self,
        dataset: MSVDDataset,
        tokenizer,
        batch_size: int = 2,
        max_len: int = 32,
        shuffle: bool = True,
        num_workers: int = 0,
        drop_last: bool = True,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.max_len = max_len
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = drop_last
        self._rng = random.Random(seed)

    def __len__(self) -> int:
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _tokenize(self, caption: str) -> np.ndarray:
        ids = self.tokenizer.encode(caption)[: self.max_len - 1]
        ids = ids + [self.tokenizer.eos_token_id]
        pad = self.max_len - len(ids)
        mask = [1] * len(ids) + [0] * pad
        ids = ids + [self.tokenizer.pad_token_id] * pad
        return np.asarray(ids, np.int32), np.asarray(mask, np.int32)

    def _make_batch(self, indices: List[int]) -> Dict[str, Any]:
        items = [self.dataset[i] for i in indices]
        ids_masks = [self._tokenize(it["caption"]) for it in items]
        videos = [it["video"] for it in items]
        if self.dataset.yuv420_wire and any(v.ndim == 4 for v in videos) and \
                any(v.ndim == 2 for v in videos):
            # mixed formats: RGB through the bit-exact host conversion, so a
            # batch has one shape (all packed, or all RGB)
            from video_caption_tpu_torch.preprocessing.yuv420 import (
                yuv420_packed_to_rgb_chw_np)

            videos = [v if v.ndim == 4 else yuv420_packed_to_rgb_chw_np(v, self.dataset.image_size)
                      for v in videos]
        video = np.stack(videos)
        if not (self.dataset.uint8_pixels or self.dataset.yuv420_wire):
            video = video.astype(np.float32)
        return {
            "video": video,
            "caption_ids": np.stack([im[0] for im in ids_masks]),
            "attention_mask": np.stack([im[1] for im in ids_masks]),
            "video_id": [it["video_id"] for it in items],
        }

    def _index_batches(self) -> Iterator[List[int]]:
        order = list(range(len(self.dataset)))
        if self.shuffle:
            self._rng.shuffle(order)
        for i in range(0, len(order), self.batch_size):
            chunk = order[i : i + self.batch_size]
            if len(chunk) < self.batch_size and self.drop_last:
                return
            yield chunk

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if self.num_workers <= 0:
            for chunk in self._index_batches():
                yield self._make_batch(chunk)
            return
        # single background prefetch thread: hides JPEG decode behind device time.
        # It ends with its iterator: a consumer that stops early (a trainer's
        # last step) closes the generator, which stops the thread and waits for
        # it, so no frame is read after the caller moves on. A load that fails
        # raises in the consumer's thread.
        q: "queue.Queue" = queue.Queue(maxsize=max(2, self.num_workers))
        sentinel = object()
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for chunk in self._index_batches():
                    if not put(self._make_batch(chunk)):
                        return
                put(sentinel)
            except Exception as err:
                put(err)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()


def build_dataloader(
    ann_path: str,
    tokenizer,
    batch_size: int = 2,
    max_len: int = 32,
    num_frame: int = 8,
    image_size: int = 224,
    shuffle: bool = True,
    num_workers: int = 0,
    split: Optional[str] = None,
    uint8_pixels: bool = False,
    yuv420_wire: bool = False,
    **compat_kwargs,
) -> DataLoader:
    """Reference-compatible factory (src/cli/train.py:84-93). The reference
    call sites pass the misspelled ``num_wokers`` — accepted via
    ``compat_kwargs``. ``uint8_pixels`` ships raw resized pixels and lets the
    device normalize (4x less host->device traffic per training step);
    ``yuv420_wire`` ships raw 4:2:0 planes instead (1.5 B/px — another 2x,
    the same wire the serving engine uses)."""
    if "num_wokers" in compat_kwargs:
        num_workers = compat_kwargs.pop("num_wokers")
    dataset = MSVDDataset(ann_path, num_frames=num_frame, image_size=image_size,
                          split=split, uint8_pixels=uint8_pixels,
                          yuv420_wire=yuv420_wire)
    return DataLoader(
        dataset, tokenizer, batch_size=batch_size, max_len=max_len,
        shuffle=shuffle, num_workers=num_workers,
    )
