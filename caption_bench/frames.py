"""Seeded frame directories: a pool of clips, and request directories that
link to them.

A clip is ``frames`` JPEGs (quality 90, 4:2:0, ``frame_00000.jpg`` ...) of a
smooth scene: per channel a base level and three drifting plane waves of
low spatial frequency, plus mild noise, the size range of dataset frames at
224x224. Every seed draws its scenes from the same distributions, so JPEG
sizes and decode times do not move with the seed.

The engine keys its device video cache by the directory's path, so a request
that must miss the cache gets a new directory holding symbolic links to one
pool clip's frames: a real miss (decode and upload), with few files on disk.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np
from PIL import Image

QUALITY = 90
NOISE_STD = 3.0


def _clip_pixels(rng: np.random.Generator, frames: int, size: int) -> np.ndarray:
    """uint8 [frames, size, size, 3] of one smooth moving scene."""
    coord = np.arange(size, dtype=np.float32) / size
    base = rng.uniform(60.0, 190.0, 3).astype(np.float32)
    freq = rng.uniform(0.5, 3.0, (3, 3, 2)).astype(np.float32)
    phase = rng.uniform(0.0, 2 * np.pi, (3, 3)).astype(np.float32)
    drift = rng.uniform(-0.4, 0.4, (3, 3)).astype(np.float32)
    amp = rng.uniform(15.0, 45.0, (3, 3)).astype(np.float32)
    noise = rng.normal(0.0, NOISE_STD, (size + frames, size, 3)).astype(np.float32)
    out = np.empty((frames, size, size, 3), np.uint8)
    for f in range(frames):
        img = np.empty((size, size, 3), np.float32)
        for c in range(3):
            acc = np.full((size, size), base[c], np.float32)
            for k in range(3):
                # sin(a x + b y + p) as two outer products
                ax = 2 * np.pi * freq[c, k, 0] * coord
                by = 2 * np.pi * freq[c, k, 1] * coord + phase[c, k] + drift[c, k] * f
                acc += amp[c, k] * (np.outer(np.cos(by), np.sin(ax))
                                    + np.outer(np.sin(by), np.cos(ax)))
            img[..., c] = acc
        img += noise[f:f + size]
        out[f] = np.clip(img, 0, 255).astype(np.uint8)
    return out


def _write_clip(args) -> str:
    root, index, seed, frames, size = args
    d = Path(root) / f"clip_{index:03d}"
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng([seed, index])
    for f, pixels in enumerate(_clip_pixels(rng, frames, size)):
        Image.fromarray(pixels).save(d / f"frame_{f:05d}.jpg", quality=QUALITY)
    return str(d)


def make_pool(root: Path, seed: int, clips: int, frames: int, size: int,
              workers: int = 8) -> List[str]:
    """``clips`` clip directories under ``root``; the same seed gives the
    same bytes."""
    jobs = [(str(root), i, seed, frames, size) for i in range(clips)]
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(_write_clip, jobs))


def link_dirs(root: Path, pool: Sequence[str], count: int, order: Sequence[int],
              start: int = 0) -> List[Tuple[str, int]]:
    """``count`` new request directories ``root/req_<n>`` (n from
    ``start``), the i-th holding links to the frames of pool clip
    ``order[i % len(order)]``; returns (directory, clip index) pairs."""
    out = []
    for i in range(count):
        clip = order[i % len(order)]
        d = Path(root) / f"req_{start + i:06d}"
        d.mkdir(parents=True)
        for name in sorted(os.listdir(pool[clip])):
            os.symlink(os.path.join(pool[clip], name), d / name)
        out.append((str(d), clip))
    return out
