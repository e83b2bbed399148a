"""Faults planted in the timed path, to show that the comparison catches
them (``tests/test_bench_comparison.py`` on the CPU; ``control.py --faults`` on the
card). Each is a context manager that patches the program and restores it.

- ``token``: the first id of every served row altered where the program
  produces it (its decode groups' ids, before they are packed);
- ``half``: half of a batch left out: its videos' slots take the first
  half's videos (a batch of one is left as it is);
- ``stale``: the decode step returns its state unchanged: every beam step
  after a decode's first gives back that first step's logits and cache.

The exchange between chips has no fault here: every cell runs on one chip.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(owner, name: str, make):
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def token():
    from video_caption_tpu_torch import engine

    def make(pack):
        def altered(ids):
            ids = [x.clone() for x in ids]
            for x in ids:
                x[:, 0] = (x[:, 0] + 1) % 50257
            return pack(ids)
        return altered
    return _patched(engine, "_pack", make)


def half():
    from video_caption_tpu_torch.engine import InferenceEngine

    def make(load_videos):
        def halved(self, frames_dirs):
            dirs = list(frames_dirs)
            if len(dirs) > 1:
                keep = dirs[:len(dirs) // 2]
                dirs = [keep[i % len(keep)] for i in range(len(dirs))]
            return load_videos(self, dirs)
        return halved
    return _patched(InferenceEngine, "_load_videos", make)


def stale():
    from video_caption_tpu_torch.models import gpt2

    def make(step):
        first = {}

        def unchanged(*args, **kwargs):
            t = args[7] if len(args) > 7 else kwargs["t"]
            if t == 0 or "out" not in first:
                first["out"] = step(*args, **kwargs)
            return first["out"]
        return unchanged
    return _patched(gpt2, "gpt2_beam_step", make)


FAULTS = {"token": token, "half": half, "stale": stale}
