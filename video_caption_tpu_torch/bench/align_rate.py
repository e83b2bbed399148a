"""The quality loop's align stage at several Adam rates, through the kernels
and through the plain path, on the same records and the same init.

The align stage (``tools/quality_loop.align_steps``: the f32 GAP ViT with
remat, ``temporal_mode="diff"``, symmetric InfoNCE at 0.07) is run from one
seeded init for ``--steps`` steps at each rate of ``--lrs``, on each leg of
``--legs``:

- ``kernel``: on the card, as the loop runs it (encoder_attention's and
  fused_pool's kernels forward, their closed-form backwards);
- ``plain``: on the card with both wrappers taking their plain versions
  (``encoder_attention_ref``, ``fused_pool_ref``), so no kernel of the port
  runs; autograd and the optimizer as in ``kernel``;
- ``cpu``: the plain path on the CPU in f32, as the tests run it.

For each leg and rate it prints one JSON line: the loss of every step, the
launches of the two kernels, and the mean off-diagonal cosine between the
video embeddings and between the text embeddings of the records, at init
and trained (1.0: every record at one point). The legs agree over the first steps
where the kernels are right; a rate at which the plain legs collapse too
collapses by the algorithm, not by a kernel.

The records are the quality loop's synthetic dataset at the flags given
(by default ``chip_smoke.py``'s cut: 4 classes, 2 train videos each).

Usage: python -m video_caption_tpu_torch.bench.align_rate [--legs kernel,plain,cpu]
    [--lrs 1e-3,3e-4,1e-4] [--steps 30] [--cpu_lrs 1e-3] [--cpu_steps 20]
    [--out PATH]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import torch


@contextlib.contextmanager
def plain_kernels():
    """Both align-stage wrappers take their plain versions on any device."""
    from video_caption_tpu_torch.ops import encoder_attention as ea
    from video_caption_tpu_torch.ops import fused_pool as fpl

    saved = ea._launch, fpl._launch
    ea._launch, fpl._launch = ea.encoder_attention_ref, fpl.fused_pool_ref
    try:
        yield
    finally:
        ea._launch, fpl._launch = saved


def mean_off_diagonal_cosine(x: torch.Tensor) -> float:
    """Mean cosine between distinct rows of ``x`` (rows L2-normalized)."""
    n = x.shape[0]
    sim = x.float() @ x.float().T
    return float((sim.sum() - sim.diagonal().sum()) / (n * (n - 1)))


def run_leg(leg: str, lr: float, steps: int, ann: str, num_frames: int,
            image_size: int, seed: int = 0) -> Dict:
    from video_caption_tpu_torch.models import align
    from video_caption_tpu_torch.ops import encoder_attention as ea
    from video_caption_tpu_torch.ops import fused_pool as fpl
    from video_caption_tpu_torch.tools.quality_loop import align_setup, align_steps

    device = "cpu" if leg == "cpu" else "cuda"
    cfg, params0, _, videos, ids, mask = align_setup(ann, num_frames, image_size, seed,
                                                     device=device)
    with torch.no_grad():
        cos0 = (mean_off_diagonal_cosine(align.encode_video(params0, videos, cfg)),
                mean_off_diagonal_cosine(align.encode_text(params0, ids, mask, cfg)))
    before = ea.launches, fpl.launches
    t0 = time.perf_counter()
    with plain_kernels() if leg == "plain" else contextlib.nullcontext():
        params, losses = align_steps(cfg, params0, videos, ids, mask, steps, lr,
                                     batch_size=videos.shape[0])
        if device == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        with torch.no_grad():
            v = align.encode_video(params, videos, cfg)
            t = align.encode_text(params, ids, mask, cfg)
    return {"leg": leg, "lr": lr, "steps": steps, "records": int(videos.shape[0]),
            "losses": losses, "ln_records": math.log(videos.shape[0]),
            "video_cos": mean_off_diagonal_cosine(v), "text_cos": mean_off_diagonal_cosine(t),
            "video_cos_init": cos0[0], "text_cos_init": cos0[1],
            "launches": {"encoder_attention": ea.launches - before[0],
                         "fused_pool": fpl.launches - before[1]},
            "seconds": seconds}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--legs", default="kernel,plain,cpu")
    p.add_argument("--lrs", default="1e-3,3e-4,1e-4")
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--cpu_steps", type=int, default=20, help="steps of the cpu leg")
    p.add_argument("--cpu_lrs", default="1e-3", help="rates of the cpu leg")
    p.add_argument("--cpu_threads", type=int, default=0, help="0: torch's default")
    p.add_argument("--num_frames", type=int, default=8)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--colors", type=int, default=2)
    p.add_argument("--shapes", type=int, default=1)
    p.add_argument("--motions", type=int, default=2)
    p.add_argument("--sizes", type=int, default=1)
    p.add_argument("--train_per_class", type=int, default=2)
    p.add_argument("--out", help="also write the results as JSON lines to this path")
    args = p.parse_args(argv)
    from video_caption_tpu_torch.tools.quality_loop import make_synthetic_dataset

    legs = args.legs.split(",")
    if set(legs) - {"kernel", "plain", "cpu"}:
        raise ValueError(f"unknown legs in {args.legs!r}")
    if {"kernel", "plain"} & set(legs) and not torch.cuda.is_available():
        raise RuntimeError("the kernel and plain legs need a CUDA device")
    if args.cpu_threads:
        torch.set_num_threads(args.cpu_threads)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows: List[Dict] = []
    with tempfile.TemporaryDirectory() as root:
        ann = make_synthetic_dataset(
            root, num_frames=args.num_frames, image_size=args.image_size, colors=args.colors,
            shapes=args.shapes, motions=args.motions, sizes=args.sizes,
            train_per_class=args.train_per_class, val_per_class=1)["train"]
        for leg in legs:
            lrs = args.cpu_lrs if leg == "cpu" else args.lrs
            for lr in (float(x) for x in lrs.split(",")):
                steps = args.cpu_steps if leg == "cpu" else args.steps
                rows.append(run_leg(leg, lr, steps, ann, args.num_frames, args.image_size))
                print(json.dumps(rows[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
