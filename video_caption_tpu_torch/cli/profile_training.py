"""Where one training step's time goes on the GPU, for the port's two
trainers at the widths ``chip_smoke.py`` trains them.

    python -m video_caption_tpu_torch.cli.profile_training [--steps 6] [--trace-dir DIR]

- ``mapper``: the mapper trainer's step (``MapperTrainer``'s loss and
  optimizer): full-width ViT-B/16 + GPT-2 124M with seeded random f32
  weights, bf16 compute, the encoder frozen; 4 videos x 8 frames of 224x224,
  32 caption tokens.
- ``joint``: the stage-1 joint step of ``cli/train_full.py --model vit``
  (cosine-embedding loss, ``adamw(1e-4)``) with the ViT at ``pool="gap"``,
  f32 and remat; 4 videos x 8 frames, 16 caption tokens.

The batches are seeded random pixels and tokens already on the card (the
data loader's host time is not part of this measurement). For each trainer:
stage times (forward, backward, optimizer; host clock with a synchronise
after each stage), the median over ``--steps`` steps after two warm-up
steps; then one whole step under ``torch.profiler``: device kernels, their
summed device time, the device busy share and the device time by kernel
name. Prints one JSON object per trainer; with ``--trace-dir`` also writes
a Chrome trace per trainer. Needs an NVIDIA GPU: without one it exits with
an error and measures nothing.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

BATCH, FRAMES, IMAGE_SIZE = 4, 8, 224


def _batch(max_len: int, vocab: int, seed: int) -> dict:
    rng = np.random.RandomState(seed)
    mask = np.ones((BATCH, max_len), np.int32)
    mask[:, max_len * 3 // 4:] = 0                       # padded caption tails
    return {"video": torch.from_numpy(rng.randn(BATCH, FRAMES, 3, IMAGE_SIZE, IMAGE_SIZE)
                                      .astype(np.float32)).cuda(),
            "caption_ids": torch.from_numpy(rng.randint(0, vocab, (BATCH, max_len))
                                            .astype(np.int32)).cuda(),
            "attention_mask": torch.from_numpy(mask).cuda()}


def trainers(seed: int, out_dir: str):
    """{name: (params, loss_fn(params, batch), optimizer, batch)} on the card."""
    from video_caption_tpu_torch.cli.train_full import align_loss
    from video_caption_tpu_torch.config import default_inference_config
    from video_caption_tpu_torch.decode.tokenizer import get_tokenizer
    from video_caption_tpu_torch.engine import load_params, model_config_from_inference
    from video_caption_tpu_torch.models import align as al
    from video_caption_tpu_torch.models import caption_model as cm
    from video_caption_tpu_torch.models import vit as vt
    from video_caption_tpu_torch.training.mapper_trainer import MapperTrainer, TrainArgs
    from video_caption_tpu_torch.training.optim import adamw

    # the mapper CLI's model: the default checkpoint path (seeded random
    # weights where it is absent)
    inf_cfg = default_inference_config(num_frames=FRAMES, image_size=IMAGE_SIZE)
    model_cfg = model_config_from_inference(inf_cfg)
    trainer = MapperTrainer(model_cfg, load_params(inf_cfg, model_cfg, seed, "cuda"),
                            TrainArgs(out_dir=out_dir))

    def mapper_loss(p, b):
        return cm.compute_loss(p, b["video"], b["caption_ids"], b["attention_mask"], trainer.cfg)

    vocab = get_tokenizer().vocab_size
    cfg = al.AlignConfig(vit=vt.ViTConfig(pool="gap", dtype=torch.float32, remat=True),
                         temporal_mode="mean", vocab_size=vocab)
    params = al.init_align_params(torch.Generator(device="cuda").manual_seed(seed), cfg, "cuda")
    return {"mapper": (trainer.params, mapper_loss, trainer.optimizer,
                       _batch(32, model_cfg.gpt2.vocab_size, seed)),
            "joint": (params, align_loss(cfg), adamw(params, 1e-4), _batch(16, vocab, seed + 1))}


def step_stages(params, loss_fn, optimizer, batch) -> dict:
    """ms of forward, backward and optimizer of one step, stage by stage;
    the step of training/loop.py's ``sgd_step`` split at its stages."""
    from video_caption_tpu_torch.training.optim import leaves

    flat = [(p, t) for p, t in leaves(params) if t.is_floating_point()]
    for _, t in flat:
        t.requires_grad_(True)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = loss_fn(params, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(loss, [t for _, t in flat], allow_unused=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        for _, t in flat:
            t.requires_grad_(False)
    optimizer.step(params, {p: g for (p, _), g in zip(flat, grads)})
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return {"forward": (t1 - t0) * 1000, "backward": (t2 - t1) * 1000,
            "optimizer": (t3 - t2) * 1000, "total": (t3 - t0) * 1000}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trace-dir", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_training: needs an NVIDIA GPU (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    from video_caption_tpu_torch.cli.profile_request import profile_call
    from video_caption_tpu_torch.training.loop import sgd_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    trace_dir = Path(args.trace_dir) if args.trace_dir else None
    if trace_dir:
        trace_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        built = trainers(args.seed, tmp)
    for name, (params, loss_fn, optimizer, batch) in built.items():
        for _ in range(2):
            sgd_step(params, optimizer, loss_fn, batch)
        runs = [step_stages(params, loss_fn, optimizer, batch) for _ in range(args.steps)]
        stages = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
        torch.cuda.reset_peak_memory_stats()
        prof = profile_call(lambda: float(sgd_step(params, optimizer, loss_fn, batch)),
                            trace_dir / f"{name}.json" if trace_dir else None)
        print(json.dumps({"trainer": name, "device": torch.cuda.get_device_name(0),
                          "steps": args.steps, "stage_ms_median": stages,
                          "peak_bytes": torch.cuda.max_memory_allocated(), "profile": prof}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
