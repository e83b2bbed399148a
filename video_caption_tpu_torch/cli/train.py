"""Dry-run trainer on the PyTorch/CUDA port (counterpart of
video_caption_tpu/cli/train.py: the same flags, plus ``--device``): the toy
SimpleAlignModel (models/toy.py) over the real data loader, which exercises
data -> loss -> optimizer before the full model. Writes events.csv under
--out_dir.

    python -m video_caption_tpu_torch.cli.train --ann_path A.json [--max_steps 50]
"""
from __future__ import annotations

import argparse
import logging


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ann_path", default="data/processed/msvd/train/annotations.json")
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--num_frame", type=int, default=8)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--max_len", type=int, default=32)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--max_steps", type=int, default=50)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--out_dir", default="runs/dry_run")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    args = parse_args(argv)

    import torch

    from video_caption_tpu_torch.data import build_dataloader
    from video_caption_tpu_torch.decode.tokenizer import get_tokenizer
    from video_caption_tpu_torch.models import toy
    from video_caption_tpu_torch.training.loop import LoopConfig, run_training
    from video_caption_tpu_torch.training.optim import adamw

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available")
    tokenizer = get_tokenizer()
    loader = build_dataloader(
        args.ann_path, tokenizer, batch_size=args.batch_size, max_len=args.max_len,
        num_frame=args.num_frame, image_size=args.image_size,
    )
    cfg = toy.ToyConfig(vocab_size=tokenizer.vocab_size)
    params = toy.init_simple_align(torch.Generator(device=device).manual_seed(0), cfg, device)

    def loss_fn(p, batch):
        return toy.simple_align_loss(p, batch["video"], batch["caption_ids"],
                                     batch["attention_mask"])

    def drop_ids(batch):
        return {k: v for k, v in batch.items() if k != "video_id"}

    result = run_training(
        params, loss_fn, adamw(params, args.lr), loader,
        cfg=LoopConfig(epochs=args.epochs, max_steps=args.max_steps, out_dir=args.out_dir),
        batch_transform=drop_ids,
    )
    logging.info("dry run done: %d steps", result["steps"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
