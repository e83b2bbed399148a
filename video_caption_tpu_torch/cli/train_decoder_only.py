"""Stage-3 LM tune on the PyTorch/CUDA port (counterpart of
video_caption_tpu/cli/train_decoder_only.py: the same flags, plus
``--device``): a GPT-2 causal-LM fine-tune on caption text only. Labels are
the input ids with pads masked to -100; ``adamw`` over a linear warmup and
cosine decay, after a global-norm clip of 1.0; validation loss (perplexity
in the log) and the best checkpoint, the ``gpt2_name_b`` side of the JAX
package's eval_compare.

Unlike the JAX CLI, which hands the loop one-shot generators, the caption
batches are lists: a second epoch and every validation see all batches.

    python -m video_caption_tpu_torch.cli.train_decoder_only --ann_path A.json --max_steps 500
"""
from __future__ import annotations

import argparse
import json
import logging
import math
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ann_path", default="data/processed/msvd/train/annotations.json")
    p.add_argument("--val_ann_path", default="")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_len", type=int, default=32)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--max_steps", type=int, default=0)
    p.add_argument("--lr", type=float, default=5e-5)
    p.add_argument("--warmup_steps", type=int, default=100)
    p.add_argument("--val_every", type=int, default=200)
    p.add_argument("--out_dir", default="runs/stage3_lm")
    p.add_argument("--ckpt_path", default="checkpoints/gpt2_lm_stage3_best")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def text_batches(ann_path, tokenizer, batch_size, max_len):
    """Caption-only batches (no video decode for stage 3), in annotation
    order; a last partial batch is dropped."""
    records = json.loads(Path(ann_path).read_text(encoding="utf-8"))
    captions = []
    for rec in records:
        captions.extend(rec.get("captions") or ([rec["caption"]] if "caption" in rec else []))
    out, ids_all, mask_all = [], [], []
    for cap in captions:
        ids = tokenizer.encode(cap)[: max_len - 1] + [tokenizer.eos_token_id]
        pad = max_len - len(ids)
        mask_all.append([1] * len(ids) + [0] * pad)
        ids_all.append(ids + [tokenizer.pad_token_id] * pad)
        if len(ids_all) == batch_size:
            out.append({"caption_ids": np.asarray(ids_all, np.int32),
                        "attention_mask": np.asarray(mask_all, np.int32)})
            ids_all, mask_all = [], []
    return out


def lm_loss_fn(cfg):
    """Causal-LM loss of caption ids under GPT-2 (``cfg``): positions are
    ``cumsum(mask) - 1`` clamped at 0, pads are ignored."""
    import torch

    from video_caption_tpu_torch.models import gpt2 as g2

    def loss_fn(p, batch):
        ids, mask = batch["caption_ids"], batch["attention_mask"]
        positions = (torch.cumsum(mask, dim=1) - 1).clamp(min=0)
        logits = g2.gpt2_logits_nocache(p, p["wte"][ids.long()], positions, mask, cfg)
        return g2.lm_loss(logits, torch.where(mask > 0, ids, -100))

    return loss_fn


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    args = parse_args(argv)

    import torch

    from video_caption_tpu_torch.decode.tokenizer import get_tokenizer
    from video_caption_tpu_torch.models import gpt2 as g2
    from video_caption_tpu_torch.training.loop import LoopConfig, run_training
    from video_caption_tpu_torch.training.optim import adamw, warmup_cosine_decay

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available")
    tokenizer = get_tokenizer()
    cfg = g2.GPT2Config()
    params = g2.init_gpt2_params(torch.Generator(device=device).manual_seed(0), cfg, device)
    schedule = warmup_cosine_decay(0.0, args.lr, args.warmup_steps, max(args.max_steps, 1000))
    optimizer = adamw(params, schedule, clip_norm=1.0)

    train = text_batches(args.ann_path, tokenizer, args.batch_size, args.max_len)
    val = text_batches(args.val_ann_path, tokenizer, args.batch_size, args.max_len) \
        if args.val_ann_path else None
    result = run_training(
        params, lm_loss_fn(cfg), optimizer, train, val,
        cfg=LoopConfig(
            epochs=args.epochs, max_steps=args.max_steps, val_every=args.val_every,
            out_dir=args.out_dir, ckpt_path=args.ckpt_path,
        ),
    )
    if result["best_val"] < float("inf"):
        logging.info("val ppl %.2f", math.exp(min(result["best_val"], 20.0)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
