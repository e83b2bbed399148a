"""Stage-1/2 alignment trainer on the PyTorch/CUDA port (counterpart of
video_caption_tpu/cli/train_full.py: the same flags, plus ``--device``).
``--model simple`` trains the toy SimpleAlignModel (models/toy.py),
``--model vit`` the ViT-text dual encoder (models/align.py) jointly, the ViT
included, with ``optax.adamw(lr)``'s settings (training/optim.py::adamw).
Best-val checkpoints carry the optimizer state.

    python -m video_caption_tpu_torch.cli.train_full --model vit --ann_path A.json
"""
from __future__ import annotations

import argparse
import logging


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ann_path", default="data/processed/msvd/train/annotations.json")
    p.add_argument("--val_ann_path", default="")
    p.add_argument("--model", choices=["simple", "vit"], default="simple")
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--num_frame", type=int, default=8)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--max_len", type=int, default=32)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--max_steps", type=int, default=0)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--val_every", type=int, default=200)
    p.add_argument("--out_dir", default="runs/stage1")
    p.add_argument("--ckpt_path", default="checkpoints/align_best")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def align_loss(cfg):
    """The stage-1 joint loss of ``--model vit``: cosine-embedding loss
    (target +1) between the video and caption embeddings of a batch."""
    import torch

    from video_caption_tpu_torch.models import align as al

    def loss_fn(params, batch):
        v = al.encode_video(params, batch["video"], cfg)
        t = al.encode_text(params, batch["caption_ids"], batch["attention_mask"], cfg)
        return al.cosine_embedding_loss(v, t, torch.ones(v.shape[0], device=v.device))

    return loss_fn


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    args = parse_args(argv)

    import torch

    from video_caption_tpu_torch.data import build_dataloader
    from video_caption_tpu_torch.decode.tokenizer import get_tokenizer
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
    val_loader = None
    if args.val_ann_path:
        val_loader = build_dataloader(
            args.val_ann_path, tokenizer, batch_size=args.batch_size,
            max_len=args.max_len, num_frame=args.num_frame,
            image_size=args.image_size, shuffle=False,
        )

    gen = torch.Generator(device=device).manual_seed(0)
    if args.model == "simple":
        from video_caption_tpu_torch.models import toy

        params = toy.init_simple_align(gen, toy.ToyConfig(vocab_size=tokenizer.vocab_size),
                                       device)

        def loss_fn(p, batch):
            return toy.simple_align_loss(p, batch["video"], batch["caption_ids"],
                                         batch["attention_mask"])
    else:
        from video_caption_tpu_torch.models import align as al

        cfg = al.AlignConfig(vocab_size=tokenizer.vocab_size)
        params = al.init_align_params(gen, cfg, device)
        loss_fn = align_loss(cfg)

    def drop_ids(batch):
        return {k: v for k, v in batch.items() if k != "video_id"}

    result = run_training(
        params, loss_fn, adamw(params, args.lr), loader, val_loader,
        cfg=LoopConfig(
            epochs=args.epochs, max_steps=args.max_steps, val_every=args.val_every,
            out_dir=args.out_dir, ckpt_path=args.ckpt_path,
        ),
        batch_transform=drop_ids,
    )
    logging.info("training done: %d steps best_val=%.4f", result["steps"], result["best_val"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
