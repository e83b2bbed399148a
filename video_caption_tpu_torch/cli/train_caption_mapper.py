"""Mapper fine-tune CLI on the PyTorch/CUDA port (counterpart of
video_caption_tpu/cli/train_caption_mapper.py: the same flags, plus
``--device``). Freezes ViT + GPT-2, trains the mapper at --lr, optionally
the last N GPT-2 blocks at --lr_gpt2; writes events.csv / val.csv under
--out_dir and the best-val checkpoint as ``<ckpt_path>/model.pt``, a
reference-format file that both packages' engines load.

    python -m video_caption_tpu_torch.cli.train_caption_mapper --ann_path A.json \\
        --val_ann_path V.json --max_steps 100

On several devices, one process per rank under torchrun, a (data, model)
mesh of the world (parallel/mesh.py): --mesh_data 0 takes the world size
over --mesh_model, as the JAX CLI takes all devices; --fsdp shards the
large leaves and their Adam state over the data axis as well:

    torchrun --nproc_per_node 4 -m video_caption_tpu_torch.cli.train_caption_mapper \\
        --ann_path A.json --mesh_data 2 --mesh_model 2 --fsdp

Each rank runs on ``cuda:LOCAL_RANK`` (ranks beyond the cards share them,
over ``--backend gloo``); ``--backend`` names the process group's (nccl on
the card, gloo on the CPU by default).
"""
from __future__ import annotations

import argparse
import logging


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ann_path", default="data/processed/msvd/train/annotations.json")
    p.add_argument("--val_ann_path", default="data/processed/msvd/val/annotations.json")
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--num_frame", type=int, default=8)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--max_len", type=int, default=32)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--max_steps", type=int, default=0)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--lr_gpt2", type=float, default=1e-5)
    p.add_argument("--unfreeze_last_gpt2", type=int, default=0)
    p.add_argument("--val_every", type=int, default=200)
    p.add_argument("--init_ckpt", default="", help="optional reference-format .pt to start from")
    p.add_argument("--out_dir", default="runs/mapper_finetune")
    p.add_argument("--ckpt_path", default="checkpoints/msvd_mapper_finetune")
    p.add_argument("--mesh_data", type=int, default=0,
                   help="0 = the launcher's world size // --mesh_model (one device without one)")
    p.add_argument("--mesh_model", type=int, default=1)
    p.add_argument("--fsdp", action="store_true",
                   help="ZeRO-style weight+optimizer sharding over the data axis")
    p.add_argument("--backend", default=None,
                   help="process group backend (default: nccl on cuda, gloo on cpu)")
    p.add_argument("--u8_pixels", action="store_true",
                   help="ship uint8 pixels; normalize on device (4x less transfer)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    args = parse_args(argv)

    import torch
    import torch.distributed as dist

    from video_caption_tpu_torch.config import MeshConfig, default_inference_config
    from video_caption_tpu_torch.data import build_dataloader
    from video_caption_tpu_torch.decode.tokenizer import get_tokenizer
    from video_caption_tpu_torch.engine import load_params, model_config_from_inference
    from video_caption_tpu_torch.parallel.mesh import init_launched_group, local_cuda_device
    from video_caption_tpu_torch.training.mapper_trainer import MapperTrainer, TrainArgs

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available")
    if device.type == "cuda" and device.index is None:
        device = local_cuda_device()
    world = dist.get_world_size() if init_launched_group(device, args.backend) else 1
    mesh = MeshConfig(data=args.mesh_data or max(world // args.mesh_model, 1),
                      model=args.mesh_model)
    tokenizer = get_tokenizer()
    loader = build_dataloader(
        args.ann_path, tokenizer, batch_size=args.batch_size, max_len=args.max_len,
        num_frame=args.num_frame, image_size=args.image_size, num_workers=1,
        uint8_pixels=args.u8_pixels,
    )
    val_loader = build_dataloader(
        args.val_ann_path, tokenizer, batch_size=args.batch_size, max_len=args.max_len,
        num_frame=args.num_frame, image_size=args.image_size, shuffle=False,
    ) if args.val_ann_path else None

    inf_cfg = default_inference_config(
        num_frames=args.num_frame, image_size=args.image_size,
        **({"ckpt": args.init_ckpt} if args.init_ckpt else {}),
    )
    model_cfg = model_config_from_inference(inf_cfg)
    params = load_params(inf_cfg, model_cfg, seed=0, device=device)

    trainer = MapperTrainer(
        model_cfg, params,
        TrainArgs(
            lr=args.lr, lr_gpt2=args.lr_gpt2, unfreeze_last_gpt2=args.unfreeze_last_gpt2,
            epochs=args.epochs, max_steps=args.max_steps, val_every=args.val_every,
            out_dir=args.out_dir, ckpt_path=args.ckpt_path,
        ),
        mesh=mesh,
        fsdp=args.fsdp,
    )

    def strip(b):
        return {k: v for k, v in b.items() if k != "video_id"}

    stats = trainer.fit(map(strip, loader), [strip(b) for b in val_loader] if val_loader else None)
    logging.info("mapper training done: %s", stats)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
