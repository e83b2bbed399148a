"""Export a checkpoint to the reference's torch format (counterpart of
video_caption_tpu/tools/export_checkpoint.py).

    python -m video_caption_tpu_torch.tools.export_checkpoint \\
        --ckpt runs/mapper/best --out exported.pt

Accepts either a trainer's checkpoint directory (``model.pt`` and
``train_meta.json``, training/checkpoint.py) or a torch ``.pt``
(re-exported after conversion: legacy ``vit.*`` keys come out as
``encoder.backbone.*``). The output keeps ``step``, ``epoch``,
``best_val`` and ``args`` and loads in the reference stack and in both
packages' ``load_params``. A host tool: the loads run on the CPU.
"""
from __future__ import annotations

import argparse
import logging


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser("Export checkpoint to reference torch format")
    p.add_argument("--ckpt", required=True, help="checkpoint dir or torch .pt")
    p.add_argument("--out", required=True, help="output .pt path")
    p.add_argument("--num_frames", type=int, default=8)
    args = p.parse_args(argv)

    import torch

    from video_caption_tpu_torch.config import default_inference_config
    from video_caption_tpu_torch.engine import load_params, model_config_from_inference
    from video_caption_tpu_torch.models.convert import save_torch_checkpoint
    from video_caption_tpu_torch.training.checkpoint import load_metadata

    config = default_inference_config(ckpt=args.ckpt, num_frames=args.num_frames)
    model_cfg = model_config_from_inference(config)
    params = load_params(config, model_cfg, seed=0, device="cpu")
    if args.ckpt.endswith((".pt", ".pth", ".bin")):
        # torch input: the payload itself carries the training metadata
        # (the reference's train_caption_mapper payload): keep it through
        # the re-export
        raw = torch.load(args.ckpt, map_location="cpu", weights_only=True)
        meta = {k: raw[k] for k in ("step", "epoch", "best_val", "args")
                if isinstance(raw, dict) and k in raw}
    else:
        meta = load_metadata(args.ckpt)
    save_torch_checkpoint(
        args.out, params, model_cfg,
        step=meta.get("step", 0), epoch=meta.get("epoch", 0),
        best_val=meta.get("best_val", float("inf")), args=meta.get("args"),
    )
    print(f"exported {args.ckpt} -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
