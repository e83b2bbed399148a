"""Stage-by-stage tensor-chain debugger and checkpoint inspector
(counterpart of video_caption_tpu/tools/debug_chain.py; reference:
tools/debug_chain.py:48-80 and experiments/inspect_ckpt.py): runs one video
through encoder -> proj -> prefix-norm -> mapper -> first decode logits,
printing shape/dtype/norm at each boundary, and counts a checkpoint's key
families against the ones the model needs.

Usage:
    python -m video_caption_tpu_torch.tools.debug_chain --frames_dir PATH [--ckpt C]
    python -m video_caption_tpu_torch.tools.debug_chain --inspect_ckpt C

The model runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import logging
from typing import Any, Dict

import numpy as np

log = logging.getLogger(__name__)


def _describe(name: str, arr) -> None:
    a = arr.detach().float().cpu().numpy()
    print(f"  {name:<28} shape={str(a.shape):<22} dtype={arr.dtype} "
          f"|mean|={np.abs(a).mean():.4f} norm={np.linalg.norm(a):.3f}")


def run_chain(frames_dir: str, ckpt: str = "", device: str = "cuda") -> Dict[str, Any]:
    """One video through every stage of the model on ``device``; returns
    the encoder output ``emb``, the ``prefix`` embeddings and the first
    decode step's ``logits`` [1, P+1, V]."""
    import torch

    from video_caption_tpu_torch.config import default_inference_config
    from video_caption_tpu_torch.engine import load_params, model_config_from_inference
    from video_caption_tpu_torch.models import caption_model as cm
    from video_caption_tpu_torch.models import gpt2 as g2
    from video_caption_tpu_torch.models import vit as vt
    from video_caption_tpu_torch.ops.prefix_norm import apply_prefix_norm
    from video_caption_tpu_torch.preprocessing.frame_loader import load_video_array

    overrides = {"ckpt": ckpt} if ckpt else {}
    cfg = default_inference_config(**overrides)
    mc = model_config_from_inference(cfg)
    params = load_params(cfg, mc, seed=0, device=device)

    print("== tensor chain ==")
    with torch.inference_mode():
        video = torch.from_numpy(load_video_array(frames_dir, cfg.num_frames,
                                                  cfg.image_size)).to(device)
        _describe("video", video)
        tokens = vt.vit_trunk(params["encoder"], video.reshape((-1,) + video.shape[2:]), mc.vit)
        _describe("vit tokens", tokens)
        emb = cm.encode_video(params, video, mc)
        _describe("encoder output", emb)
        normed = apply_prefix_norm(emb, mc.ln_scale, mc.in_weight)
        _describe("prefix-normed", normed)
        prefix = cm.map_prefix(params, normed, mc)
        _describe("prefix embeds", prefix)
        ids = torch.full((1, 1), 50256, dtype=torch.int64, device=device)
        embeds = cm.build_decoder_inputs(params, prefix, ids, mc)
        positions = torch.arange(embeds.shape[1], device=device).expand(embeds.shape[:2])
        mask = torch.ones(embeds.shape[:2], dtype=torch.int32, device=device)
        logits = g2.gpt2_logits_nocache(params["decoder"], embeds, positions, mask, mc.gpt2)
        _describe("first logits", logits[:, -1])
    top = np.argsort(-logits[0, -1].float().cpu().numpy(), kind="stable")[:5]
    print(f"  top-5 first tokens: {top.tolist()}")
    return {"emb": emb, "prefix": prefix, "logits": logits}


def inspect_ckpt(path: str) -> None:
    """Key-family census of a torch checkpoint (inspect_ckpt.py:8-21)."""
    from video_caption_tpu_torch.models.convert import load_torch_checkpoint

    state = load_torch_checkpoint(path)
    families: Dict[str, int] = {}
    for key in state:
        fam = ".".join(key.split(".")[:2])
        families[fam] = families.get(fam, 0) + 1
    print(f"== {path}: {len(state)} tensors ==")
    for fam, count in sorted(families.items()):
        print(f"  {fam:<32} x{count}")
    expected = ("encoder.backbone", "encoder.proj", "decoder.mapper", "decoder.model")
    for fam in expected:
        present = any(k.startswith(fam) for k in state)
        print(f"  [{'ok' if present else 'MISSING'}] family {fam}")


def debug_three_samples(ann_path: str, ckpt: str = "", device: str = "cuda") -> None:
    """Caption 3 distinct samples and flag identical outputs: catches the
    'fixed input / cached features / hard length caps' failure modes
    (reference: experiments/debug_three_samples.py:4-10)."""
    import json
    from pathlib import Path

    from video_caption_tpu_torch.config import default_inference_config
    from video_caption_tpu_torch.engine import InferenceEngine
    from video_caption_tpu_torch.preprocessing.frame_loader import list_frames

    records = [
        r for r in json.loads(Path(ann_path).read_text(encoding="utf-8"))
        if r.get("frames_dir") and list_frames(r["frames_dir"])
    ][:3]
    if len(records) < 2:
        print("need at least 2 records with frames")
        return
    overrides = {"ckpt": ckpt} if ckpt else {}
    engine = InferenceEngine(default_inference_config(**overrides), device=device)
    outputs = []
    for rec in records:
        res = engine.infer(rec["frames_dir"]).to_api_dict()
        outputs.append(res["BEST"]["text"])
        print(f"{rec['video_id']}: {res['BEST']['text']}")
    if len(set(outputs)) == 1:
        print("WARNING: all samples produced the SAME caption — check for "
              "fixed input / cached features / degenerate decoding")
    else:
        print(f"ok: {len(set(outputs))}/{len(outputs)} distinct captions")


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser()
    p.add_argument("--frames_dir", default="")
    p.add_argument("--ckpt", default="")
    p.add_argument("--inspect_ckpt", default="")
    p.add_argument("--three_samples", default="",
                   help="annotations.json path: caption 3 samples, flag duplicates")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.inspect_ckpt:
        inspect_ckpt(args.inspect_ckpt)
    if args.three_samples:
        debug_three_samples(args.three_samples, args.ckpt, args.device)
    if args.frames_dir:
        run_chain(args.frames_dir, args.ckpt, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
