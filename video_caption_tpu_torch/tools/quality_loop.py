"""Closed quality loop: synthetic-but-learnable data -> staged training ->
checkpoint -> the eval stack with real numbers (counterpart of
video_caption_tpu/tools/quality_loop.py).

No pretrained weights are reachable here, so the reference's MSVD quality
pipeline cannot produce its BLEU values; this module runs the same
train -> eval machinery end to end on a deterministic synthetic captioning
dataset instead:

1. dataset: K visual classes (a colored shape moving in a direction), each
   rendered as distinct frame dirs plus an MSVD-format ``annotations.json``
   (train/val splits with unseen instances in val); the renderer is the
   JAX module's own, so one seed gives the same JPEGs in both packages;
2. stage 3 (reference: src/cli/train_decoder_only.py): LM-tune GPT-2 on the
   caption corpus until the tiny caption language is learned;
3. mapper stage (reference: src/cli/train_caption_mapper.py): ViT frozen,
   GPT-2 frozen but for its last blocks, proj + prefix mapper trained so the
   visual prefix selects the right caption; best-val checkpoint directory
   (training/checkpoint.py), which the engine serves as it is;
4. eval stack (reference: scripts/eval_compare.py, ablate_decode.py,
   eval_retrieval.py): BLEU A/B of the trained checkpoint against random
   init, the decode-ablation grid, and text->video retrieval Recall@K/MRR
   with a stage-1-style align model (trained against random).

Every stage runs on the card unless ``--device cpu`` is given, through the
port's kernels: encoder_attention in every ViT (forward, and backward in
the align stage), prefix_projector in the mapper stage (forward and
backward), fused_pool in the align model's per-frame gap mean, lm_head and
beam_attention in the evaluation's decodes.

Unlike the JAX module, a failure of the retrieval phase fails ``main``: the
JAX module catches any exception there (its TPU ran out of memory in that
phase) and still exits 0 with ``retrieval`` null.

Run (production geometry, ViT-B/16 at 224 px and GPT-2 124M, one card):
    python -m video_caption_tpu_torch.tools.quality_loop --root /tmp/qloop
Files under ``--out_dir`` (default ``reports/torch/quality_loop``; the JAX
module's ``reports/quality_loop`` holds its own results): ``eval_compare/``,
``ablate_decode.csv``, ``retrieval.csv``, ``quality_loop.json`` (with each
stage's seconds beside the JAX module's keys) and the mapper's
``ckpt_mapper/`` and ``runs_mapper/``.
"""
from __future__ import annotations

import argparse
import csv
import json
import logging
import os
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger(__name__)

ABLATE_GRID = {
    "num_beams": (1, 3, 5),
    "temperature": (0.8, 1.0),
    "top_p": (0.9,),
    "no_repeat_ngram_size": (3,),
}
TEMPERATURE = 0.07   # the align stage's InfoNCE temperature
ALIGN_TEXT_LEN = 16


def _tree_clone(tree):
    return {k: _tree_clone(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in tree.items()}


COLORS = {
    "red": (210, 40, 40), "green": (40, 200, 60), "blue": (40, 70, 220),
    "yellow": (220, 210, 50), "purple": (160, 60, 200), "white": (235, 235, 235),
}
SHAPES = ("square", "ball")
MOTIONS = {"left": (-1, 0), "right": (1, 0), "up": (0, -1), "down": (0, 1)}


SIZE_WORDS = {"small": 11, "big": 5}   # divisor of image_size for the radius


def class_caption(color: str, shape: str, motion: str,
                  size_word: str = "") -> List[str]:
    """Two reference paraphrases per class — corpus BLEU gets multi-reference
    support and the language stops being a single memorizable template
    (VERDICT r3 #7: 'a harder synthetic language')."""
    sz = f"{size_word} " if size_word else ""
    return [
        f"a {sz}{color} {shape} moves {motion}",
        f"the {sz}{color} {shape} is moving {motion}",
    ]


def _render_frame(size: int, color, shape: str, cx: float, cy: float,
                  rng: np.random.RandomState, r: int = 0) -> np.ndarray:
    img = rng.randint(16, 48, (size, size, 3)).astype(np.uint8)   # noise background
    r = r or size // 7
    y, x = np.ogrid[:size, :size]
    if shape == "ball":
        mask = (x - cx) ** 2 + (y - cy) ** 2 <= r * r
    else:
        mask = (np.abs(x - cx) <= r) & (np.abs(y - cy) <= r)
    img[mask] = color
    return img


def make_synthetic_dataset(
    root: str, num_frames: int = 8, image_size: int = 224,
    train_per_class: int = 4, val_per_class: int = 2, seed: int = 0,
    colors: int = 4, shapes: int = 2, motions: int = 2, sizes: int = 1,
) -> Dict[str, str]:
    """Render the dataset; returns {"train": ann_path, "val": ann_path}.

    ``sizes`` > 1 adds object size as a fourth class factor (small/big,
    rendered as distinct radii and captioned with a size word). The round-4
    quality-loop scale is colors=6 x shapes=2 x motions=4 x sizes=2 = 96
    classes (>=128 val clips at val_per_class=2 — VERDICT r3 #7)."""
    from PIL import Image

    size_words = list(SIZE_WORDS) if sizes > 1 else [""]
    classes = [
        (c, s, m, sw)
        for c in list(COLORS)[:colors]
        for s in SHAPES[:shapes]
        for m in list(MOTIONS)[:motions]
        for sw in size_words[:max(sizes, 1)]
    ]
    rng = np.random.RandomState(seed)
    out = {}
    rootp = Path(root)
    for split, per_class in (("train", train_per_class), ("val", val_per_class)):
        records = []
        for ci, (color, shape, motion, sw) in enumerate(classes):
            for inst in range(per_class):
                vid = f"{split}_{color}_{shape}_{motion}_{sw or 'mid'}_{inst}"
                d = rootp / split / "frames" / vid
                d.mkdir(parents=True, exist_ok=True)
                dx, dy = MOTIONS[motion]
                margin = image_size // 5
                span = image_size - 2 * margin
                # instance-varying start, class-consistent trajectory
                cx = margin + rng.randint(0, span // 3) + (span // 3 if dx < 0 else 0)
                cy = margin + rng.randint(0, span // 3) + (span // 3 if dy < 0 else 0)
                step = span // (2 * num_frames)
                radius = image_size // SIZE_WORDS[sw] if sw else 0
                for f in range(num_frames):
                    img = _render_frame(
                        image_size, COLORS[color], shape,
                        cx + dx * step * f * 2, cy + dy * step * f * 2, rng,
                        r=radius)
                    Image.fromarray(img).save(d / f"frame_{f:05d}.jpg", quality=95)
                records.append({
                    "video_id": vid, "split": split,
                    "captions": class_caption(color, shape, motion, sw),
                    "num_frames": num_frames, "frames_dir": str(d),
                })
        ann = rootp / split / "annotations.json"
        ann.write_text(json.dumps(records, indent=1), encoding="utf-8")
        out[split] = str(ann)
    log.info("synthetic dataset: %d classes, %s", len(classes),
             {k: len(json.loads(Path(v).read_text())) for k, v in out.items()})
    return out


def train_stage3_lm(params, gcfg, captions: List[str], tokenizer,
                    max_steps: int = 500, batch_size: int = 16,
                    max_len: int = 24, lr: float = 3e-4,
                    target_loss: float = 0.05):
    """In-process stage-3 LM tune (train_decoder_only semantics): teach the
    randomly initialized GPT-2 the caption corpus with
    ``clip_by_global_norm(1.0)`` then ``adamw(lr)`` at optax's weight decay
    (1e-4), the batches drawn by ``np.random.RandomState(1)`` as in the JAX
    module. ``params`` is not changed. Returns (decoder_params, first_loss,
    last_loss)."""
    import torch

    from video_caption_tpu_torch.models import gpt2 as g2
    from video_caption_tpu_torch.training.loop import sgd_step
    from video_caption_tpu_torch.training.optim import adamw

    ids_all, mask_all = [], []
    for cap in captions:
        ids = tokenizer.encode(cap)[: max_len - 1] + [tokenizer.eos_token_id]
        pad = max_len - len(ids)
        mask_all.append([1] * len(ids) + [0] * pad)
        ids_all.append(ids + [tokenizer.pad_token_id] * pad)
    ids_np = np.asarray(ids_all, np.int64)
    mask_np = np.asarray(mask_all, np.int32)

    def loss_fn(p, batch):
        ids, mask = batch["ids"], batch["mask"]
        embeds = p["wte"][ids]
        positions = (torch.cumsum(mask, dim=1) - 1).clamp(min=0)
        logits = g2.gpt2_logits_nocache(p, embeds, positions, mask, gcfg)
        labels = torch.where(mask > 0, ids, -100)
        return g2.lm_loss(logits, labels)

    params = _tree_clone(params)
    device = params["wte"].device
    optimizer = adamw(params, lr, clip_norm=1.0)
    rng = np.random.RandomState(1)
    first = last = None
    for i in range(max_steps):
        pick = rng.randint(0, len(captions), batch_size)
        batch = {"ids": torch.from_numpy(ids_np[pick]).to(device),
                 "mask": torch.from_numpy(mask_np[pick]).to(device)}
        last = float(sgd_step(params, optimizer, loss_fn, batch))
        if first is None:
            first = last
        if (i + 1) % 50 == 0:
            log.info("stage3 step %d loss %.4f", i + 1, last)
        if last < target_loss:
            log.info("stage3 reached target loss %.4f at step %d", last, i + 1)
            break
    return params, first, last


def train_mapper(model_cfg, params, train_ann: str, val_ann: str, tokenizer, out_dir: Path,
                 max_steps: int, batch_size: int = 8, unfreeze_last_gpt2: int = 2,
                 num_frames: int = 8, image_size: int = 224) -> Tuple[str, Dict]:
    """The mapper stage of ``main``: MapperTrainer (lr 3e-4, the last
    ``unfreeze_last_gpt2`` GPT-2 blocks at 1e-5, validation every 100 steps)
    over the train split cycled until ``max_steps``, best-val checkpoint
    directory ``<out_dir>/ckpt_mapper``. Returns (checkpoint directory,
    the trainer's stats)."""
    from video_caption_tpu_torch.data import build_dataloader
    from video_caption_tpu_torch.training.mapper_trainer import MapperTrainer, TrainArgs

    ckpt_path = str((out_dir / "ckpt_mapper").resolve())
    trainer = MapperTrainer(
        model_cfg, params,
        TrainArgs(
            lr=3e-4, lr_gpt2=1e-5, unfreeze_last_gpt2=unfreeze_last_gpt2,
            epochs=1000, max_steps=max_steps, val_every=100,
            out_dir=str(out_dir / "runs_mapper"), ckpt_path=ckpt_path,
        ),
    )
    loader = build_dataloader(
        train_ann, tokenizer, batch_size=batch_size, max_len=24,
        num_frame=num_frames, image_size=image_size, num_workers=1,
        uint8_pixels=True)
    val_loader = build_dataloader(
        val_ann, tokenizer, batch_size=batch_size, max_len=24,
        num_frame=num_frames, image_size=image_size, shuffle=False)

    def strip(b):
        return {k: v for k, v in b.items() if k != "video_id"}

    def cycle():
        while True:
            for b in loader:
                yield strip(b)

    stats = trainer.fit(cycle(), [strip(b) for b in val_loader])
    log.info("mapper training: %s", stats)
    return ckpt_path, stats


def _texts(tokenizer, captions: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    ids = np.zeros((len(captions), ALIGN_TEXT_LEN), np.int64)
    mask = np.zeros((len(captions), ALIGN_TEXT_LEN), np.int32)
    for i, cap in enumerate(captions):
        t = tokenizer.encode(cap)[:ALIGN_TEXT_LEN]
        ids[i, :len(t)] = t
        mask[i, :len(t)] = 1
    return ids, mask


def _videos(records, num_frames: int, image_size: int) -> np.ndarray:
    """[N, T, 3, H, W] f32, ImageNet-normalized."""
    from video_caption_tpu_torch.preprocessing.frame_loader import load_video_array

    return np.stack([
        load_video_array(r["frames_dir"], num_frames, image_size) for r in records
    ])[:, 0]


def info_nce(v, t):
    """Symmetric in-batch InfoNCE over L2-normalized video and text
    embeddings, pairs on the diagonal, at temperature 0.07. The reference's
    pairwise cosine-embedding loss with one rolled negative degenerates on
    templated synthetic captions (flat at 1.0 while the embeddings
    collapse); the softmax over all pairs does not."""
    import torch
    import torch.nn.functional as F

    logits = (v @ t.T) / TEMPERATURE
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels)) / 2


def align_steps(cfg, params, videos, ids, mask, max_steps: int, lr: float = 1e-3,
                batch_size: int = 96, pick_seed: int = 7, log_every: int = 25):
    """``max_steps`` Adam steps of ``info_nce`` on a copy of ``params``
    (``params`` is not changed). ``videos`` [N,T,3,H,W], ``ids`` and ``mask``
    [N,L] are the whole split on the parameters' device; each step takes
    ``min(batch_size, N)`` records without replacement, drawn from a
    ``torch.Generator`` seeded with ``pick_seed`` (the JAX module draws with
    ``jax.random.choice``, which torch cannot reproduce; at a batch of every
    record the pick is a permutation, under which the loss and its gradient
    do not change). Returns (trained params, losses)."""
    import torch

    from video_caption_tpu_torch.models import align
    from video_caption_tpu_torch.training.loop import sgd_step
    from video_caption_tpu_torch.training.optim import adam

    params = _tree_clone(params)
    optimizer = adam(params, lr)
    n_rec = videos.shape[0]
    bs = min(batch_size, n_rec)
    gen = torch.Generator().manual_seed(pick_seed)

    def loss_fn(q, batch):
        v = align.encode_video(q, batch["videos"], cfg)
        t = align.encode_text(q, batch["ids"], batch["mask"], cfg)
        return info_nce(v, t)

    losses = []
    for i in range(max_steps):
        pick = torch.randperm(n_rec, generator=gen)[:bs].to(videos.device)
        batch = {"videos": videos[pick], "ids": ids[pick], "mask": mask[pick]}
        losses.append(float(sgd_step(params, optimizer, loss_fn, batch)))
        if (i + 1) % log_every == 0:
            log.info("align step %d loss %.4f", i + 1, losses[-1])
    return params, losses


def align_setup(ann_path: str, num_frames: int, image_size: int, seed: int = 0,
                temporal_mode: str = "diff", device: str = "cuda"):
    """The align stage's inputs, the JAX module's configuration: a ViT at the
    frames' size with GAP pooling, f32 and remat, ``temporal_mode="diff"``
    (the temporal mean beside last-minus-first, so the direction of motion
    is separable), its seeded init, and the split's videos, caption ids and
    mask on ``device``. Returns (cfg, params0, tokenizer, videos, ids, mask)."""
    import torch

    from video_caption_tpu_torch.decode.tokenizer import get_tokenizer
    from video_caption_tpu_torch.models import align
    from video_caption_tpu_torch.models import vit as vt

    tokenizer = get_tokenizer()
    records = json.loads(Path(ann_path).read_text(encoding="utf-8"))
    cfg = align.AlignConfig(vit=vt.ViTConfig(
        image_size=image_size, dtype=torch.float32, pool="gap", remat=True),
        temporal_mode=temporal_mode)
    params0 = align.init_align_params(torch.Generator(device=device).manual_seed(seed), cfg,
                                      device)
    ids, mask = _texts(tokenizer, [r["captions"][0] for r in records])
    return (cfg, params0, tokenizer,
            torch.from_numpy(_videos(records, num_frames, image_size)).to(device),
            torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device))


def train_align(ann_path: str, num_frames: int, image_size: int,
                max_steps: int = 300, lr: float = 1e-3, seed: int = 0,
                log_every: int = 25, temporal_mode: str = "diff",
                batch_size: int = 96, device: str = "cuda"):
    """Stage-1-style dual-encoder training (reference ViTTextAlignModel,
    src/models/vit_text_align.py) on the synthetic pairs (``align_setup``),
    Adam on ``info_nce``. At random init a cls-pooled bf16 ViT maps every
    video to nearly the same vector, below the bf16 noise floor; GAP over
    patch tokens in f32 keeps the input signal. Returns (cfg,
    trained_params, random_params, tokenizer, losses): the JAX module's four
    values, then the loss of every step."""
    cfg, params0, tokenizer, videos, ids, mask = align_setup(
        ann_path, num_frames, image_size, seed, temporal_mode, device)
    params, losses = align_steps(cfg, params0, videos, ids, mask, max_steps, lr, batch_size,
                                 log_every=log_every)
    return cfg, params, params0, tokenizer, losses


def eval_align_retrieval(cfg, params, ann_path: str, num_frames: int,
                         image_size: int, tokenizer,
                         one_per_class: bool = False,
                         all_captions: bool = False) -> Dict[str, float]:
    """Text->video retrieval on a split, on the parameters' device: encode
    videos into the index and each video's caption as the query (reference
    eval_retrieval.py:33-52).

    ``one_per_class`` keeps one video per synthetic class in the index:
    duplicate-class videos are indistinguishable targets for a templated
    caption query, capping Recall@1 far below 1 regardless of model quality.
    ``all_captions`` queries every reference paraphrase (each one must
    retrieve its record's video), giving >=2x the query count."""
    import torch

    from video_caption_tpu_torch.models import align
    from video_caption_tpu_torch.retrieval.eval_retrieval import evaluate_retrieval
    from video_caption_tpu_torch.retrieval.index import VectorIndex

    records = json.loads(Path(ann_path).read_text(encoding="utf-8"))
    if one_per_class:
        seen, kept = set(), []
        for r in records:
            klass = r["video_id"].rsplit("_", 1)[0]
            if klass not in seen:
                seen.add(klass)
                kept.append(r)
        records = kept
    device = params["video_proj"]["w"].device
    queries = [
        (cap, r["video_id"])
        for r in records
        for cap in (r["captions"] if all_captions else r["captions"][:1])
    ]
    ids, mask = _texts(tokenizer, [cap for cap, _ in queries])
    with torch.inference_mode():
        videos = torch.from_numpy(_videos(records, num_frames, image_size)).to(device)
        vfeat = align.encode_video(params, videos, cfg).float().cpu().numpy()
        tfeat = align.encode_text(params, torch.from_numpy(ids).to(device),
                                  torch.from_numpy(mask).to(device), cfg).float().cpu().numpy()
    index = VectorIndex(vfeat.shape[1])
    index.add(vfeat)
    rec_ids = [r["video_id"] for r in records]
    return evaluate_retrieval(tfeat, [q[1] for q in queries], index, rec_ids)


def _first_last(events: Path) -> Dict[str, Optional[float]]:
    with events.open() as fh:
        losses = [float(r["loss"]) for r in csv.DictReader(fh)]
    return {"first": losses[0] if losses else None, "last": losses[-1] if losses else None}


def main(argv=None, ablate_grid: Optional[Dict[str, Sequence]] = None) -> int:
    """The loop. ``ablate_grid`` replaces the decode-ablation grid (beams
    1, 3, 5 x T 0.8, 1.0 x top_p 0.9 x n-gram 3)."""
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=os.path.join(tempfile.gettempdir(), "quality_loop_data"))
    p.add_argument("--out_dir", default="reports/torch/quality_loop")
    p.add_argument("--num_frames", type=int, default=8)
    p.add_argument("--image_size", type=int, default=224)
    # 6x2x4x2 = 96 classes, 192 val clips
    p.add_argument("--colors", type=int, default=6)
    p.add_argument("--shapes", type=int, default=2)
    p.add_argument("--motions", type=int, default=4)
    p.add_argument("--sizes", type=int, default=2)
    p.add_argument("--train_per_class", type=int, default=3)
    p.add_argument("--val_per_class", type=int, default=2)
    p.add_argument("--stage3_steps", type=int, default=700)
    p.add_argument("--mapper_steps", type=int, default=1500)
    p.add_argument("--mapper_bs", type=int, default=8)
    p.add_argument("--unfreeze_last_gpt2", type=int, default=2,
                   help="GPT-2 tail blocks trained at lr_gpt2 in the mapper "
                        "stage (reference --unfreeze option)")
    p.add_argument("--align_steps", type=int, default=300)
    p.add_argument("--eval_limit", type=int, default=0)
    p.add_argument("--skip_ablate", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    t0 = time.time()

    import torch

    from video_caption_tpu_torch.config import default_inference_config
    from video_caption_tpu_torch.decode.tokenizer import get_tokenizer
    from video_caption_tpu_torch.engine import model_config_from_inference
    from video_caption_tpu_torch.env import nvidia_smi
    from video_caption_tpu_torch.eval import eval_compare
    from video_caption_tpu_torch.eval.ablate_decode import ablate
    from video_caption_tpu_torch.models import caption_model as cm

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available")
    stage_s: Dict[str, float] = {}

    def lap(name: str, since: float) -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.time()
        stage_s[name] = now - since
        return now

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    anns = make_synthetic_dataset(
        args.root, num_frames=args.num_frames, image_size=args.image_size,
        colors=args.colors, shapes=args.shapes, motions=args.motions,
        sizes=args.sizes, train_per_class=args.train_per_class,
        val_per_class=args.val_per_class)
    train_records = json.loads(Path(anns["train"]).read_text())
    captions = sorted({c for r in train_records for c in r["captions"]})
    tokenizer = get_tokenizer()
    t = lap("dataset", t0)

    inf_cfg = default_inference_config(
        ckpt=str(out_dir / "none.pt"), num_frames=args.num_frames,
        image_size=args.image_size)
    model_cfg = model_config_from_inference(inf_cfg)
    params = cm.init_caption_model(0, model_cfg, device)

    # ---- stage 3: decoder learns the caption language --------------------
    dec, lm_first, lm_last = train_stage3_lm(
        params["decoder"], model_cfg.gpt2, captions, tokenizer,
        max_steps=args.stage3_steps)
    params = {**params, "decoder": dec}
    log.info("stage3 LM loss %.3f -> %.3f over <=%d steps",
             lm_first, lm_last, args.stage3_steps)
    t = lap("stage3", t)

    # ---- mapper stage: prefix selects the caption ------------------------
    ckpt_path, stats = train_mapper(
        model_cfg, params, anns["train"], anns["val"], tokenizer, out_dir,
        args.mapper_steps, args.mapper_bs, args.unfreeze_last_gpt2,
        args.num_frames, args.image_size)
    t = lap("mapper", t)

    # ---- eval 1: BLEU A/B trained vs random (eval_compare) ---------------
    eval_compare.main([
        "--ann_path", anns["val"], "--ckpt_a", ckpt_path, "--ckpt_b", "",
        "--out_dir", str(out_dir / "eval_compare"),
        "--limit", str(args.eval_limit), "--num_frames", str(args.num_frames),
        "--image_size", str(args.image_size), "--device", args.device,
    ])
    summary = (out_dir / "eval_compare" / "summary.txt").read_text()
    log.info("eval_compare summary:\n%s", summary)
    t = lap("eval_compare", t)

    # ---- eval 2: decode-ablation grid on the trained ckpt ----------------
    ablate_rows = []
    if not args.skip_ablate:
        ablate_rows = ablate(
            anns["val"], str(out_dir / "ablate_decode.csv"), ckpt=ckpt_path,
            limit=args.eval_limit or 16, num_frames=args.num_frames,
            grid=ablate_grid or ABLATE_GRID, image_size=args.image_size,
            device=args.device)
    t = lap("ablate", t)

    # ---- eval 3: retrieval Recall@K/MRR, trained vs random align ---------
    acfg, atrained, arandom, tok, align_losses = train_align(
        anns["train"], args.num_frames, args.image_size,
        max_steps=args.align_steps, device=args.device)
    t = lap("align", t)
    ret_trained = eval_align_retrieval(
        acfg, atrained, anns["val"], args.num_frames, args.image_size, tok,
        one_per_class=True, all_captions=True)
    ret_random = eval_align_retrieval(
        acfg, arandom, anns["val"], args.num_frames, args.image_size, tok,
        one_per_class=True, all_captions=True)
    ret_csv = out_dir / "retrieval.csv"
    with ret_csv.open("w") as fh:
        fh.write("model,recall@1,recall@5,mrr,num_queries\n")
        for name, m in (("trained", ret_trained), ("random", ret_random)):
            fh.write(f"{name},{m['recall@1']:.4f},{m['recall@5']:.4f},"
                     f"{m['mrr']:.4f},{m['num_queries']}\n")
    log.info("retrieval trained=%s random=%s", ret_trained, ret_random)
    lap("retrieval", t)

    result = {
        "wall_s": round(time.time() - t0, 1),
        "stage3_lm_loss": {"first": lm_first, "last": lm_last},
        "mapper": stats,
        "eval_compare_summary": summary,
        "ablate_top": ablate_rows[:3],
        "retrieval": {"trained": ret_trained, "random": ret_random},
        "device": nvidia_smi() if device.type == "cuda" else "cpu",
        "stage_s": stage_s,
        "mapper_loss": _first_last(out_dir / "runs_mapper" / "events.csv"),
        "align_loss": {"first": align_losses[0] if align_losses else None,
                       "last": align_losses[-1] if align_losses else None},
    }
    (out_dir / "quality_loop.json").write_text(json.dumps(result, indent=1))
    log.info("quality loop done in %.1fs -> %s", result["wall_s"], out_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
