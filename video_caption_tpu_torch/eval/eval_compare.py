"""A/B BLEU comparison of two model configurations (counterpart of
video_caption_tpu/eval/eval_compare.py; reference: scripts/eval_compare.py):
each side is a checkpoint decoded with the shared policy over an annotation
split; writes per-sample sentence BLEU-1 rows (results.csv) and the corpus
BLEU summary (summary.txt), with the JAX module's columns.

Shared decode defaults match the reference (:127-133): beams=5, T=0.8,
top_p=0.9, ngram=3, repetition=1.15, 32 max tokens.

    python -m video_caption_tpu_torch.eval.eval_compare --ann_path ann.json \\
        --ckpt_a a.pt --ckpt_b b.pt [--device cuda]

The engines run on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import csv
import json
import logging
from pathlib import Path
from typing import Dict, List, Optional, Sequence

log = logging.getLogger(__name__)

SHARED_DECODE = dict(
    num_beams=5, temperature=0.8, top_p=0.9, no_repeat_ngram_size=3,
    repetition_penalty=1.15, max_new_tokens=32,
)


def make_engine(ckpt: str, num_frames: int, image_size: int, device: str):
    """An engine of the default configuration over ``ckpt`` (seeded random
    weights where it is absent or empty)."""
    from video_caption_tpu_torch.config import default_inference_config
    from video_caption_tpu_torch.engine import InferenceEngine

    overrides = {"num_frames": num_frames, "image_size": image_size}
    if ckpt:
        overrides["ckpt"] = ckpt
    return InferenceEngine(default_inference_config(**overrides), device=device)


def caption_split(
    ann_path: str, ckpt: str, limit: int = 0, num_frames: int = 8,
    decode_kwargs: Optional[Dict] = None, engine=None, image_size: int = 224,
    device: str = "cuda",
) -> List[Dict]:
    """Per-record captioning of one model configuration (``engine``, or one
    built over ``ckpt`` on ``device``); returns [{"video_id", "hyp",
    "refs"}]."""
    import torch

    from video_caption_tpu_torch.preprocessing.frame_loader import list_frames, load_video_array

    decode_kwargs = dict(decode_kwargs or SHARED_DECODE)
    if engine is None:
        engine = make_engine(ckpt, num_frames, image_size, device)
    records = json.loads(Path(ann_path).read_text(encoding="utf-8"))
    rows = []
    for rec in records:
        if limit and len(rows) >= limit:
            break
        frames_dir = rec.get("frames_dir", "")
        if not frames_dir or not list_frames(frames_dir):
            continue
        video = torch.from_numpy(load_video_array(frames_dir, engine.config.num_frames,
                                                  engine.config.image_size)).to(engine.device)
        prefix = engine.compute_prefix(video)
        hyp = engine.generate_once(prefix, "", **decode_kwargs)
        refs = rec.get("captions") or [rec.get("caption", "")]
        rows.append({"video_id": rec.get("video_id", ""), "hyp": hyp, "refs": refs})
    return rows


def compare(
    ann_path: str, ckpt_a: str, ckpt_b: str, out_dir: str,
    limit: int = 0, num_frames: int = 8, image_size: int = 224,
    device: str = "cuda", engines: Optional[Sequence] = None,
) -> Dict:
    """Caption the split with both sides and write results.csv and
    summary.txt; ``engines`` (A, B) replaces the engines built over the
    checkpoints."""
    from video_caption_tpu_torch.eval.bleu import corpus_bleu, sentence_bleu1

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    engines = engines or (None, None)
    sides = {}
    for tag, ckpt, engine in (("A", ckpt_a, engines[0]), ("B", ckpt_b, engines[1])):
        rows = caption_split(ann_path, ckpt, limit, num_frames, engine=engine,
                             image_size=image_size, device=device)
        sides[tag] = rows
        log.info("side %s: %d captions", tag, len(rows))

    with (out / "results.csv").open("w", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow(["video_id", "hyp_a", "hyp_b", "bleu1_a", "bleu1_b", "ref0"])
        for ra, rb in zip(sides["A"], sides["B"]):
            writer.writerow([
                ra["video_id"], ra["hyp"], rb["hyp"],
                round(sentence_bleu1(ra["hyp"], ra["refs"]), 2),
                round(sentence_bleu1(rb["hyp"], rb["refs"]), 2),
                ra["refs"][0],
            ])

    summary = {
        "corpus_bleu_a": corpus_bleu([r["hyp"] for r in sides["A"]],
                                     [r["refs"] for r in sides["A"]]) if sides["A"] else 0.0,
        "corpus_bleu_b": corpus_bleu([r["hyp"] for r in sides["B"]],
                                     [r["refs"] for r in sides["B"]]) if sides["B"] else 0.0,
        "num_samples": len(sides["A"]),
        "decode": SHARED_DECODE,
    }
    (out / "summary.txt").write_text(json.dumps(summary, indent=1))
    return summary


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser()
    p.add_argument("--ann_path", required=True)
    p.add_argument("--ckpt_a", default="")
    p.add_argument("--ckpt_b", default="")
    p.add_argument("--out_dir", default="outputs/eval_compare")
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--num_frames", type=int, default=8)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    summary = compare(args.ann_path, args.ckpt_a, args.ckpt_b, args.out_dir,
                      args.limit, args.num_frames, args.image_size, args.device)
    print(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
