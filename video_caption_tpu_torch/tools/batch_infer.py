"""Batch inference over an annotation split, in process (counterpart of
video_caption_tpu/tools/batch_infer.py).

The reference shells out ``python -m inference --emit_json`` per video and
scrapes stdout (tools/batch_infer.py:29-73). Here the engine stays
resident: its kernels build and its graphs are captured once, and every
chunk of videos reuses them.

Retry-on-empty parity: a video whose three candidates all clean to "" is
retried once on an engine with the presets safe_sample / safe_sample /
natural (reference :65-73). That engine shares the first one's parameters,
model configuration, tokenizer, device and configuration otherwise (the
JAX tool builds it from the default configuration, whose frame size need
not be the engine's).

Usage:
    python -m video_caption_tpu_torch.tools.batch_infer --ann_path ... --out out.csv \\
        [--device cuda]

The engine runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import logging
import time
from pathlib import Path
from typing import Dict, List, Optional

log = logging.getLogger(__name__)

COLUMNS = ["video_id", "S1", "S2", "S3", "best_key", "best_text", "latency_s", "ref_caption"]


def batch_infer(
    ann_path: str,
    out_csv: str,
    ckpt: str = "",
    num_frames: int = 8,
    limit: int = 0,
    split: Optional[str] = None,
    batch_size: int = 8,
    engine=None,
    device: str = "cuda",
) -> List[Dict]:
    """Caption every record of ``ann_path`` (of ``split`` where given, the
    first ``limit`` where given) with ``engine``, or one built over ``ckpt``
    on ``device``; writes ``out_csv`` and returns its rows."""
    from video_caption_tpu_torch.config import default_inference_config
    from video_caption_tpu_torch.engine import InferenceEngine
    from video_caption_tpu_torch.preprocessing.frame_loader import list_frames

    if engine is None:
        overrides = {"num_frames": num_frames}
        if ckpt:
            overrides["ckpt"] = ckpt
        engine = InferenceEngine(default_inference_config(**overrides), device=device)

    records = json.loads(Path(ann_path).read_text(encoding="utf-8"))
    todo = []
    for rec in records:
        if split and rec.get("split") and rec["split"] != split:
            continue
        if limit and len(todo) >= limit:
            break
        frames_dir = rec.get("frames_dir", "")
        if not frames_dir or not list_frames(frames_dir):
            log.warning("skipping %s: no frames", rec.get("video_id"))
            continue
        todo.append(rec)

    rows: List[Dict] = []
    retry_engine = None
    chunks = [todo[s : s + batch_size] for s in range(0, len(todo), batch_size)]

    def results_pipelined():
        """Double-buffered: dispatch chunk N+1 (host decode, upload and the
        program's enqueue) before collecting chunk N, so host work overlaps
        the device's."""
        pending = None
        for chunk in chunks:
            t0 = time.time()
            handle = engine.infer_batch_dispatch([rec["frames_dir"] for rec in chunk])
            if pending is not None:
                prev_chunk, prev_handle, prev_t0 = pending
                yield prev_chunk, engine.infer_batch_collect(prev_handle), time.time() - prev_t0
            pending = (chunk, handle, t0)
        if pending is not None:
            prev_chunk, prev_handle, prev_t0 = pending
            yield prev_chunk, engine.infer_batch_collect(prev_handle), time.time() - prev_t0

    for chunk, results, elapsed in results_pipelined():
        per_video_s = round(elapsed / max(len(chunk), 1), 3)
        for rec, res in zip(chunk, results):
            result = res.to_api_dict()
            if not any(result[k] for k in ("S1", "S2", "S3")):
                # retry once with changed presets (tools/batch_infer.py:65-73)
                if retry_engine is None:
                    retry_cfg = dataclasses.replace(
                        engine.config, preset1="safe_sample", preset2="safe_sample",
                        preset3="natural",
                    )
                    retry_engine = InferenceEngine(
                        retry_cfg, params=engine.params, model_cfg=engine.model_cfg,
                        device=engine.device,
                    )
                    retry_engine.tokenizer = engine.tokenizer
                result = retry_engine.infer(rec["frames_dir"]).to_api_dict()
            rows.append({
                "video_id": rec.get("video_id", ""),
                "S1": result["S1"], "S2": result["S2"], "S3": result["S3"],
                "best_key": result["BEST"]["key"], "best_text": result["BEST"]["text"],
                "latency_s": per_video_s,
                "ref_caption": (rec.get("captions") or [""])[0],
            })

    out = Path(out_csv)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=COLUMNS)
        writer.writeheader()
        writer.writerows(rows)
    log.info("wrote %d rows to %s", len(rows), out)
    return rows


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser()
    p.add_argument("--ann_path", required=True)
    p.add_argument("--out", default="outputs/batch_infer.csv")
    p.add_argument("--ckpt", default="")
    p.add_argument("--num_frames", type=int, default=8)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--split", default=None)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    batch_infer(args.ann_path, args.out, args.ckpt, args.num_frames, args.limit,
                args.split, args.batch_size, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
