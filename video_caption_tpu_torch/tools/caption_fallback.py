"""Fallback captioners (counterpart of video_caption_tpu/tools/caption_fallback.py;
reference: tools/caption_fallback_blip.py, tools/caption_fallback_pt.py):
BLIP or vit-gpt2 HF captioners applied to sampled frames with vote/pick-best
selection.

Two reference variants, both reproduced:

- the *batch human-eval tool* (caption_fallback_blip.py): first/middle/last
  frame voting via ``pick_best`` (dedup + prefer complete >=5-word
  sentences), JSON+CSV batch output over a frames root,
- the *serving fallback API* (caption_fallback_pt.py): every sampled frame
  captioned, ``_select_best`` with its own lighter scorer (mu=10 length
  gaussian — deliberately different from the engine ranker's mu=12), BLIP ->
  vit-gpt2 safetensors fallback chain.

The sampling, cleaning and selection are the JAX module's host code. The HF
model loads at the first call and runs on ``device`` (the card unless the
caller asks for the CPU), its inputs moved there. Without ``transformers``
or the weights the captioner raises at that call, and hybrid_infer keeps
the in-house result and records the failure — the same graceful
degradation the reference shows when BLIP fails (hybrid_infer.py:161-163).

    python -m video_caption_tpu_torch.tools.caption_fallback --frames_root R \\
        --output out.json [--model PATH] [--device cuda]
"""
from __future__ import annotations

import argparse
import csv
import json
import logging
import random
import re
from pathlib import Path
from typing import Callable, List, Optional

log = logging.getLogger(__name__)

DEFAULT_BLIP = "Salesforce/blip-image-captioning-base"
DEFAULT_VIT_GPT2 = "nlpconnect/vit-gpt2-image-captioning"


# ---------------------------------------------------------------------------
# frame sampling
# ---------------------------------------------------------------------------

def _sample_three(frames_dir: str) -> List[Path]:
    """First/middle/last frame (caption_fallback_blip.py:69-71 vote set)."""
    from video_caption_tpu_torch.preprocessing.frame_loader import list_frames

    files = list_frames(frames_dir)
    if not files:
        raise FileNotFoundError(f"no frames under {frames_dir}")
    return [files[0], files[len(files) // 2], files[-1]]


def _sample_stride(frames_dir: str, num_frames: int = 8) -> List[Path]:
    """Stride sampling (caption_fallback_pt.py:40-46 _pick_indices)."""
    from video_caption_tpu_torch.preprocessing.frame_loader import list_frames

    files = list_frames(frames_dir)
    if not files:
        raise FileNotFoundError(f"no frames under {frames_dir}")
    if len(files) <= num_frames:
        return list(files)
    step = max(len(files) // num_frames, 1)
    return list(files[::step][:num_frames])


# ---------------------------------------------------------------------------
# cleaning / selection — the two reference variants' own (small) pipelines
# ---------------------------------------------------------------------------

def clean_text_vote(s: str) -> str:
    """Vote-tool cleaner (caption_fallback_blip.py:37-43): strip quotes,
    collapse spaces, ensure terminal period."""
    s = (s or "").strip().strip('"').strip()
    s = " ".join(s.split())
    if s and s[-1] not in ".!?":
        s += "."
    return s


def pick_best(cands: List[str]) -> str:
    """Vote mode (caption_fallback_blip.py:45-58): dedup keeping order, prefer
    complete >=5-word sentences ending in .!?, longest wins."""
    cands = [clean_text_vote(c) for c in cands if c and c.strip()]
    seen, uniq = set(), []
    for c in cands:
        if c not in seen:
            uniq.append(c)
            seen.add(c)
    if not uniq:
        return ""
    full = [c for c in uniq if c[-1] in ".!?" and len(c.split()) >= 5]
    if full:
        return max(full, key=len)
    return max(uniq, key=len)


def _strip_webby(s: str) -> str:
    """Drop web junk outright (caption_fallback_pt.py:80-86)."""
    if re.search(r"(https?://|www\.|<a\b|reddit\.com|pastebin|mailto:)", s, re.I):
        return ""
    if re.match(r"^\s*(©|copyright\b)", s, re.I):
        return ""
    return s


def _dedup_tokens(s: str) -> str:
    s = re.sub(r"(?i)\b(\w+)\b(?:\s+\1\b)+", r"\1", s)
    return re.sub(r"\s{2,}", " ", s).strip()


def _ensure_period_and_caps(s: str) -> str:
    s = (s or "").strip()
    if not s:
        return s
    if s[0].isalpha():
        s = s[0].upper() + s[1:]
    if s and s[-1] not in ".!?":
        s += "."
    return s


def score_sentence_pt(s: str) -> float:
    """The pt-tool's lighter scorer (caption_fallback_pt.py:88-106) —
    mu=10/sigma=4 length gaussian (the engine ranker uses mu=12)."""
    if not s:
        return -1e9
    toks = s.split()
    n = len(toks)
    score = -((n - 10.0) ** 2) / (2 * 4.0 * 4.0)
    if re.search(r"\b\w+ing\b", s):
        score += 0.8
    if re.search(r"\b(?:is|are|was|were)\b", s):
        score += 0.3
    if s.endswith((".", "!", "?")):
        score += 0.2
    if re.search(r"\b(?:[A-Z]\.){2,}\b", s):
        score -= 1.0
    if re.search(r"(?i)\b(click here|subscribe|report abuse)\b", s):
        score -= 1.5
    if n < 4:
        score -= 1.0
    return score


def clean_caption_pt(s: str) -> str:
    return _ensure_period_and_caps(_dedup_tokens(_strip_webby((s or "").strip())))


def select_best_pt(cands: List[str]) -> str:
    """caption_fallback_pt.py:108-112 — clean, drop web junk, best by the
    pt scorer; canned fallback sentence when nothing survives."""
    cands = [clean_caption_pt(x) for x in cands if x and _strip_webby(x) != ""]
    if not cands:
        return "Someone is in the scene."
    return max(cands, key=score_sentence_pt)


# ---------------------------------------------------------------------------
# model backends (HF torch, host-side only)
# ---------------------------------------------------------------------------

_DEFAULT_GEN = dict(num_beams=3, max_new_tokens=30)


def make_blip_fallback(model_name: str = DEFAULT_BLIP,
                       gen_kwargs: Optional[dict] = None,
                       device: str = "cuda") -> Callable[[str], str]:
    """BLIP captioner over first/middle/last frame with vote-mode pick_best
    (reference: caption_fallback_blip.py:60-77), on ``device``."""
    state: dict = {}
    gen = dict(gen_kwargs or _DEFAULT_GEN)

    def fallback(frames_dir: str) -> str:
        if "model" not in state:
            from transformers import BlipForConditionalGeneration, BlipProcessor

            state["processor"] = BlipProcessor.from_pretrained(model_name)
            state["model"] = BlipForConditionalGeneration.from_pretrained(
                model_name, use_safetensors=True
            ).eval().to(device)
        from PIL import Image

        captions = []
        for path in _sample_three(frames_dir):
            with Image.open(path) as img:
                inputs = state["processor"](img.convert("RGB"), return_tensors="pt").to(device)
            out = state["model"].generate(**inputs, **gen)
            captions.append(state["processor"].decode(out[0], skip_special_tokens=True))
        return pick_best(captions)

    fallback.name = model_name
    return fallback


def make_vit_gpt2_fallback(model_name: str = DEFAULT_VIT_GPT2,
                           gen_kwargs: Optional[dict] = None,
                           device: str = "cuda") -> Callable[[str], str]:
    """vit-gpt2 VisionEncoderDecoder captioner — the safetensors-safe variant
    (reference: caption_fallback_pt.py:157-186 _caption_with_vit_gpt2), on
    ``device``."""
    state: dict = {}
    gen = dict(gen_kwargs or _DEFAULT_GEN)

    def fallback(frames_dir: str, num_frames: int = 8) -> str:
        if "model" not in state:
            from transformers import (AutoImageProcessor, AutoTokenizer,
                                      VisionEncoderDecoderModel)

            state["proc"] = AutoImageProcessor.from_pretrained(model_name, use_fast=True)
            state["tok"] = AutoTokenizer.from_pretrained(model_name, use_fast=True)
            state["model"] = VisionEncoderDecoderModel.from_pretrained(
                model_name, use_safetensors=True
            ).eval().to(device)
        from PIL import Image

        captions = []
        for path in _sample_stride(frames_dir, num_frames):
            with Image.open(path) as img:
                pix = state["proc"](images=img.convert("RGB"),
                                    return_tensors="pt").pixel_values.to(device)
            out = state["model"].generate(pix, **gen)
            captions.append(state["tok"].decode(out[0], skip_special_tokens=True))
        return select_best_pt(captions)

    fallback.name = model_name
    return fallback


def caption_from_frames_dir(
    frames_dir: str,
    num_frames: int = 8,
    model: str = DEFAULT_BLIP,
    gen_kwargs: Optional[dict] = None,
    device: str = "cuda",
) -> str:
    """Public fallback API (reference: caption_fallback_pt.py:190-225
    caption_blip_from_frames_dir): BLIP-family names go through BLIP,
    vit-gpt2 through VisionEncoderDecoder; a BLIP ValueError (no safetensors
    / blocked torch.load) falls back to the vit-gpt2 safetensors model."""
    model_l = model.lower()
    try:
        if model_l.startswith("nlpconnect/vit-gpt2-image-captioning"):
            return make_vit_gpt2_fallback(model, gen_kwargs, device)(frames_dir, num_frames)
        return make_blip_fallback(model, gen_kwargs, device)(frames_dir)
    except ValueError:
        log.warning("BLIP load failed (no safetensors?); falling back to %s",
                    DEFAULT_VIT_GPT2)
        return make_vit_gpt2_fallback(DEFAULT_VIT_GPT2, gen_kwargs, device)(frames_dir,
                                                                            num_frames)


# ---------------------------------------------------------------------------
# batch human-eval CLI (reference: caption_fallback_blip.py:98-188)
# ---------------------------------------------------------------------------

def find_video_dirs(root: Path) -> List[Path]:
    return [p for p in sorted(Path(root).iterdir())
            if p.is_dir() and any(p.glob("frame_*.jpg"))]


def run_batch(
    frames_root: str, output: str, model: str = DEFAULT_BLIP,
    num_videos: int = 30, num_frames: int = 8, seed: int = 42,
    emit_csv: bool = False, gen_kwargs: Optional[dict] = None,
    min_words: int = 6, max_words: int = 25,
    captioner: Optional[Callable[[str], str]] = None,
    device: str = "cuda",
) -> List[dict]:
    """Sample videos under ``frames_root``, caption each, write JSON (+CSV).
    ``captioner`` is injectable for tests; defaults to the model dispatch."""
    vids = find_video_dirs(Path(frames_root))
    if not vids:
        raise FileNotFoundError(f"no video frame folders found under {frames_root}")
    random.seed(seed)
    random.shuffle(vids)
    vids = vids[:num_videos]

    results = []
    for vdir in vids:
        try:
            if captioner is not None:
                cap = captioner(str(vdir))
            else:
                cap = caption_from_frames_dir(str(vdir), num_frames, model, gen_kwargs, device)
        except Exception as exc:
            log.warning("captioning failed for %s: %s", vdir.name, exc)
            cap = ""
        wc = len(cap.split())
        if wc == 0:
            log.info("dropping empty caption for %s", vdir.name)
            continue
        if wc < min_words or wc > max_words:
            log.info("caption outside [%d,%d] words for %s (kept)",
                     min_words, max_words, vdir.name)
        results.append({"video_id": vdir.name, "caption": clean_text_vote(cap)})

    outp = Path(output)
    outp.parent.mkdir(parents=True, exist_ok=True)
    outp.write_text(json.dumps(results, ensure_ascii=False, indent=2), encoding="utf-8")
    if emit_csv:
        with open(outp.with_suffix(".csv"), "w", newline="", encoding="utf-8") as f:
            w = csv.writer(f)
            w.writerow(["video_id", "caption"])
            for r in results:
                w.writerow([r["video_id"], r["caption"]])
    return results


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser("Batch caption with BLIP/VED for human eval")
    p.add_argument("--frames_root", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--emit_csv", action="store_true")
    p.add_argument("--model", default=DEFAULT_BLIP)
    p.add_argument("--num_videos", type=int, default=30)
    p.add_argument("--num_frames", type=int, default=8)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--max_new_tokens", type=int, default=30)
    p.add_argument("--num_beams", type=int, default=3)
    p.add_argument("--no_repeat_ngram_size", type=int, default=3)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_p", type=float, default=0.9)
    p.add_argument("--min_words", type=int, default=6)
    p.add_argument("--max_words", type=int, default=25)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    gen = dict(max_new_tokens=args.max_new_tokens, num_beams=args.num_beams,
               no_repeat_ngram_size=args.no_repeat_ngram_size,
               temperature=args.temperature, top_p=args.top_p)
    run_batch(args.frames_root, args.output, args.model, args.num_videos,
              args.num_frames, args.seed, args.emit_csv, gen,
              args.min_words, args.max_words, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
