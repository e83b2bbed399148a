"""Quality-gated hybrid inference with fallback provenance (counterpart of
video_caption_tpu/tools/hybrid_infer.py, the same gate, selection and
provenance, and the same flags plus ``--device``; reference:
experiments/hybrid_infer.py:70-167).

Own model first (the port's ``InferenceEngine``, on the card unless the
caller asks for the CPU); candidates pass through ``is_bad_caption``
(empty / short / url / boilerplate / low alpha ratio / repetition) with
preference S3 > S2 > S1; on failure a pluggable fallback captioner runs and
the result carries a ``USED`` provenance dict {"source", "detail",
"fallback_reason"}. A fallback that raises keeps our result and records
``fallback_failed:<exc>``.

The fallback is a protocol: any ``callable(frames_dir) -> str``.
``tools/caption_fallback.py`` provides the BLIP-backed implementation
where ``transformers`` and its weights are present.

    python -m video_caption_tpu_torch.tools.hybrid_infer --frames_dir DIR \\
        [--use_blip_fallback] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import logging
import re

from typing import Callable, Dict, Optional, Tuple

log = logging.getLogger(__name__)

_URL_RE = re.compile(r"https?://|www\.", re.I)
_BAD_TOKENS = (
    "copyright", "©", "click here", "report abuse",
    "reddit", "youtube", "facebook", "login", "sign up",
)
_WORD_REPEAT_RE = re.compile(r"\b(\w+)(\s+\1){2,}\b", re.I)
_CHAR_REPEAT_RE = re.compile(r"(.)\1{4,}")


def _alpha_ratio(s: str) -> float:
    if not s:
        return 0.0
    return sum(ch.isalpha() for ch in s) / max(1, len(s))


def is_bad_caption(s: str) -> Tuple[bool, str]:
    """(is_bad, reason) — same gate order as the reference (:82-100)."""
    if not s or not s.strip():
        return True, "empty"
    s_strip = s.strip()
    if len(s_strip) < 8:
        return True, "too_short"
    if _URL_RE.search(s_strip):
        return True, "url_like"
    low = s_strip.lower()
    if any(tok in low for tok in _BAD_TOKENS):
        return True, "boilerplate"
    if _alpha_ratio(s_strip) < 0.6:
        return True, "low_alpha_ratio"
    if _WORD_REPEAT_RE.search(s_strip) or _CHAR_REPEAT_RE.search(s_strip):
        return True, "repetition"
    return False, "ok"


def pick_best_from_ours(result: Dict[str, str]) -> Tuple[str, str]:
    """Prefer the most natural non-bad candidate: S3 > S2 > S1 (:102-115)."""
    for key in ("S3", "S2", "S1"):
        bad, _ = is_bad_caption(result.get(key, ""))
        if not bad:
            return key, result[key].strip()
    for key in ("S3", "S2", "S1"):
        text = result.get(key, "").strip()
        if text:
            return key, text
    return "NONE", ""


def hybrid_caption(
    frames_dir: str,
    engine=None,
    fallback: Optional[Callable[[str], str]] = None,
) -> Dict:
    """frames_dir -> {"S1","S2","S3","BEST":{key,text},"USED":{...}}."""
    if engine is None:
        from video_caption_tpu_torch.config import default_inference_config
        from video_caption_tpu_torch.engine import InferenceEngine

        engine = InferenceEngine(default_inference_config())
    ours = engine.infer(frames_dir).to_api_dict()
    key, text = pick_best_from_ours(ours)
    bad, reason = is_bad_caption(text)

    used = {"source": "ours", "detail": key, "fallback_reason": ""}
    if (bad or key == "NONE") and fallback is not None:
        try:
            fb_text = fallback(frames_dir)
            fb_bad, _ = is_bad_caption(fb_text)
            if not fb_bad:
                text = fb_text
                used = {"source": "fallback", "detail": getattr(fallback, "name", "fallback"),
                        "fallback_reason": reason}
        except Exception as exc:  # fallback failure keeps our result (:161-163)
            used["fallback_reason"] = f"fallback_failed:{exc}"

    return {
        "S1": ours.get("S1", ""), "S2": ours.get("S2", ""), "S3": ours.get("S3", ""),
        "BEST": {"key": key, "text": text}, "USED": used,
    }


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser()
    p.add_argument("--frames_dir", required=True)
    p.add_argument("--use_blip_fallback", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from video_caption_tpu_torch.config import default_inference_config
    from video_caption_tpu_torch.engine import InferenceEngine

    engine = InferenceEngine(default_inference_config(), device=args.device)
    fallback = None
    if args.use_blip_fallback:
        from video_caption_tpu_torch.tools.caption_fallback import make_blip_fallback

        fallback = make_blip_fallback(device=args.device)
    print(json.dumps(hybrid_caption(args.frames_dir, engine=engine, fallback=fallback)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
