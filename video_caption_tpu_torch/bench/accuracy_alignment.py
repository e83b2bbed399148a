"""Accuracy alignment between the card and the plain path (counterpart of
video_caption_tpu/bench/accuracy_alignment.py).

The golden path is the port's plain path in f32 on the CPU (every wrapper
takes its kernel's plain version for CPU tensors). The legs under test run
on the engine's device: on the card, through the kernels. The legs, and
the JAX package's leg each one takes the place of:

=====================================  ==========================  =========
leg (this module)                      JAX package's leg           tolerance
=====================================  ==========================  =========
encoder f32 on the device vs CPU f32   encoder jit-fp32 vs eager   rel 1e-3
encoder bf16 on the device vs CPU f32  encoder bf16 vs fp32        rel 5e-2
prefix kernels on the device vs CPU    pallas ops vs XLA           rel 1e-3
decode kernels on the device vs CPU    decode kernels vs XLA       see below
=====================================  ==========================  =========

The decode leg, on the card at production geometry (72 videos x 4 beams =
288 rows: lm_head past R = 256, beam_attention at B = 72), in bf16:

- (a) the logits of one beam step (12 layers and the LM head, half-filled
  caches, a reordered ancestry) against the same step in f32 on the CPU:
  rel <= 3e-2;
- (b) token agreement of a short beam decode on peaked logits: the prefix
  embeddings are optimized (``torch.optim.Adam(lr=0.2)``, the decoder
  frozen) to widen the greedy path's raw-logit margins, the path
  re-derived and widened again, up to 10 rounds or until it is a fixed
  point; then the ids decoded on the card must equal the ids of the same
  decode in f32 on the CPU in >= 0.9 of the videos. The peaked rows must
  be peaked: a share >= 0.995 of the labelled positions has a gap of at
  least 1 nat (the JAX package loosened this floor to 0.98; it is not
  copied). The agreement on the flat random embeddings is informational.
  Both kernels must have launched in the on-card decodes.

Off the card (the tests) the decode leg runs a tiny GPT-2 in f32 on both
sides, where the ids agree exactly and the peakedness floor does not apply
(the tiny geometry cannot reach wide gaps). An error raises: no leg is
turned into a failed entry.

Usage: python -m video_caption_tpu_torch.bench.accuracy_alignment [--image_size 224]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from video_caption_tpu_torch.decode.generate import DecodeParams, generate
from video_caption_tpu_torch.models import caption_model as cm
from video_caption_tpu_torch.models import gpt2 as g2
from video_caption_tpu_torch.models import vit as vt
from video_caption_tpu_torch.ops import beam_attention, lm_head
from video_caption_tpu_torch.ops.prefix_norm import apply_prefix_norm

log = logging.getLogger(__name__)

ENCODER_F32 = "encoder f32 on the device vs CPU f32"
ENCODER_BF16 = "encoder bf16 on the device vs CPU f32"
PREFIX_KERNELS = "prefix kernels on the device vs CPU f32"
DECODE = "decode kernels on the device vs CPU f32"
JAX_LEGS = {ENCODER_F32: "encoder jit-fp32 vs eager", ENCODER_BF16: "encoder bf16 vs fp32",
            PREFIX_KERNELS: "pallas ops vs XLA", DECODE: "decode kernels vs XLA"}
"""Each leg of this module: the JAX package's leg it takes the place of."""

STEP_REL_TOL = 3e-2
AGREEMENT_FLOOR = 0.9
PEAK_FRAC_FLOOR = 0.995
MARGIN_TARGET = 4.0
WIDEN_STEPS = 150
WIDEN_ROUNDS = 10
GATE_VIDEOS = 72        # x 4 beams = 288 rows on the card


@contextlib.contextmanager
def _true_f32():
    """f32 products in f32 on the card: no TF32 in matmuls or convolutions."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _to(tree, device, dtype):
    """A parameter tree on ``device``, its floating leaves in ``dtype``."""
    return {k: _to(v, device, dtype) if isinstance(v, dict)
            else v.to(device=device, dtype=dtype if v.is_floating_point() else v.dtype)
            for k, v in tree.items()}


def path_gaps(dec, e: torch.Tensor, tgt: torch.Tensor, cfg: g2.GPT2Config) -> torch.Tensor:
    """Raw-logit top gap at each forced position of prefix embeddings e
    [B,P,H] followed by the tokens tgt [B,T]: logit[target] minus the best
    other token, [B,T] f32 (teacher forcing, ``gpt2_logits_nocache``)."""
    b, p_len, _ = e.shape
    t_new = tgt.shape[1]
    seq_len = p_len + t_new
    positions = torch.arange(seq_len, device=e.device)[None].expand(b, seq_len)
    ones_mask = torch.ones((b, seq_len), dtype=torch.int32, device=e.device)
    seq = torch.cat([e.to(cfg.dtype), dec["wte"][tgt].to(cfg.dtype)], dim=1)
    logits = g2.gpt2_logits_nocache(dec, seq, positions, ones_mask, cfg)[
        :, p_len - 1:p_len - 1 + t_new, :].float()
    tgt_logit = logits.gather(-1, tgt[..., None])[..., 0]
    others = logits.masked_fill(F.one_hot(tgt, cfg.vocab_size).bool(), float("-inf")).amax(-1)
    return tgt_logit - others


def margin_loss(dec, e: torch.Tensor, tgt: torch.Tensor, lab_mask: torch.Tensor,
                cfg: g2.GPT2Config, margin_target: float = MARGIN_TARGET) -> torch.Tensor:
    """Mean hinge of the gaps below ``margin_target`` over the labelled
    positions."""
    gaps = path_gaps(dec, e, tgt, cfg)
    return (F.relu(margin_target - gaps) * lab_mask).sum() / lab_mask.sum()


def widen(dec, e0: torch.Tensor, tgt: torch.Tensor, lab_mask: torch.Tensor,
          cfg: g2.GPT2Config, steps: int = WIDEN_STEPS) -> torch.Tensor:
    """``steps`` Adam steps (lr 0.2) on the prefix embeddings against
    ``margin_loss``, the decoder frozen; returns the new embeddings."""
    e = e0.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([e], lr=0.2)
    with torch.enable_grad():
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            margin_loss(dec, e, tgt, lab_mask, cfg).backward()
            opt.step()
    return e.detach()


def derive_targets(dec, cfg: g2.GPT2Config, e: torch.Tensor, dp: DecodeParams):
    """The greedy path of e and its label mask (every position up to and
    including the first EOS)."""
    with torch.no_grad():
        ids = generate(dec, cfg, e, dataclasses.replace(dp, num_beams=1))
    is_eos = (ids == dp.eos_id).int()
    lab = (torch.cumsum(is_eos, dim=1) - is_eos) == 0
    return ids, lab.float()


def _beam_step_logits(dec, cfg: g2.GPT2Config, b: int, k: int, device) -> torch.Tensor:
    """Logits [B*K, V] (CPU, f32) of one beam step over half-filled caches
    with a reordered ancestry, the inputs drawn from fixed seeds."""
    r, h, n_layer = b * k, cfg.n_embd, cfg.n_layer

    def randn(seed, *shape, scale):
        x = torch.randn(shape, generator=torch.Generator().manual_seed(seed)) * scale
        return x.to(device=device, dtype=cfg.dtype)

    pkv = {"k": randn(11, n_layer, b, 9, h, scale=0.1), "v": randn(12, n_layer, b, 9, h, scale=0.1)}
    gen = {"kv": randn(13, n_layer, 6, 2, r, h, scale=0.1)}
    anc_np = np.random.RandomState(0).randint(0, k, (r, 6))
    anc = torch.from_numpy((np.arange(r)[:, None] // k * k + anc_np).astype(np.int32)).to(device)
    positions = torch.full((r,), 9, dtype=torch.int64, device=device)
    valid = torch.ones((b, 9), dtype=torch.int32, device=device)
    with torch.no_grad():
        (logits, _, _, _), _ = g2.gpt2_beam_step(dec, randn(14, r, h, scale=0.02), positions, pkv,
                                                 valid, gen, anc, 3, k, cfg,
                                                 g2.lm_head_t(dec, cfg))
    return logits[:, :cfg.vocab_size].float().cpu()


def _decode_leg(dec_cpu, gcfg: g2.GPT2Config, device: torch.device) -> Dict:
    """The decode leg: ``dec_cpu`` the f32 decoder on the CPU; the card's
    side runs it in ``gcfg.dtype``."""
    on_cuda = device.type == "cuda"
    cfg32 = dataclasses.replace(gcfg, dtype=torch.float32)
    dec = _to(dec_cpu, device, gcfg.dtype)
    dp = DecodeParams(max_new_tokens=6, num_beams=4, min_new_tokens=2, eos_id=gcfg.vocab_size - 1)
    videos = GATE_VIDEOS if on_cuda else 2
    emb = torch.randn((videos, 5, gcfg.n_embd), generator=torch.Generator().manual_seed(5)) * 0.02

    # (a) one beam step's logits
    lo_dev = _beam_step_logits(dec, gcfg, videos, dp.num_beams, device)
    lo_cpu = _beam_step_logits(dec_cpu, cfg32, videos, dp.num_beams, "cpu")
    step_rel = float((lo_dev - lo_cpu).abs().max() / (lo_cpu.abs().max() + 1e-9))

    # (b) widen the greedy path's margins until it is a fixed point
    e_peak = emb.to(device)
    tgt, lab_mask = derive_targets(dec, gcfg, e_peak, dp)
    rounds = 0
    for rounds in range(1, WIDEN_ROUNDS + 1):
        e_peak = widen(dec, e_peak, tgt, lab_mask, gcfg)
        new_tgt, new_lab = derive_targets(dec, gcfg, e_peak, dp)
        if torch.equal(new_tgt, tgt):
            break
        tgt, lab_mask = new_tgt, new_lab
    # the gaps of the current greedy path: a loop that did not converge
    # shows as small or negative gaps
    with torch.no_grad():
        gaps = path_gaps(dec, e_peak, tgt, gcfg).cpu()
    labelled = gaps[lab_mask.cpu() > 0]
    peak_frac_wide = float((labelled >= 1.0).float().mean())

    def agreement(e):
        with torch.no_grad():
            ids_dev = generate(dec, gcfg, e.to(device), dp).cpu()
            ids_cpu = generate(dec_cpu, cfg32, e.cpu(), dp)
        return ids_dev, ids_cpu

    before = lm_head.launches, beam_attention.launches
    ids_dev, ids_cpu = agreement(e_peak)
    ids_dev_flat, ids_cpu_flat = agreement(emb)
    launched = lm_head.launches - before[0], beam_attention.launches - before[1]
    agree = float((ids_dev == ids_cpu).all(dim=1).float().mean())
    agree_flat = float((ids_dev_flat == ids_cpu_flat).all(dim=1).float().mean())
    peak_floor = PEAK_FRAC_FLOOR if on_cuda else 0.0
    ok = (step_rel <= STEP_REL_TOL and agree >= AGREEMENT_FLOOR and peak_frac_wide >= peak_floor
          and (not on_cuda or min(launched) > 0))
    out = {
        "ok": ok,
        "step_logits_rel_err": step_rel, "step_rel_tol": STEP_REL_TOL,
        "token_agreement_rate": agree, "agreement_floor": AGREEMENT_FLOOR,
        "peak_frac_gap_ge_1nat": peak_frac_wide, "peak_frac_floor": peak_floor,
        "peak_min_gap_nats": float(labelled.min()),
        "peak_mean_gap_nats": float(labelled.mean()),
        "widening_rounds": rounds,
        "token_agreement_rate_flat_informational": agree_flat,
        "tokens_equal": bool(torch.equal(ids_dev, ids_cpu)),
        "rows": videos * dp.num_beams,
        "lm_head_launches": launched[0],
        "beam_attention_launches": launched[1],
    }
    log.info("%-40s step_rel=%.2e agree=%.3f (flat %.3f, frac_wide %.4f, min_gap %.2f, "
             "mean_gap %.2f, %d rounds, launches lm_head %d beam_attention %d)", DECODE,
             step_rel, agree, agree_flat, peak_frac_wide, out["peak_min_gap_nats"],
             out["peak_mean_gap_nats"], rounds, *launched)
    return out


def check_alignment(image_size: int = 224, num_frames: int = 4, seed: int = 0,
                    only: Optional[str] = None, device="cuda",
                    model_cfg: Optional[cm.CaptionModelConfig] = None) -> Dict:
    """Every leg (``only="encoder"`` or ``"decode"``: one of them) on
    ``device`` against the f32 CPU golden, over seeded random parameters
    of ViT-B/16 + GPT-2 at ``image_size`` (``model_cfg`` another geometry,
    its dtypes ignored). Returns {leg: result, "all_ok": bool}."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA device is available")
    results: Dict[str, Dict] = {}
    base = model_cfg or cm.CaptionModelConfig(vit=vt.ViTConfig(image_size=image_size))
    golden_cfg = dataclasses.replace(
        base, vit=dataclasses.replace(base.vit, dtype=torch.float32),
        gpt2=dataclasses.replace(base.gpt2, dtype=torch.float32))
    bf16_cfg = dataclasses.replace(
        golden_cfg, vit=dataclasses.replace(golden_cfg.vit, dtype=torch.bfloat16),
        gpt2=dataclasses.replace(golden_cfg.gpt2, dtype=torch.bfloat16))
    params = cm.init_caption_model(seed, golden_cfg, "cpu")
    size = golden_cfg.vit.image_size
    video = torch.randn((1, num_frames, 3, size, size), generator=torch.Generator().manual_seed(1))

    def record(name: str, got, ref, tol: float):
        got, ref = got.float().cpu(), ref.float().cpu()
        err = float((got - ref).abs().max())
        rel = err / (float(ref.abs().max()) + 1e-9)
        results[name] = {"max_abs_err": err, "rel_err": rel, "tol": tol, "ok": rel <= tol}
        log.info("%-40s rel_err=%.2e (tol %.0e) %s", name, rel, tol,
                 "OK" if rel <= tol else "FAIL")

    def prefix_of(p, emb, cfg):
        return cm.map_prefix(p, apply_prefix_norm(emb, cfg.ln_scale, cfg.in_weight), cfg)

    with _true_f32(), torch.inference_mode():
        if only in (None, "encoder"):
            golden_emb = cm.encode_video(params, video, golden_cfg)
            golden_prefix = prefix_of(params, golden_emb, golden_cfg)
            dev_video = video.to(device)
            dev_params = _to(params, device, torch.float32)
            emb = cm.encode_video(dev_params, dev_video, golden_cfg)
            record(ENCODER_F32, emb, golden_emb, 1e-3)
            emb_bf16 = cm.encode_video(_to(params, device, torch.bfloat16), dev_video, bf16_cfg)
            record(ENCODER_BF16, emb_bf16, golden_emb, 5e-2)
            record(PREFIX_KERNELS, prefix_of(dev_params, emb, golden_cfg), golden_prefix, 1e-3)

    if only in (None, "decode"):
        with _true_f32():
            if device.type == "cuda":
                gcfg, dec_cpu = bf16_cfg.gpt2, params["decoder"]
            else:
                gcfg = g2.GPT2Config(vocab_size=256, n_embd=128, n_layer=2, n_head=2,
                                     dtype=torch.float32)
                dec_cpu = g2.init_gpt2_params(torch.Generator().manual_seed(9), gcfg, "cpu")
            results[DECODE] = _decode_leg(dec_cpu, gcfg, device)

    results["all_ok"] = all(v["ok"] for v in results.values())
    return results


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser()
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--num_frames", type=int, default=2)
    p.add_argument("--only", choices=("encoder", "decode"), default=None,
                   help="run a single leg; with --merge_into, other legs' "
                        "results are carried over from the existing report")
    p.add_argument("--merge_into", default=None,
                   help="path of an existing report JSON to merge with")
    args = p.parse_args(argv)
    results = check_alignment(args.image_size, args.num_frames, only=args.only)
    if args.merge_into:
        with open(args.merge_into) as fh:
            prior = json.load(fh)
        prior.pop("all_ok", None)
        results = {**prior, **{k: v for k, v in results.items() if k != "all_ok"}}
        results["all_ok"] = all(v["ok"] for v in results.values())
    print(json.dumps(results, indent=1))
    return 0 if results["all_ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
