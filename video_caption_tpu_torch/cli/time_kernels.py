"""Times of the encoder_attention, lm_head, fused_pool, prefix_projector,
beam_attention, decode_attention and decode_layer wrappers of one checkout
of the port, at the main path's shapes, by this checkout's timer.

    python video_caption_tpu_torch/cli/time_kernels.py [--checkout DIR] [--runs 25] [--only NAME]

The port is imported from DIR (default: the checkout that holds this file),
so two commits can be timed on one card in one call, in turns (parent,
change, change, parent); the timer is always ``ops/selfcheck.median_ms`` of
the checkout that holds this file. Each shape gets four medians of
``--runs`` single calls of the wrapper: ``ms``, the device's time for the
call with its inputs warm in L2 (a spin kernel holds the stream while the
host enqueues it); ``cold_ms``, the same after 256 MB written and read back
(the inputs evicted, L2 clean); ``cold_dirty_ms``, after the write alone
(the call also writes back the flush's dirty lines it evicts);
``launch_ms``, warm without the spin, which holds the host's time to issue
the call wherever that is the longer. fused_pool and prefix_projector also
get a row for one PyTorch call of the same function (``checkout``
"library": ``torch.mean`` over the pooled rows, ``torch.addmm`` on W in
f32), and decode_attention one for SDPA with the same mask, which the port
never calls; a last row times a kernel that spins for one cycle, the floor
of this timer. The inputs are those of
``ops/selfcheck.py``: qkv [N, 197, 2304] from a seeded normal, x [R, 768]
and wte_t [768, 50304] * 0.02 in bf16, tokens [B*T, 197, 768], x [R, 256]
* 0.4 with W [256, 3072] * 0.02 in bf16, and ``selfcheck.beam_attention_case``
(bf16, both modes; the deferred rows only where the checkout's wrapper takes
``k_new``) and ``selfcheck.decode_attention_case`` (bf16, B=1 and 64 over a
64-column cache, B=2 over 300, B=1 over 1024) and ``selfcheck.decode_layer_case``
(a whole step over a 64-row cache at offset 40: B=1 and 8 over 12 layers of
768 in bf16, B=8 in f32, B=1 over one layer, B=3 over 3 layers of 256,
a 20-row cache at offset 19, f32; and B=1 over a 1024-row cache at offset
1000, B=64 over 64 rows, 12 layers in bf16), each with a row of its phases' times
from the kernel's own stamps (``decode_layer.trace_step``, where the
checkout has it). Prints one JSON object per shape,
then the card's name and power limit. Needs an NVIDIA GPU: without one it
exits with an error and times nothing.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

ENCODER = ((16, "bf16"), (128, "bf16"), (32, "bf16"), (32, "f32"))
LM_HEAD_ROWS = (1, 6, 9, 64, 192, 256)
POOL = ((4, 8, "gap", "f32"), (16, 8, "gap", "bf16"), (2, 8, "cls", "bf16"))   # B, T, mode
PROJECTOR_ROWS = (1, 4, 8, 64)
BEAM = ((2, 3, 48, 24, (12, 0, 23)), (1, 4, 48, 40, (20, 0, 39)),   # B, K, S0, N, steps t
        (64, 3, 48, 24, (12,)))
DECODE = ((1, 64), (64, 64), (2, 300), (1, 1024))   # B, L of decode_attention
LAYER = ((1, 12, 768, 64, 40, "bf16"), (8, 12, 768, 64, 40, "bf16"),   # B, layers, H, max_len,
         (8, 12, 768, 64, 40, "f32"), (1, 1, 768, 64, 40, "bf16"),      # offset of decode_layer
         (3, 3, 256, 20, 19, "f32"), (1, 12, 768, 1024, 1000, "bf16"), (64, 12, 768, 64, 40, "bf16"))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkout", default=str(Path(__file__).resolve().parents[2]),
                        help="root of the checkout whose port is timed")
    parser.add_argument("--runs", type=int, default=25)
    parser.add_argument("--only", help="time this kernel's rows alone (and the floor)")
    args = parser.parse_args(argv)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("time_kernels: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from video_caption_tpu_torch.ops.selfcheck import (beam_attention_case,
                                                       decode_attention_case,
                                                       decode_layer_case, median_ms)

    # drop this checkout's port so that the wrappers come from DIR
    for name in [m for m in sys.modules if m.split(".")[0] == "video_caption_tpu_torch"]:
        del sys.modules[name]
    root = Path(args.checkout).resolve()
    sys.path.insert(0, str(root))
    from video_caption_tpu_torch.ops import beam_attention as ba
    from video_caption_tpu_torch.ops import decode_attention as da
    from video_caption_tpu_torch.ops import decode_layer as dl
    from video_caption_tpu_torch.ops import encoder_attention as ea
    from video_caption_tpu_torch.ops import fused_pool as fpl
    from video_caption_tpu_torch.ops import lm_head as lmh
    from video_caption_tpu_torch.ops import prefix_projector as pp

    if not Path(ea.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported the port from {ea.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)

    def report(kernel, shape, fn, checkout=str(root)):
        if args.only and kernel not in (args.only, "launch floor"):
            return
        print(json.dumps({"checkout": checkout, "kernel": kernel, "shape": shape,
                          "ms": median_ms(fn, args.runs),
                          "cold_ms": median_ms(fn, args.runs, cold=True),
                          "cold_dirty_ms": median_ms(fn, args.runs, cold=True, dirty=True),
                          "launch_ms": median_ms(fn, args.runs, hold=False)}), flush=True)

    for frames, kind in ENCODER:
        dtype = torch.bfloat16 if kind == "bf16" else torch.float32
        qkv = torch.randn((frames, 197, 2304), generator=g, device="cuda").to(dtype)
        report("encoder_attention", f"qkv[{frames},197,2304] {kind}",
               lambda: ea.encoder_attention(qkv, 12))
    w = (torch.randn((768, 50304), generator=g, device="cuda") * 0.02).bfloat16()
    for rows in LM_HEAD_ROWS:
        x = torch.randn((rows, 768), generator=g, device="cuda").bfloat16()
        report("lm_head", f"R={rows} bf16", lambda: lmh.lm_head_stats(x, w, 50257))
    for b, t, mode, kind in POOL:
        dtype = torch.bfloat16 if kind == "bf16" else torch.float32
        tokens = torch.randn((b * t, 197, 768), generator=g, device="cuda").to(dtype)
        first = 1 if mode == "gap" else 0
        pooled = tokens.view(b, t, 197, 768)[:, :, first:197 if mode == "gap" else 1]
        shape = f"{mode} tokens[{b * t},197,768] {kind}"
        report("fused_pool", shape, lambda: fpl.fused_pool_temporal(tokens, b, t, mode))
        report("fused_pool", shape, lambda: torch.mean(pooled, dim=(1, 2), dtype=torch.float32),
               "library")
    w = (torch.randn((256, 3072), generator=g, device="cuda") * 0.02).bfloat16()
    bias = (torch.randn((3072,), generator=g, device="cuda") * 0.02).bfloat16()
    w32, b32 = w.float(), bias.float()
    for rows in PROJECTOR_ROWS:
        x = torch.randn((rows, 256), generator=g, device="cuda") * 0.4
        shape = f"x[{rows},256] f32 @ w[256,3072] bf16"
        report("prefix_projector", shape, lambda: pp.prefix_project(x, w, bias))
        report("prefix_projector", shape, lambda: torch.addmm(b32, x, w32), "library")
    modes = (False, True) if "k_new" in inspect.signature(ba.beam_attention).parameters \
        else (False,)
    for videos, beams, prefill, steps, ts in BEAM:
        q, k_new, v_new, gkv, pk, pv, valid, anc = beam_attention_case(
            videos, beams, prefill, steps)
        for t in ts:
            for deferred in modes:
                kw = dict(k_new=k_new, v_new=v_new) if deferred else {}
                report("beam_attention", f"R={videos * beams} (B={videos},K={beams}) S0={prefill} "
                       f"N={steps} t={t} bf16{' deferred' if deferred else ''}",
                       lambda: ba.beam_attention(q, gkv, pk, pv, valid, anc, t, beams, 12, **kw))
    for batch, length in DECODE:
        q, k, v, valid = decode_attention_case(batch, length)
        mask = (valid > 0)[:, None, None, :]
        qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
        shape = f"B={batch} L={length} 12x64 bf16 (strided K/V)"
        report("decode_attention", shape, lambda: da.decode_attention(q, k, v, valid))
        report("decode_attention", shape,
               lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask), "library")
    for batch, layers, h, max_len, offset, kind in LAYER:
        if args.only and args.only != "decode_layer":
            break
        dtype = torch.bfloat16 if kind == "bf16" else torch.float32
        x, kvf, valid, blocks = decode_layer_case(batch, "cuda", layers, h, max_len, offset, dtype)
        shape = f"B={batch} {layers}x{h} max_len={max_len} offset={offset} {kind}"
        report("decode_layer", shape, lambda: dl.gpt2_decode_step(x, kvf, valid, offset, blocks,
                                                                   h // 64))
        if hasattr(dl, "trace_step"):   # the kernel's phase stamps, where the checkout has them
            dl.trace_step(x, kvf, valid, offset, blocks, h // 64)
            print(json.dumps({"checkout": str(root), "kernel": "decode_layer phases (us)",
                              "shape": shape,
                              **dl.trace_step(x, kvf, valid, offset, blocks, h // 64)}),
                  flush=True)
    # the timer's floor: a kernel that spins for one cycle
    report("launch floor", "torch.cuda._sleep(1)", lambda: torch.cuda._sleep(1), "library")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
