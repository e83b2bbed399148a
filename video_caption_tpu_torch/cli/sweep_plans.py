"""Device times of the fused_pool, prefix_projector, beam_attention and
decode_attention kernels under every candidate launch geometry, beside the
one their ``plan`` picks.

    python video_caption_tpu_torch/cli/sweep_plans.py [--runs 25] [--only NAME]

fused_pool at the shapes of ``cli/time_kernels.py`` (gap f32 [32,197,768],
gap bf16 [128,197,768], cls bf16 [16,197,768]) under every tile of 4, 8,
16 or 32 column groups and 1, 2, 4 or 8 splits; prefix_projector
x [R, 256] @ W [256, 3072] bf16 at R = 1, 4, 8, 64 under 1, 2, 4 or 8 row
groups; beam_attention (bf16, both modes) at R = 6 (S0 = 48, N = 24, t =
12), R = 4 (N = 40, t = 20 and 39) and R = 192 (64 videos x 3 beams, t =
12), staging all its K/V rows at once (one chunk, the plan) or fewer rows
at a time, in 2, 3 or 4 chunks; decode_attention (bf16, 12 heads) at B=1
and 64 over 64 columns, B=2 over 300, B=1 over 1024, B=64 over 300 and 1024,
split over 1, 2, 4 or 8 blocks of a cluster, each block staging its run in
the fewest equal chunks that fit (96 KB of K and V) and in up to three more.
Each geometry is checked against the plain version, then timed by
``ops/selfcheck.median_ms``: warm L2 (``ms``) and cold (``cold_ms``). Prints
one JSON object per geometry (``"plan": true`` marks the wrapper's choice),
then the card's name and power limit. Needs an NVIDIA GPU: without one it
exits with an error and times nothing.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

POOL = ((4, 8, "gap", "f32"), (16, 8, "gap", "bf16"), (2, 8, "cls", "bf16"))
PROJECTOR_ROWS = (1, 4, 8, 64)
BEAM = ((2, 3, 48, 24, 12), (1, 4, 48, 40, 20), (1, 4, 48, 40, 39), (64, 3, 48, 24, 12))
DECODE = ((1, 64), (64, 64), (2, 300), (1, 1024), (64, 300), (64, 1024))   # B, L


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--runs", type=int, default=25)
    parser.add_argument("--only", help="sweep this kernel's geometries alone")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("sweep_plans: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from video_caption_tpu_torch.ops import beam_attention as ba
    from video_caption_tpu_torch.ops import build
    from video_caption_tpu_torch.ops import decode_attention as da
    from video_caption_tpu_torch.ops import fused_pool as fpl
    from video_caption_tpu_torch.ops import prefix_projector as pp
    from video_caption_tpu_torch.ops.selfcheck import (beam_attention_case,
                                                       decode_attention_case, median_ms)

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)

    def wanted(kernel):
        return args.only in (None, kernel)

    def report(fields, fn, ok):
        fn()
        torch.cuda.synchronize()
        print(json.dumps({**fields, "ok": ok(), "ms": median_ms(fn, args.runs),
                          "cold_ms": median_ms(fn, args.runs, cold=True)}), flush=True)

    for b, t, mode, kind in POOL if wanted("fused_pool") else ():
        dtype = torch.bfloat16 if kind == "bf16" else torch.float32
        tokens = torch.randn((b * t, 197, 768), generator=g, device="cuda").to(dtype)
        want = fpl.fused_pool_ref(tokens, b, t, mode).float()
        out = torch.empty((b, 768), dtype=dtype, device="cuda")
        chosen = fpl.plan(b, t, 197, 768, tokens.element_size(), mode=mode)
        for tile_vecs in (4, 8, 16, 32):
            for splits in (1, 2, 4, 8):
                per_split = -(-chosen.rows // splits)
                if (splits - 1) * per_split >= chosen.rows:
                    continue

                def run(tile_vecs=tile_vecs, splits=splits, per_split=per_split):
                    build.launch("vct_fused_pool", tokens.data_ptr(), out.data_ptr(), b, t, 197,
                                 768, int(mode == "gap"), build.dtype_code(dtype), tile_vecs,
                                 splits, per_split, 1, build.stream_of(tokens))

                report({"kernel": "fused_pool", "shape": f"{mode} tokens[{b * t},197,768] {kind}",
                        "tile_vecs": tile_vecs, "splits": splits,
                        "plan": (tile_vecs, splits) == (chosen.tile_vecs, chosen.splits)},
                       run, lambda: torch.allclose(out.float(), want, atol=1e-2, rtol=1e-2))
    w = (torch.randn((256, 3072), generator=g, device="cuda") * 0.02).bfloat16()
    bias = (torch.randn((3072,), generator=g, device="cuda") * 0.02).bfloat16()
    for rows in PROJECTOR_ROWS if wanted("prefix_projector") else ():
        x = torch.randn((rows, 256), generator=g, device="cuda") * 0.4
        y = torch.empty((rows, 3072), device="cuda")
        want = pp.prefix_project_ref(x, w, bias)
        chosen = pp.plan(rows, 256, 3072, 2)
        for rowgroups in (1, 2, 4, 8):
            per_thread = 1
            while per_thread < pp.MAX_ROWS_PER_THREAD and per_thread * rowgroups < rows:
                per_thread *= 2

            def run(rowgroups=rowgroups, per_thread=per_thread):
                build.launch("vct_prefix_project", x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                             y.data_ptr(), rows, 256, 3072, build.dtype_code(w.dtype), rowgroups,
                             per_thread, 256, 1, 1, build.stream_of(x))

            report({"kernel": "prefix_projector", "shape": f"x[{rows},256] f32 @ w[256,3072] bf16",
                    "rowgroups": rowgroups, "rows_per_thread": per_thread,
                    "plan": (rowgroups, per_thread) == (chosen.rowgroups, chosen.rows_per_thread)},
                   run, lambda: torch.allclose(y, want, atol=1e-4, rtol=1e-4))
    for videos, beams, prefill, steps, t in BEAM if wanted("beam_attention") else ():
        q, k_new, v_new, gkv, pk, pv, valid, anc = beam_attention_case(
            videos, beams, prefill, steps)
        r, h = q.shape
        out = torch.empty((r, h), dtype=q.dtype, device="cuda")
        for deferred in (False, True):
            kw = dict(k_new=k_new, v_new=v_new) if deferred else {}
            want = ba.beam_attention_ref(q, gkv, pk, pv, valid, anc, t, beams, 12, **kw).float()
            chosen = ba.plan(videos, beams, prefill, steps, t, 2, deferred)
            seen = set()
            for split in (1, 2, 3, 4):
                rows = max(min(chosen.rows, beams), -(-chosen.rows // split))
                p = ba.plan(videos, beams, prefill, steps, t, 2, deferred, stage_rows=rows)
                if len(p.chunks) in seen:
                    continue
                seen.add(len(p.chunks))

                def run(p=p, deferred=deferred):
                    build.launch("vct_beam_attention", q.data_ptr(), q.stride(0), gkv.data_ptr(),
                                 pk.data_ptr(), pv.data_ptr(), valid.data_ptr(), anc.data_ptr(),
                                 k_new.data_ptr() if deferred else None,
                                 v_new.data_ptr() if deferred else None, k_new.stride(0), out.data_ptr(),
                                 r, h, 12, beams, prefill, steps, t, int(deferred), p.stage_rows,
                                 p.smem, build.dtype_code(q.dtype), build.stream_of(q))

                report({"kernel": "beam_attention",
                        "shape": f"R={r} (B={videos},K={beams}) S0={prefill} N={steps} t={t} bf16"
                                 f"{' deferred' if deferred else ''}",
                        "stage_rows": p.stage_rows, "chunks": len(p.chunks), "smem": p.smem,
                        "plan": p == chosen},
                       run, lambda: torch.allclose(out.float(), want, atol=1e-2, rtol=1e-2))
    for batch, length in DECODE if wanted("decode_attention") else ():
        q, k, v, valid = decode_attention_case(batch, length)
        want = da.decode_attention_ref(q, k, v, valid).float()
        strides = da._check(q, k, v, valid)
        chosen = da.plan(batch, 12, length, 2)
        for splits in (1, 2, 4, 8):
            cols = -(-length // splits)
            if (splits - 1) * cols >= length:
                continue
            most = min(cols, da.stage_limit(2))
            for stage_rows in sorted({-(-cols // n) for n in range(-(-cols // most), 8)
                                      if n <= cols}, reverse=True)[:4]:
                p = da.plan(batch, 12, length, 2, splits=splits, stage_rows=stage_rows)
                got = {}

                def run(p=p, got=got):
                    got["out"] = da._launch(q, k, v, valid, p, strides)

                report({"kernel": "decode_attention",
                        "shape": f"B={batch} L={length} 12x64 bf16 (strided K/V)",
                        "splits": p.splits, "stage_rows": p.stage_rows,
                        "chunks": -(-cols // p.stage_rows), "smem": p.smem,
                        "plan": p == chosen},
                       run, lambda got=got: torch.allclose(got["out"].float(), want, atol=1e-2,
                                                           rtol=1e-2))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
