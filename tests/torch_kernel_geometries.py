"""Geometries swept by the launch-plan tests of the fused_pool,
prefix_projector, beam_attention, decode_attention and decode_layer kernels: on the CPU
(tests/test_torch_kernel_plans.py, the plans alone) and on the GPU
(tests/test_torch_cuda_kernels.py, the kernels against their plain
versions)."""

POOL_GEOMETRIES = [(batch, frames, seq, h) for batch in (1, 4, 16) for frames in (1, 8)
                   for seq in (2, 197) for h in (64, 100, 768, 770)]
"""(B, T, S, H) of tokens [B*T, S, H]."""

PROJECTOR_GEOMETRIES = [(rows, din, dout) for rows in (1, 4, 8, 64, 65, 300)
                        for din in (100, 256) for dout in (3000, 3072)]
"""(R, din, dout) of x [R, din] @ W [din, dout]."""

BEAM_GEOMETRIES = [(videos, beams, s0, n) for videos, beams in ((1, 1), (2, 2), (2, 3), (1, 4))
                   for s0 in (1, 7, 48, 128) for n in (1, 24, 40, 64)] \
    + [(1, 5, s0, 32) for s0 in (5, 48)]
"""(B, K, S0, N) of one beam-attention layer: q [B*K, H], prefill [B, S0, H],
generated cache [N, 2, B*K, H] (K=5, N=32: eval_compare's beam-5 decode);
the CPU sweep takes every step t < N in both modes, the GPU t = 0, N/2 and
N-1."""

DECODE_GEOMETRIES = [(batch, length) for batch in (1, 3, 64) for length in (1, 17, 64, 300, 1024)]
"""(B, L) of one decode-attention layer: q [B, nh, 64] over K/V [B, L, nh, 64];
the CPU sweep checks the plan in bf16 and f32 at 12 heads, the GPU runs each
through the kernel in both dtypes."""

LAYER_GEOMETRIES = [(batch, h, max_len) for batch in (1, 3, 8, 64) for h in (256, 768)
                    for max_len in (1, 20, 64, 1024)]
"""(B, H, max_len) of one fused decode step: x [B, H] over kvf [n_layer,
max_len, B, 2H]; the CPU sweep checks the plan in bf16 and f32 with 132
blocks and with 40."""

TP_HEADS = (6, 3)
"""A rank's heads under tensor parallelism: the 12 heads of ViT-B/16 and of
GPT-2 over a model axis of 2 and of 4."""

ENCODER_TP_GEOMETRIES = [(frames, 197, heads) for frames in (1, 16) for heads in TP_HEADS]
"""(N, S, heads) of encoder_attention on a rank's head group: qkv
[N, S, 3 * heads * 64] (16 frames: one request's video)."""

BEAM_TP_GEOMETRIES = [(videos, beams, s0, n, heads)
                      for videos, beams, s0, n in ((3, 3, 48, 24), (3, 4, 48, 40), (1, 4, 48, 40))
                      for heads in TP_HEADS]
"""(B, K, S0, N, heads) of one beam-attention layer on a rank's head group:
the unified request's blocks (core and serving presets) and a grouped
beam-4 decode; the CPU sweep takes t = 0, N/2 and N-1 in both modes, the
GPU the same."""
