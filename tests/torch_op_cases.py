"""One input of each custom op of the port (``torch.ops.vct.*``, registered
by ``video_caption_tpu_torch/ops/``) at a small shape its CUDA kernel takes,
and the plain version it is held against. Shared by the CPU tests
(tests/test_torch_custom_ops.py: opcheck, the fake implementations, the
gradients) and the GPU tests (tests/test_torch_cuda_kernels.py: the CUDA
kernels through the dispatcher). Imports no JAX."""
from dataclasses import dataclass, field
from typing import Callable, List

import torch

from video_caption_tpu_torch.ops import beam_attention as ba
from video_caption_tpu_torch.ops import decode_attention as da
from video_caption_tpu_torch.ops import decode_layer as dl
from video_caption_tpu_torch.ops import encoder_attention as ea
from video_caption_tpu_torch.ops import fused_pool as fpl
from video_caption_tpu_torch.ops import lm_head as lmh
from video_caption_tpu_torch.ops import norm_act as na
from video_caption_tpu_torch.ops import prefix_projector as pp

GRAD_OPS = ("encoder_attention", "prefix_project", "fused_pool", "layer_norm", "gelu")
"""The ops with a registered backward."""


@dataclass
class OpCase:
    """``op(*args)`` against ``plain(*args)``: ``outputs(result, args)``
    gives the tensors to compare (the op's result by default; a mutated
    argument too where the op writes one), ``plain`` the same tensors from
    the plain version. Both may mutate their own copy of ``args``
    (:meth:`fresh_args`)."""

    id: str
    name: str
    args: tuple
    plain: Callable
    outputs: Callable = field(default=lambda result, args: [result])

    @property
    def op(self):
        return getattr(torch.ops.vct, self.name).default

    def fresh_args(self) -> tuple:
        return tuple(_clone(a) for a in self.args)

    def run(self) -> List[torch.Tensor]:
        args = self.fresh_args()
        return self.outputs(self.op(*args), args)

    def run_plain(self) -> List[torch.Tensor]:
        return self.plain(*self.fresh_args())


def _clone(a):
    if isinstance(a, torch.Tensor):
        return a.clone()
    if isinstance(a, list):
        return [_clone(x) for x in a]
    return a


def cases(device="cpu", seed=0) -> List[OpCase]:
    """Every op's case on ``device`` (float32 values, seeded)."""
    g = torch.Generator().manual_seed(seed)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(device)

    def ints(values):
        return torch.tensor(values, dtype=torch.int32).to(device)

    out = [OpCase("encoder_attention", "encoder_attention", (rand(2, 17, 3 * 128), 2),
                  lambda qkv, nh: [ea.encoder_attention_ref(qkv, nh)]),
           OpCase("prefix_project", "prefix_project",
                  (rand(3, 256), rand(256, 96, scale=0.05), rand(96)),
                  lambda x, w, b: [pp.prefix_project_ref(x, w, b)])]

    r, vp, vocab = 5, 3 * lmh.WINDOW, 300

    def lm_parts(buf, args):
        logits, wmax, _, m, l = buf.split(lmh._sizes(r, vp))
        return [logits, wmax, m, l]

    out.append(OpCase("lm_head_stats", "lm_head_stats", (rand(r, 64), rand(64, vp), vocab),
                      lambda x, w, v: [t.reshape(-1) for t in lmh.lm_head_stats_ref(x, w, v)],
                      lm_parts))

    # beam_attention: 2 videos x 3 beams, 2 heads, 7 prefill columns (the
    # first video's first 2 padded), a 5-column generated cache at step 2
    b, k, h, s0, n = 2, 3, 128, 7, 5
    valid = torch.ones((b, s0), dtype=torch.int32)
    valid[0, :2] = 0
    anc = (torch.arange(b * k) // k * k)[:, None] + torch.randint(0, k, (b * k, n), generator=g)
    beam = (rand(b * k, h), rand(n, 2, b * k, h), rand(b, s0, h), rand(b, s0, h),
            valid.to(device), anc.to(torch.int32).to(device), 2, k, 2)
    out.append(OpCase("beam_attention", "beam_attention", beam + (None, None),
                      lambda *a: [ba.beam_attention_ref(*a)]))
    out.append(OpCase("beam_attention_deferred", "beam_attention",
                      beam + (rand(b * k, h), rand(b * k, h)),
                      lambda *a: [ba.beam_attention_ref(*a)]))

    valid = torch.ones((2, 9), dtype=torch.int32)
    valid[1, 7:] = 0
    out.append(OpCase("decode_attention", "decode_attention",
                      (rand(2, 2, 64), rand(2, 9, 2, 64), rand(2, 9, 2, 64), valid.to(device)),
                      lambda *a: [da.decode_attention_ref(*a)]))

    # decode_layer: 2 layers at width 128 (2 heads), a 16-row cache, offset 5
    layers, width, max_len, offset = 2, 128, 16, 5
    shapes = {"ln1_scale": (width,), "ln1_bias": (width,), "attn_w": (width, 3 * width),
              "attn_b": (3 * width,), "proj_w": (width, width), "proj_b": (width,),
              "ln2_scale": (width,), "ln2_bias": (width,), "fc_w": (width, 4 * width),
              "fc_b": (4 * width,), "out_w": (4 * width, width), "out_b": (width,)}
    blocks = [1.0 + rand(layers, *shapes[key], scale=0.1) if key.endswith("scale")
              else rand(layers, *shapes[key], scale=0.05) for key in dl.BLOCK_KEYS]
    valid = torch.zeros((2, max_len), dtype=torch.int32)
    valid[:, :offset + 1] = 1
    valid[0, 0] = 0

    def layer_plain(x, kvf, valid, offset, blocks, heads, eps):
        x_out, kvf = dl.gpt2_decode_step_ref(x, kvf, valid, offset,
                                             dict(zip(dl.BLOCK_KEYS, blocks)), heads, eps)
        return [x_out, kvf]

    out.append(OpCase("decode_layer", "decode_layer",
                      (rand(2, width), rand(layers, max_len, 2, 2 * width, scale=0.5),
                       valid.to(device), offset, blocks, 2, 1e-5),
                      layer_plain, lambda result, args: [result, args[1]]))

    for mode in fpl.MODES:
        out.append(OpCase(f"fused_pool_{mode}", "fused_pool", (rand(6, 5, 64), 2, 3, mode),
                          lambda *a: [fpl.fused_pool_ref(*a)]))

    # norm_act: bf16 x (its kernels take bf16), weights in bf16 or f32
    x = rand(3, 5, 40).bfloat16()
    for w_dtype in (torch.bfloat16, torch.float32):
        out.append(OpCase(f"layer_norm_{str(w_dtype).split('.')[1]}_weight", "layer_norm",
                          (x, (1 + rand(40, scale=0.1)).to(w_dtype),
                           rand(40, scale=0.1).to(w_dtype), 1e-5),
                          lambda *a: [na.layer_norm_ref(*a)]))
    for approx in na.APPROXIMATIONS:
        out.append(OpCase(f"gelu_{approx}", "gelu", (rand(7, 33, scale=2.0).bfloat16(), approx),
                          lambda *a: [na.gelu_ref(*a)]))
    return out


def to_meta(args: tuple) -> tuple:
    """``args`` with every tensor moved to the meta device."""
    return tuple(a.to("meta") if isinstance(a, torch.Tensor)
                 else [x.to("meta") for x in a] if isinstance(a, list) else a for a in args)


CASE_IDS = [c.id for c in cases()]
