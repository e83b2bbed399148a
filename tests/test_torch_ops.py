"""The port's kernel modules (video_caption_tpu_torch/ops) on the CPU: each
plain PyTorch version against the JAX package's Pallas kernel run in
interpret mode (or its XLA twin), plus numpy mirrors of the CUDA kernels'
own algorithms (ancestor-column gather, two-pass row statistics) against
the plain versions, and the dispatch rule: a tensor that is on neither the
CPU nor a CUDA device raises, it never falls back."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from video_caption_tpu.models import gpt2 as jg2
from video_caption_tpu.ops.pallas import beam_attention as jba
from video_caption_tpu.ops.pallas import encoder_attention as jea
from video_caption_tpu.ops.pallas import lm_head as jlm
from video_caption_tpu.ops.pallas import prefix_projector as jpp
from video_caption_tpu.ops.prefix_norm import apply_prefix_norm as j_prefix_norm
from video_caption_tpu_torch.ops import beam_attention as ba
from video_caption_tpu_torch.ops import build
from video_caption_tpu_torch.ops import encoder_attention as ea
from video_caption_tpu_torch.ops import lm_head as lmh
from video_caption_tpu_torch.ops import prefix_projector as pp
from video_caption_tpu_torch.ops.prefix_norm import apply_prefix_norm


def _t(x):
    return torch.tensor(np.asarray(x))


def test_encoder_attention_matches_jax_kernel():
    n, nh, s, hd = 2, 4, 13, 64
    qkv = np.random.RandomState(0).randn(n, s, 3 * nh * hd).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jea.encoder_attention(jnp.asarray(qkv), nh)
    assert want is not None, jea.last_error
    got = ea.encoder_attention(torch.from_numpy(qkv), nh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_prefix_projector_matches_jax_kernel():
    rng = np.random.RandomState(1)
    x = rng.randn(3, 128).astype(np.float32)
    w = (rng.randn(128, 256) * 0.02).astype(np.float32)
    b = rng.randn(256).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpp._prefix_project_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = pp.prefix_project(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _lm_inputs(r, h, v):
    rng = np.random.RandomState(0)
    vp = -(-v // 128) * 128
    x = jnp.asarray(rng.randn(r, h).astype(np.float32)).astype(jnp.bfloat16)
    w = jnp.asarray(rng.randn(h, vp).astype(np.float32)).astype(jnp.bfloat16)
    w = jnp.where(jnp.arange(vp)[None, :] < v, w, 0)
    return x, w


@pytest.mark.parametrize("v", [1400, 1337])
def test_lm_head_stats_matches_jax_kernel(v):
    x, w = _lm_inputs(16, 128, v)
    with pltpu.force_tpu_interpret_mode():
        want = jlm.lm_head_stats(x, w, v)
    assert want is not None, jlm.last_error
    got = lmh.lm_head_stats(_t(x.astype(jnp.float32)).bfloat16(),
                            _t(w.astype(jnp.float32)).bfloat16(), v)
    for g, w_, name in zip(got, want, ("logits", "wmax", "m", "l")):
        g, w_ = g.numpy(), np.asarray(w_)
        assert g.shape == w_.shape, name
        finite = np.isfinite(w_)
        np.testing.assert_array_equal(np.isfinite(g), finite, err_msg=name)
        # f32 sums over H=128 products of O(1) values, in another order than
        # XLA's: rtol 1e-5 plus atol 1e-5 for logits that land near zero
        np.testing.assert_allclose(g[finite], w_[finite], rtol=1e-5, atol=1e-5, err_msg=name)
    assert np.all(np.isneginf(got[0][:, v:].numpy()))


def test_lm_head_two_pass_row_stats_equal_plain():
    """The CUDA kernel's row statistics: per-window (max, sum-exp) pairs
    combined as l = sum_w lpart_w * exp(wmax_w - m)."""
    x, w = _lm_inputs(5, 64, 1337)
    logits, wmax, m, l = lmh.lm_head_stats_ref(_t(x.astype(jnp.float32)),
                                               _t(w.astype(jnp.float32)), 1337)
    win = logits.reshape(5, -1, 128)
    lpart = torch.exp(win - wmax[:, :, None]).sum(-1)
    m2 = wmax.amax(-1)
    l2 = (lpart * torch.exp(wmax - m2[:, None])).sum(-1)
    np.testing.assert_array_equal(m2.numpy(), m.numpy())
    np.testing.assert_allclose(l2.numpy(), l.numpy(), rtol=1e-6)


def _beam_case(b=8, k=3, nh=4, hd=32, s0=12, n=6, t_val=3, seed=0):
    rng = np.random.RandomState(seed)
    h, r = nh * hd, b * k
    q = rng.randn(r, h).astype(np.float32)
    gkv = rng.randn(2, n, 2, r, h).astype(np.float32)
    pk = rng.randn(2, b, s0, h).astype(np.float32)
    pv = rng.randn(2, b, s0, h).astype(np.float32)
    valid = (rng.rand(b, s0) > 0.3).astype(np.int32)
    valid[:, -1] = 1
    anc = (np.arange(r)[:, None] // k * k + rng.randint(0, k, (r, n))).astype(np.int32)
    return q, gkv, pk, pv, valid, anc, t_val


def _port_beam(case, layer, k, nh):
    q, gkv, pk, pv, valid, anc, t = case
    return ba.beam_attention(torch.from_numpy(q), torch.from_numpy(gkv[layer]),
                             torch.from_numpy(pk[layer]), torch.from_numpy(pv[layer]),
                             torch.from_numpy(valid), torch.from_numpy(anc), t, k, nh).numpy()


@pytest.mark.parametrize("layer", [0, 1])
def test_beam_attention_matches_jax_kernel(layer):
    case = _beam_case()
    q, gkv, pk, pv, valid, anc, t = case
    cfg = jg2.GPT2Config(vocab_size=128, n_embd=128, n_layer=2, n_head=4, dtype=jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jba.beam_gen_attention(
            jnp.asarray(q), jnp.asarray(gkv), jnp.asarray(pk), jnp.asarray(pv),
            jnp.asarray(valid), jnp.asarray(anc), jnp.int32(t),
            jg2.head_block_mask(cfg).astype(jnp.float32), layer, 3, 4)
    assert want is not None, jba.last_error
    np.testing.assert_allclose(_port_beam(case, layer, 3, 4), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("t_val", [0, 2, 5])
def test_beam_attention_single_request_rows_match_xla_twin(t_val):
    """R = 6 (B=2, K=3): a row count the JAX kernel sends to XLA."""
    case = _beam_case(b=2, k=3, nh=2, hd=64, s0=7, n=6, t_val=t_val, seed=4)
    q, gkv, pk, pv, valid, anc, t = case
    cfg = jg2.GPT2Config(vocab_size=128, n_embd=128, n_layer=2, n_head=2, dtype=jnp.float32)
    sel = jg2.ancestry_mask(jnp.asarray(anc), 2, 3, jnp.int32(t))
    want = jg2._beam_attend(jnp.asarray(q), jnp.asarray(pk[1]), jnp.asarray(pv[1]),
                            jnp.asarray(gkv[1, :, 0]), jnp.asarray(gkv[1, :, 1]),
                            jnp.asarray(valid), sel, jg2.head_block_mask(cfg), 3, cfg)
    np.testing.assert_allclose(_port_beam(case, 1, 3, 2), np.asarray(want), atol=1e-5)


def _gather_beam_attention(q, gkv, pk, pv, valid, anc, t, k, nh):
    """The ancestor-column gather csrc/beam_attention.cu computes, per (row,
    head): the valid prefill columns of the row's video plus the ONE column
    anc[r, nn] wrote at each step nn <= t, one softmax, AV (the kernel's own
    order is mirrored in tests/test_torch_kernel_plans.py)."""
    r, h = q.shape
    hd = h // nh
    s0 = pk.shape[1]
    out = np.zeros((r, h), np.float64)
    for row in range(r):
        b = row // k
        for head in range(nh):
            sl = slice(head * hd, (head + 1) * hd)
            keys = [pk[b, s, sl] for s in range(s0)] + [gkv[nn, 0, anc[row, nn], sl] for nn in range(t + 1)]
            vals = [pv[b, s, sl] for s in range(s0)] + [gkv[nn, 1, anc[row, nn], sl] for nn in range(t + 1)]
            logits = np.array([q[row, sl] @ kk for kk in keys]) * hd ** -0.5
            logits[:s0][valid[b] == 0] = -1e30
            p = np.exp(logits - logits.max())
            out[row, sl] = (p / p.sum()) @ np.array(vals)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_ancestor_gather_equals_dense_mask(seed):
    case = _beam_case(b=3, k=4, nh=2, hd=16, s0=5, n=5, t_val=3, seed=seed)
    q, gkv, pk, pv, valid, anc, t = case
    want = _gather_beam_attention(q, gkv[0], pk[0], pv[0], valid, anc, t, 4, 2)
    np.testing.assert_allclose(_port_beam(case, 0, 4, 2), want, atol=1e-5)


def test_prefix_norm_matches_jax():
    emb = np.random.RandomState(2).randn(3, 256).astype(np.float32)
    want = np.asarray(j_prefix_norm(jnp.asarray(emb), 0.6, 0.4))
    got = apply_prefix_norm(torch.from_numpy(emb), 0.6, 0.4).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("op", ["encoder_attention", "prefix_project", "lm_head_stats",
                                "beam_attention"])
def test_wrapper_on_other_device_raises(op):
    """Only CPU tensors take the plain version; anything else must be a CUDA
    tensor the kernel takes, or the wrapper raises."""
    meta = dict(device="meta")
    calls = {
        "encoder_attention": lambda: ea.encoder_attention(torch.empty(2, 5, 3 * 128, **meta), 2),
        "prefix_project": lambda: pp.prefix_project(torch.empty(2, 8, **meta),
                                                    torch.empty(8, 16, **meta),
                                                    torch.empty(16, **meta)),
        "lm_head_stats": lambda: lmh.lm_head_stats(torch.empty(2, 8, **meta),
                                                   torch.empty(8, 256, **meta), 200),
        "beam_attention": lambda: ba.beam_attention(
            torch.empty(6, 128, **meta), torch.empty(4, 2, 6, 128, **meta),
            torch.empty(2, 3, 128, **meta), torch.empty(2, 3, 128, **meta),
            torch.empty(2, 3, dtype=torch.int32, **meta),
            torch.empty(6, 4, dtype=torch.int32, **meta), 0, 3, 2),
    }
    with pytest.raises(ValueError, match="CUDA"):
        calls[op]()


def test_build_rejects_unsupported_dtype_and_keys_sources():
    with pytest.raises(TypeError):
        build.dtype_code(torch.float16)
    assert build.dtype_code(torch.bfloat16) == 1 and build.dtype_code(torch.float32) == 0
    names = {p.name for p in build.sources()}
    assert {"encoder_attention.cu", "prefix_projector.cu", "lm_head.cu",
            "beam_attention.cu"} <= names
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert build.library_path().name.startswith("libvct_kernels_")
    # every entry point the wrappers call has its ctypes signature
    for src in build.sources():
        for line in src.read_text().splitlines():
            if line.startswith('extern "C" int '):
                assert line.split()[3].split("(")[0] in build.SIGNATURES, line


def test_count_tensor_core_instructions_reads_a_sass_listing():
    sass = """
        code for sm_90a
                Function : _Z6kernelA
        /*0000*/                   LDSM.16.M88.4 R4, [R2] ;
        /*0010*/                   HMMA.16816.F32.BF16 R8, R4, R6, RZ ;
        /*0020*/                   HMMA.1688.F32.TF32 R8, R4, R6, R8 ;
                Function : _Z6kernelB
        /*0000*/                   FFMA R1, R2, R3, R4 ;
        /*0010*/                   LDG.E.128.CONSTANT R8, desc[UR10][R10.64] ;
        /*0020*/                   LDG.E R9, desc[UR10][R12.64] ;
        /*0030*/                   UCGABAR_ARV ;
        /*0040*/                   LD.E R2, desc[UR10][R16.64] ;
        /*0050*/                   LDGSTS.E.BYPASS.128 [R3], desc[UR10][R18.64] ;
                Function : _Z6kernelC
        /*0000*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ ;
    """
    none = dict.fromkeys(build.SASS_PATTERNS, 0)
    assert build.count_instructions(sass, build.SASS_PATTERNS) == {
        "_Z6kernelA": {**none, "HMMA/HGMMA": 2},
        "_Z6kernelB": {**none, "LDG.128": 1, "LD": 1, "UCGABAR": 1, "LDGSTS": 1},
        "_Z6kernelC": {**none, "HMMA/HGMMA": 1}}


def test_time_kernels_needs_a_gpu(capsys):
    from video_caption_tpu_torch.cli import time_kernels

    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a GPU")
    assert time_kernels.main([]) == 1
    assert "NVIDIA GPU" in capsys.readouterr().err


def _split_tf32(x):
    """numpy mirror of csrc/mma.cuh split_tf32: hi = the top 19 bits of x,
    lo = the rest truncated to TF32 the same way."""
    hi = (x.view(np.uint32) & np.uint32(0xffffe000)).view(np.float32)
    lo = ((x - hi).view(np.uint32) & np.uint32(0xffffe000)).view(np.float32)
    return hi, lo


def test_3xtf32_split_keeps_f32_accuracy():
    """The f32 encoder attention's products: hi*hi + hi*lo + lo*hi of TF32
    parts (each product exact, as in the tensor cores) against the f64 dot
    products of the same f32 inputs, at the 64-wide dot products of one head."""
    rng = np.random.RandomState(3)
    q = rng.randn(16, 64).astype(np.float32)
    k = rng.randn(197, 64).astype(np.float32)
    (qh, ql), (kh, kl) = _split_tf32(q), _split_tf32(k)
    for part in (qh, ql, kh, kl):       # TF32 values: the low 13 mantissa bits are zero
        assert not (part.view(np.uint32) & np.uint32(0x1fff)).any()
    np.testing.assert_array_less(np.abs(q.astype(np.float64) - qh - ql), 2.0 ** -20 * np.abs(q) + 1e-30)
    f64 = np.float64
    want = q.astype(f64) @ k.T.astype(f64)
    got = ql.astype(f64) @ kh.T.astype(f64) + qh.astype(f64) @ kl.T.astype(f64) \
        + qh.astype(f64) @ kh.T.astype(f64)
    one_term = qh.astype(f64) @ kh.T.astype(f64)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < 1e-6 * scale
    assert np.abs(one_term - want).max() > 1e-4 * scale     # plain TF32 would miss 1e-4


def test_profile_names_the_port_kernels_only():
    from video_caption_tpu_torch.cli.profile_request import is_port_kernel

    assert is_port_kernel("void (anonymous namespace)::attention_bf16_kernel<13>(__nv_bfloat16 const*)")
    assert is_port_kernel("(anonymous namespace)::lm_head_row_stats_kernel(float const*, int)")
    assert not is_port_kernel("void (anonymous namespace)::softmax_warp_forward<float, float>(float*)")
    assert not is_port_kernel("void at::native::vectorized_elementwise_kernel<4>(int)")
    # a word of the sources that names no kernel
    assert not is_port_kernel("void (anonymous namespace)::launch<float, 13>(int)")


def test_build_lists_every_kernel_of_the_sources():
    """build.KERNELS, which the profilers match kernel names against, is
    exactly the set of __global__ functions in ops/csrc."""
    found = set()
    for src in build.SRC_DIR.iterdir():
        text = re.sub(r"//[^\n]*", "", src.read_text())
        for m in re.finditer(r"__global__\s+void\s+", text):
            i = m.end()
            if text.startswith("__launch_bounds__", i):      # skip its balanced parentheses
                i, depth = text.index("(", i), 0
                while True:
                    depth += {"(": 1, ")": -1}.get(text[i], 0)
                    i += 1
                    if depth == 0:
                        break
            found.add(re.match(r"\s*(\w+)\s*\(", text[i:]).group(1))
    assert found == build.KERNELS
