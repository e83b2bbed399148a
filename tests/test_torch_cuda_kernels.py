"""The port's CUDA kernels against their plain PyTorch versions on an NVIDIA
GPU, through the same checks chip_smoke.py runs
(video_caption_tpu_torch/ops/selfcheck.py). Every test here needs the card:
they carry the ``cuda`` marker and skip where torch.cuda.is_available() is
false. Run them on the GPU with

    python -m pytest tests/test_torch_cuda_kernels.py -q
"""
import pytest
import torch

from torch_kernel_geometries import (BEAM_GEOMETRIES, BEAM_TP_GEOMETRIES, DECODE_GEOMETRIES,
                                     ENCODER_TP_GEOMETRIES, POOL_GEOMETRIES,
                                     PROJECTOR_GEOMETRIES)
from torch_op_cases import CASE_IDS, cases, to_meta
from video_caption_tpu_torch.ops import selfcheck

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def _assert_ok(result):
    assert result.ok, result.as_dict()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("frames,seq", [(1, 197), (16, 197), (2, 1), (2, 7), (2, 16), (2, 17),
                                        (2, 208), (2, 209), (2, 256), (2, "max")])
def test_encoder_attention_kernel(cuda, frames, seq, dtype):
    from video_caption_tpu_torch.ops import encoder_attention as ea

    seq = ea.MAX_SEQ if seq == "max" else seq
    _assert_ok(selfcheck.check_encoder_attention(frames, cuda, seq=seq, dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("frames,seq,heads", ENCODER_TP_GEOMETRIES)
def test_encoder_attention_kernel_tp_heads(cuda, frames, seq, heads, dtype):
    """A rank's head group under tensor parallelism (6 or 3 of 12 heads)."""
    _assert_ok(selfcheck.check_encoder_attention(frames, cuda, seq=seq, heads=heads,
                                                 dtype=dtype))


def test_encoder_attention_kernel_odd_sequence(cuda):
    _assert_ok(selfcheck.check_encoder_attention(3, cuda, seq=13, heads=4))


@pytest.mark.parametrize("rows", [1, 8, 65])
def test_prefix_projector_kernel(cuda, rows):
    _assert_ok(selfcheck.check_prefix_projector(rows, cuda))


@pytest.mark.parametrize("rows", [1, 6, 9, 12, 15, 16, 17, 24, 63, 64, 65, 96, 192, 256, 300])
def test_lm_head_kernel(cuda, rows):
    _assert_ok(selfcheck.check_lm_head(rows, cuda))


@pytest.mark.parametrize("rows", [1, 4, 17, 65, 192, 256])
def test_lm_head_kernel_small_vocab(cuda, rows):
    """Two windows of nothing but pad columns past the last word's."""
    from video_caption_tpu_torch.ops import lm_head as lmh

    _assert_ok(selfcheck.check_lm_head(rows, cuda, h=128, vocab=1337, pad_windows=2))
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((rows, 128), generator=g, device=cuda).bfloat16()
    w = torch.randn((128, 13 * 128), generator=g, device=cuda).bfloat16()
    _, wmax, _, l = lmh.lm_head_stats(x, w, 1337)
    _, _, _, l_unpadded = lmh.lm_head_stats(x, w[:, :11 * 128].contiguous(), 1337)
    assert torch.isneginf(wmax[:, 11:]).all()
    assert torch.isfinite(wmax[:, :11]).all()
    torch.testing.assert_close(l, l_unpadded, rtol=0, atol=0)


@pytest.mark.parametrize("deferred", [False, True])
@pytest.mark.parametrize("videos,beams,steps,t", [(2, 3, 24, 0), (2, 3, 24, 23), (1, 4, 40, 17),
                                                  (3, 3, 6, 5)])
def test_beam_attention_kernel(cuda, videos, beams, steps, t, deferred):
    _assert_ok(selfcheck.check_beam_attention(videos, beams, 12, steps, t, cuda,
                                              deferred=deferred))


@pytest.mark.parametrize("deferred", [False, True])
@pytest.mark.parametrize("videos,beams,steps,live", [
    (3, 3, 24, (3, 3, 1)),          # the unified request, core presets
    (3, 4, 40, (3, 4, 1)),          # serving presets: a dead row, a sampled row, 3 dead
])
def test_beam_attention_kernel_unified_blocks(cuda, videos, beams, steps, live, deferred):
    """The unified decode's layout: dead and sampled rows with identity
    ancestry inside their instance's block, at t = 0, N/2 and N-1."""
    for t in (0, steps // 2, steps - 1):
        _assert_ok(selfcheck.check_beam_attention(videos, beams, 48, steps, t, cuda,
                                                  deferred=deferred, live=live))


@pytest.mark.parametrize("deferred", [False, True])
@pytest.mark.parametrize("videos,beams,s0,n,heads", BEAM_TP_GEOMETRIES)
def test_beam_attention_kernel_tp_heads(cuda, videos, beams, s0, n, heads, deferred):
    """A rank's head group under tensor parallelism (6 or 3 of 12 heads),
    at t = 0, N/2 and N-1."""
    live = (beams, beams, 1) if videos == 3 else None
    for t in sorted({0, n // 2, n - 1}):
        _assert_ok(selfcheck.check_beam_attention(videos, beams, s0, n, t, cuda, heads=heads,
                                                  deferred=deferred, live=live))


@pytest.mark.parametrize("deferred", [False, True])
def test_beam_attention_kernel_batch_of_eight(cuda, deferred):
    """A batch of 8 videos' beam group with two presets: 16 instances x 3."""
    _assert_ok(selfcheck.check_beam_attention(16, 3, 48, 24, 12, cuda, deferred=deferred))


def _beam_call(case, t, beams, heads, deferred, fn=None):
    from video_caption_tpu_torch.ops import beam_attention as ba

    q, k_new, v_new, gkv, pk, pv, valid, anc = case
    kw = dict(k_new=k_new, v_new=v_new) if deferred else {}
    return (fn or ba.beam_attention)(q, gkv, pk, pv, valid, anc, t, beams, heads, **kw)


def _beam_tolerance(dtype):
    return (1e-2, 1e-2) if dtype == torch.bfloat16 else (1e-4, 1e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("videos,beams,s0,n", BEAM_GEOMETRIES)
def test_beam_attention_kernel_geometry_sweep(cuda, videos, beams, s0, n, dtype):
    """Every geometry of the CPU plan sweep at t = 0, N/2 and N-1, both
    modes: within tolerance of the plain version, and two calls bit-equal."""
    from video_caption_tpu_torch.ops import beam_attention as ba

    case = selfcheck.beam_attention_case(videos, beams, s0, n, cuda, heads=2, dtype=dtype,
                                         seed=videos + beams + s0 + n)
    atol, rtol = _beam_tolerance(dtype)
    for t in sorted({0, n // 2, n - 1}):
        for deferred in (False, True):
            got = _beam_call(case, t, beams, 2, deferred)
            again = _beam_call(case, t, beams, 2, deferred)
            want = _beam_call(case, t, beams, 2, deferred, ba.beam_attention_ref)
            torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
            assert torch.equal(got, again)


@pytest.mark.parametrize("deferred", [False, True])
def test_beam_attention_kernel_all_invalid_prefill_row(cuda, deferred):
    """A video whose prefill is all left padding attends only its generated
    columns (and the self column)."""
    from video_caption_tpu_torch.ops import beam_attention as ba

    case = list(selfcheck.beam_attention_case(2, 3, 16, 8, cuda, heads=2))
    case[6] = case[6].clone()
    case[6][1] = 0
    got = _beam_call(case, 5, 3, 2, deferred)
    want = _beam_call(case, 5, 3, 2, deferred, ba.beam_attention_ref)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=1e-2)


def test_beam_attention_kernel_strided_and_contiguous_q_agree(cuda):
    """q, k_new and v_new as strided thirds of the fused QKV output give the
    bits of contiguous copies."""
    case = selfcheck.beam_attention_case(2, 3, 48, 24, cuda)
    assert case[0].stride(0) == 3 * case[0].shape[1]
    dense = [x.contiguous() for x in case[:3]] + list(case[3:])
    for deferred in (False, True):
        assert torch.equal(_beam_call(case, 12, 3, 12, deferred),
                           _beam_call(dense, 12, 3, 12, deferred))


def test_beam_attention_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from video_caption_tpu_torch.ops import beam_attention as ba

    q, k_new, v_new, gkv, pk, pv, valid, anc = selfcheck.beam_attention_case(2, 3, 8, 6, cuda,
                                                                            heads=2)
    args = (q, gkv, pk, pv, valid, anc, 3, 3, 2)
    with pytest.raises(ValueError, match="together"):
        ba.beam_attention(*args, k_new=k_new)
    with pytest.raises(TypeError):             # k_new not in q's dtype
        ba.beam_attention(*args, k_new=k_new.float(), v_new=v_new)
    with pytest.raises(ValueError):            # k_new not [R, H]
        ba.beam_attention(*args, k_new=k_new[:4], v_new=v_new)
    with pytest.raises(ValueError):            # k_new and v_new of two row strides
        ba.beam_attention(*args, k_new=k_new.contiguous(), v_new=v_new)
    with pytest.raises(ValueError):            # rows off a 16-byte boundary
        buf = torch.zeros(6 * 128 + 1, dtype=q.dtype, device=cuda)
        ba.beam_attention(buf[1:].view(6, 128), *args[1:])
    with pytest.raises(ValueError):
        ba.beam_attention(*args[:6], 6, 3, 2)  # step outside the cache
    with pytest.raises(ValueError):            # more beams than the kernel serves
        big = selfcheck.beam_attention_case(1, ba.MAX_BEAMS + 1, 4, 2, cuda, heads=1)
        _beam_call(big, 0, ba.MAX_BEAMS + 1, 1, False)


@pytest.mark.parametrize("batch,length,heads", [(1, 64, 12), (64, 64, 12), (3, 13, 4),
                                                (2, 300, 12)])
def test_decode_attention_kernel(cuda, batch, length, heads):
    _assert_ok(selfcheck.check_decode_attention(batch, length, cuda, heads=heads))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batch,length", DECODE_GEOMETRIES)
def test_decode_attention_kernel_geometry_sweep(cuda, batch, length, dtype):
    _assert_ok(selfcheck.check_decode_attention(batch, length, cuda, dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batch,length,empty_row,stale", [
    (1, 64, True, False), (2, 64, True, True), (2, 300, False, True), (3, 300, True, True),
    (1, 1024, True, True), (2, 17, False, True)])
def test_decode_attention_kernel_edge_cases(cuda, batch, length, empty_row, stale, dtype):
    """A row with no visible column (the mean of its V rows) and columns
    that are not visible holding 1e4 in K and V (they weigh exactly 0)."""
    _assert_ok(selfcheck.check_decode_attention(batch, length, cuda, dtype=dtype,
                                                empty_row=empty_row, stale=stale))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batch,length,splits,stage_rows", [
    (2, 300, 1, None), (2, 300, 2, None), (2, 300, 4, 19), (2, 300, 8, 5), (1, 64, 2, None),
    (1, 64, 1, 16), (3, 17, 4, 1), (1, 1024, 8, 64), (1, 4096, None, None), (1, 4096, 1, None)])
def test_decode_attention_kernel_forced_plans(cuda, batch, length, splits, stage_rows, dtype):
    """Every split and chunking the plan can force, over stale rows; L=4096
    chunks by itself (runs of 512 rows, 341 bf16 / 180 f32 staged at once)."""
    _assert_ok(selfcheck.check_decode_attention(batch, length, cuda, dtype=dtype, stale=True,
                                                splits=splits, stage_rows=stage_rows))


def test_decode_attention_kernel_repeats_bit_equal(cuda):
    from video_caption_tpu_torch.ops import decode_attention as da

    q, k, v, valid = selfcheck.decode_attention_case(2, 1024, cuda)
    assert da.plan(2, 12, 1024, 2).splits == 8
    first = da.decode_attention(q, k, v, valid)
    assert torch.equal(first, da.decode_attention(q, k, v, valid))


def test_decode_attention_rejects_views_off_16_bytes(cuda):
    from video_caption_tpu_torch.ops import decode_attention as da

    q, k, v, valid = selfcheck.decode_attention_case(2, 64, cuda, heads=4)
    buf = torch.zeros(1 + q.numel(), dtype=q.dtype, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):       # q 2 bytes past a boundary
        da.decode_attention(buf[1:].view(q.shape), k, v, valid)
    wide = torch.zeros(2, 64, 4 * 64 + 4, dtype=q.dtype, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):       # K rows 520 bytes apart
        da.decode_attention(q, wide[:, :, :256].unflatten(2, (4, 64)), v, valid)
    wide = torch.zeros(2 * 64 * 256 + 4, dtype=q.dtype, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):       # V 8 bytes past a boundary
        da.decode_attention(q, k, wide[4:].view(2, 64, 4, 64), valid)
    torch.testing.assert_close(da.decode_attention(q, k, v, valid),
                               da.decode_attention_ref(q, k, v, valid), atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("batch", [1, 2, 3, 8, 13])     # 13 rows: two passes of 8 over a tile
def test_decode_layer_kernel_one_layer(cuda, batch):
    _assert_ok(selfcheck.check_decode_layer(batch, cuda, n_layer=1))


@pytest.mark.parametrize("batch", [1, 8])
def test_decode_layer_kernel_full_depth(cuda, batch):
    _assert_ok(selfcheck.check_decode_layer(batch, cuda))


@pytest.mark.parametrize("batch,offset", [(5, 40), (2, 0), (2, 63)])
def test_decode_layer_kernel_f32(cuda, batch, offset):
    _assert_ok(selfcheck.check_decode_layer(batch, cuda, offset=offset, dtype=torch.float32))


def test_decode_layer_kernel_small_width(cuda):
    _assert_ok(selfcheck.check_decode_layer(3, cuda, n_layer=3, h=256, max_len=20, offset=19,
                                            dtype=torch.float32))


def test_decode_layer_writes_only_its_cache_row(cuda):
    from video_caption_tpu_torch.ops import decode_layer as dl

    x, kvf, valid, blocks = selfcheck.decode_layer_case(2, cuda, n_layer=2, offset=17)
    before = kvf.clone()
    dl.gpt2_decode_step(x, kvf, valid, 17, blocks, 12)
    torch.cuda.synchronize()
    others = torch.arange(kvf.shape[1], device=cuda) != 17
    assert torch.equal(kvf[:, others], before[:, others])
    assert not torch.equal(kvf[:, 17], before[:, 17])


@pytest.mark.parametrize("batch,n_layer,max_len,offset,dtype,edge", [
    (2, 1, 1, 0, torch.bfloat16, None), (2, 12, 1, 0, torch.float32, None),   # one cache row
    (1, 1, 1024, 1000, torch.bfloat16, None),                  # K and V in chunks
    (2, 12, 1024, 1000, torch.float32, None),
    (3, 1, 64, 40, torch.bfloat16, "stale"), (3, 12, 64, 40, torch.float32, "stale"),
    (3, 1, 64, 40, torch.bfloat16, "empty"), (3, 12, 64, 40, torch.float32, "empty"),
    (2, 2, 1024, 1000, torch.float32, "empty"),                # the mean of 1024 V rows, chunked
    (64, 1, 64, 40, torch.bfloat16, None), (64, 12, 64, 40, torch.float32, None)])
def test_decode_layer_kernel_edges(cuda, batch, n_layer, max_len, offset, dtype, edge):
    """Cache lengths 1 and 1024, rows the step cannot see holding 1e4, a row
    with no visible column, and B=64 (eight passes over each slab)."""
    _assert_ok(selfcheck.check_decode_layer(batch, cuda, n_layer=n_layer, max_len=max_len,
                                            offset=offset, dtype=dtype, stale=edge == "stale",
                                            empty_row=edge == "empty"))


@pytest.mark.parametrize("batch,dtype", [(1, torch.bfloat16), (8, torch.float32)])
def test_decode_layer_kernel_repeats_bit_equal(cuda, batch, dtype):
    """The split phases add their partials in split order, whatever block
    arrives last: two launches give the same bits, and the second finds its
    tickets reset."""
    from video_caption_tpu_torch.ops import decode_layer as dl

    x, kvf, valid, blocks = selfcheck.decode_layer_case(batch, cuda, dtype=dtype)
    assert max(dl.plan(batch, 768, 12, 64, x.element_size()).splits) > 1
    first_kvf, again_kvf = kvf.clone(), kvf.clone()
    first, _ = dl.gpt2_decode_step(x, first_kvf, valid, 40, blocks, 12)
    again, _ = dl.gpt2_decode_step(x, again_kvf, valid, 40, blocks, 12)
    torch.cuda.synchronize()
    assert torch.equal(first, again) and torch.equal(first_kvf, again_kvf)


@pytest.mark.parametrize("batch,frames,mode,dtype", [
    (4, 8, "gap", torch.float32), (16, 8, "gap", torch.bfloat16), (2, 8, "cls", torch.bfloat16),
    (1, 1, "gap", torch.float32), (3, 5, "cls", torch.float32)])
def test_fused_pool_kernel(cuda, batch, frames, mode, dtype):
    _assert_ok(selfcheck.check_fused_pool(batch, frames, mode, dtype, cuda))


def test_fused_pool_kernel_odd_width(cuda):
    """H not a multiple of a block's column tile, nor of 128."""
    _assert_ok(selfcheck.check_fused_pool(3, 2, "gap", torch.float32, cuda, seq=7, h=300))


def _offset_view(shape, dtype, offset, seed, scale=1.0):
    """A seeded normal tensor times ``scale`` of ``shape``, ``offset``
    elements into a larger buffer (offset 1 breaks 16-byte alignment)."""
    n = 1
    for d in shape:
        n *= d
    g = torch.Generator(device="cuda").manual_seed(seed)
    buf = (torch.randn(n + offset, generator=g, device="cuda") * scale).to(dtype)
    return buf[offset:].view(shape)


def _pool_tolerance(dtype):
    return selfcheck.TOLERANCES["fused_pool"] if dtype == torch.float32 else (1e-2, 1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,frames,seq,h", POOL_GEOMETRIES)
def test_fused_pool_kernel_geometry_sweep(cuda, batch, frames, seq, h, dtype):
    """Every geometry of the CPU plan sweep, both modes: within tolerance of
    the plain version, and two calls bit-equal."""
    from video_caption_tpu_torch.ops import fused_pool as fpl

    tokens = _offset_view((batch * frames, seq, h), dtype, 0, seed=batch + frames + seq + h)
    atol, rtol = _pool_tolerance(dtype)
    for mode in ("gap", "cls"):
        got = fpl.fused_pool_temporal(tokens, batch, frames, mode)
        again = fpl.fused_pool_temporal(tokens, batch, frames, mode)
        want = fpl.fused_pool_ref(tokens, batch, frames, mode)
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
        assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,frames,seq,h,mode", [(4, 8, 197, 768, "gap"), (16, 8, 197, 768, "gap"),
                                                     (2, 8, 197, 768, "cls"), (3, 2, 7, 100, "gap")])
def test_fused_pool_kernel_misaligned_tokens(cuda, batch, frames, seq, h, mode, dtype):
    """Tokens one element into a buffer take the kernel's scalar loads and
    give the bits of the 16-byte loads on an aligned copy."""
    from video_caption_tpu_torch.ops import fused_pool as fpl

    tokens = _offset_view((batch * frames, seq, h), dtype, 1, seed=21)
    assert tokens.data_ptr() % 16 != 0
    got = fpl.fused_pool_temporal(tokens, batch, frames, mode)
    aligned = fpl.fused_pool_temporal(tokens.clone(), batch, frames, mode)
    assert torch.equal(got, aligned)
    atol, rtol = _pool_tolerance(dtype)
    torch.testing.assert_close(got.float(), fpl.fused_pool_ref(tokens, batch, frames, mode).float(),
                               atol=atol, rtol=rtol)


def _projector_inputs(rows, din, dout, w_dtype, x_offset=0, seed=22):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = _offset_view((rows, din), torch.float32, x_offset, seed, scale=0.4)
    w = (torch.randn((din, dout), generator=g, device="cuda") * 0.02).to(w_dtype)
    b = (torch.randn((dout,), generator=g, device="cuda") * 0.02).to(w_dtype)
    return x, w, b


@pytest.mark.parametrize("w_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,din,dout", PROJECTOR_GEOMETRIES)
def test_prefix_projector_kernel_geometry_sweep(cuda, rows, din, dout, w_dtype):
    """Every geometry of the CPU plan sweep: within 1e-4 of the plain
    version, and two calls bit-equal."""
    from video_caption_tpu_torch.ops import prefix_projector as pp

    x, w, b = _projector_inputs(rows, din, dout, w_dtype)
    got, again = pp.prefix_project(x, w, b), pp.prefix_project(x, w, b)
    torch.testing.assert_close(got, pp.prefix_project_ref(x, w, b), atol=1e-4, rtol=1e-4)
    assert torch.equal(got, again)


@pytest.mark.parametrize("rows,din,dout", [(1, 256, 3072), (64, 256, 3072), (65, 100, 3000)])
def test_prefix_projector_kernel_misaligned_x(cuda, rows, din, dout):
    """x one element into a buffer takes the kernel's scalar loads and gives
    the bits of the 16-byte loads on an aligned copy."""
    from video_caption_tpu_torch.ops import prefix_projector as pp

    x, w, b = _projector_inputs(rows, din, dout, torch.bfloat16, x_offset=1)
    assert x.data_ptr() % 16 != 0
    got = pp.prefix_project(x, w, b)
    assert torch.equal(got, pp.prefix_project(x.clone(), w, b))
    torch.testing.assert_close(got, pp.prefix_project_ref(x, w, b), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("frames,dtype", [(32, torch.float32), (32, torch.bfloat16),
                                          (3, torch.float32)])
def test_encoder_attention_backward(cuda, frames, dtype):
    _assert_ok(selfcheck.check_encoder_attention_backward(frames, dtype, cuda))


@pytest.mark.parametrize("mode", ["gap", "cls"])
def test_fused_pool_backward(cuda, mode):
    _assert_ok(selfcheck.check_fused_pool_backward(4, 8, mode, cuda))


@pytest.mark.parametrize("rows", [1, 4])
def test_prefix_projector_backward(cuda, rows):
    _assert_ok(selfcheck.check_prefix_projector_backward(rows, cuda))


@pytest.mark.parametrize("case_id", CASE_IDS)
def test_custom_op_on_cuda_against_the_plain_version(cuda, case_id):
    """``torch.ops.vct.<op>`` on CUDA tensors launches the kernel (its
    wrapper's counter moves by one) and agrees with the plain version on the
    same inputs; the op's fake implementation on meta tensors gives the real
    output's shape, strides and dtype."""
    from video_caption_tpu_torch import aot

    case = next(c for c in cases(cuda) if c.id == case_id)
    before = sum(aot.launch_counts().values())
    got = case.run()
    torch.cuda.synchronize()
    assert sum(aot.launch_counts().values()) == before + 1
    for a, b in zip(got, case.run_plain()):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)
    real = case.op(*case.fresh_args())
    fake = case.op(*to_meta(case.fresh_args()))
    assert (fake.shape, fake.stride(), fake.dtype) == (real.shape, real.stride(), real.dtype)


def test_kernel_launch_counters(cuda):
    from video_caption_tpu_torch.ops import encoder_attention as ea

    before = ea.launches
    selfcheck.check_encoder_attention(1, cuda)
    assert ea.launches > before


def test_kernels_launch_on_the_current_stream(cuda):
    from video_caption_tpu_torch.ops import build
    from video_caption_tpu_torch.ops import lm_head as lmh

    x = torch.randn(3, 64, device=cuda).bfloat16()
    w = torch.randn(64, 256, device=cuda).bfloat16()
    want = lmh.lm_head_stats_ref(x, w, 200)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert build.stream_of(x) == side.cuda_stream != torch.cuda.default_stream().cuda_stream
        side.wait_stream(torch.cuda.default_stream())
        got = lmh.lm_head_stats(x, w, 200)
    side.synchronize()
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=1e-4)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from video_caption_tpu_torch.ops import encoder_attention as ea
    from video_caption_tpu_torch.ops import lm_head as lmh

    with pytest.raises(TypeError):
        ea.encoder_attention(torch.zeros(1, 5, 3 * 128, dtype=torch.float16, device=cuda), 2)
    with pytest.raises(ValueError):
        ea.encoder_attention(torch.zeros(1, 5, 3 * 96, device=cuda), 2)   # head dim 48
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError):
            ea.encoder_attention(torch.zeros(1, ea.MAX_SEQ + 1, 3 * 128, dtype=dtype, device=cuda), 2)
    with pytest.raises(ValueError):        # contiguous, but 2 bytes past a 16-byte boundary
        ea.encoder_attention(torch.zeros(1 + 5 * 3 * 128, dtype=torch.bfloat16,
                                         device=cuda)[1:].view(1, 5, 3 * 128), 2)
    with pytest.raises(ValueError):
        lmh.lm_head_stats(torch.zeros(2, 8, device=cuda), torch.zeros(8, 200, device=cuda), 200)
    with pytest.raises(TypeError):         # x and wte_t of two dtypes
        lmh.lm_head_stats(torch.zeros(2, 8, dtype=torch.bfloat16, device=cuda),
                          torch.zeros(8, 256, device=cuda), 200)
    with pytest.raises(ValueError):        # bf16 H not a multiple of 8
        lmh.lm_head_stats(torch.zeros(2, 12, dtype=torch.bfloat16, device=cuda),
                          torch.zeros(12, 256, dtype=torch.bfloat16, device=cuda), 200)


def test_fused_pool_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from video_caption_tpu_torch.ops import fused_pool as fpl

    x = torch.zeros(6, 5, 8, device=cuda)
    with pytest.raises(ValueError):
        fpl.fused_pool_temporal(x, 2, 2, "gap")                       # 6 rows are not 2 x 2
    with pytest.raises(ValueError):
        fpl.fused_pool_temporal(x, 2, 3, "max")
    with pytest.raises(ValueError):
        fpl.fused_pool_temporal(x.transpose(1, 2), 2, 3, "gap")       # not contiguous
    with pytest.raises(TypeError):
        fpl.fused_pool_temporal(x.half(), 2, 3, "gap")


def test_fused_decode_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from video_caption_tpu_torch.ops import decode_attention as da
    from video_caption_tpu_torch.ops import decode_layer as dl

    q = torch.zeros(2, 4, 64, dtype=torch.bfloat16, device=cuda)
    kv = torch.zeros(2, 8, 2, 4, 64, dtype=torch.bfloat16, device=cuda)
    valid = torch.ones(2, 8, dtype=torch.int32, device=cuda)
    head_minor = torch.zeros(2, 8, 64, 4, dtype=torch.bfloat16, device=cuda).permute(0, 1, 3, 2)
    with pytest.raises(ValueError):        # a head's 64 values not contiguous
        da.decode_attention(q, head_minor, kv[:, :, 1], valid)
    with pytest.raises(ValueError):        # valid not int32
        da.decode_attention(q, kv[:, :, 0], kv[:, :, 1], valid.long())
    with pytest.raises(TypeError):
        da.decode_attention(q.float(), kv[:, :, 0], kv[:, :, 1], valid)
    x, kvf, valid, blocks = selfcheck.decode_layer_case(1, cuda, n_layer=1)
    with pytest.raises(ValueError):        # LayerNorm weights must be f32
        dl.gpt2_decode_step(x, kvf, valid, 40, {**blocks, "ln1_scale": blocks["ln1_scale"].bfloat16()},
                            12)
    with pytest.raises(ValueError):
        dl.gpt2_decode_step(x, kvf, valid, 64, blocks, 12)   # offset outside the cache


# ---- norm_act: the LayerNorm and the GELU in bf16 against their plain f32 versions


@pytest.mark.parametrize("w_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("eps", [1e-6, 1e-5])
@pytest.mark.parametrize("rows,h", [(25216, 768), (48, 768), (8, 768), (1, 768), (37, 100)])
def test_layer_norm_kernel(cuda, rows, h, eps, w_dtype):
    """The ViT's rows of a batch of 8 videos, the decode's, one row and an
    odd width: at most 1 bf16 ulp from the plain version, 99.9% bit-equal."""
    _assert_ok(selfcheck.check_layer_norm(rows, cuda, h=h, eps=eps, w_dtype=w_dtype))


@pytest.mark.parametrize("rows,h,offset", [
    (48, 768, 1),        # views off 16 bytes: the element-wise path
    (8, 3072, 0),        # wider than the vector path holds in registers
    (48, 256, 0),        # the vector path with one chunk a lane of its three
    (37, 104, 0)])       # the vector path with part of a lane's chunks
def test_layer_norm_kernel_other_paths(cuda, rows, h, offset):
    _assert_ok(selfcheck.check_layer_norm(rows, cuda, h=h, eps=1e-5, offset=offset))


@pytest.mark.parametrize("approximate", ["tanh", "none"])
@pytest.mark.parametrize("shape", [(25216, 3072), (48, 3072), (1001,)])
def test_gelu_kernel(cuda, shape, approximate):
    _assert_ok(selfcheck.check_gelu(shape, cuda, approximate))


@pytest.mark.parametrize("shape,offset", [((48, 3072), 3), ((1001,), 5), ((9, 3072), 1)])
def test_gelu_kernel_other_paths(cuda, shape, offset):
    """Views off 16 bytes: each element alone."""
    _assert_ok(selfcheck.check_gelu(shape, cuda, offset=offset))


@pytest.mark.parametrize("w_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,h", [(144, 768), (37, 100)])
def test_layer_norm_backward(cuda, rows, h, w_dtype):
    """The mapper step's GPT-2 rows and an odd width: every gradient equals
    autograd's of the plain version."""
    _assert_ok(selfcheck.check_layer_norm_backward(rows, cuda, h=h, w_dtype=w_dtype))


@pytest.mark.parametrize("approximate", ["tanh", "none"])
@pytest.mark.parametrize("shape", [(144, 3072), (1001,)])
def test_gelu_backward(cuda, shape, approximate):
    _assert_ok(selfcheck.check_gelu_backward(shape, cuda, approximate))


def test_norm_act_dispatch_on_cuda(cuda):
    """bf16 on CUDA launches the kernel, under autograd too (the op's
    registered backward gives the gradient); f32 takes the plain version
    (``plain_on_cuda`` counts it) and returns its result bit for bit."""
    from video_caption_tpu_torch.ops import norm_act as na

    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((16, 768), generator=g, device=cuda)
    w, b = torch.ones(768, device=cuda), torch.zeros(768, device=cuda)
    counts = (na.launches, na.plain_on_cuda)
    na.layer_norm(x.bfloat16(), w, b, 1e-5)
    na.gelu(x.bfloat16(), "tanh")
    assert (na.launches, na.plain_on_cuda) == (counts[0] + 2, counts[1])
    assert torch.equal(na.layer_norm(x, w, b, 1e-5), na.layer_norm_ref(x, w, b, 1e-5))
    assert torch.equal(na.gelu(x, "none"), na.gelu_ref(x, "none"))
    xg = x.bfloat16().requires_grad_()
    got = na.layer_norm(xg, w, b, 1e-5)
    assert got.requires_grad and torch.equal(got, na.layer_norm(x.bfloat16(), w, b, 1e-5))
    up = torch.randn(got.shape, generator=g, device=cuda).bfloat16()
    want = torch.autograd.grad(na.layer_norm_ref(xg, w, b, 1e-5), xg, up)[0]
    assert torch.equal(torch.autograd.grad(got, xg, up)[0], want)
    assert na.gelu(xg, "tanh").requires_grad
    assert (na.launches, na.plain_on_cuda) == (counts[0] + 5, counts[1] + 2)


def test_norm_act_rejects_what_the_kernels_do_not_take(cuda):
    from video_caption_tpu_torch.ops import norm_act as na

    x = torch.zeros(4, 64, dtype=torch.bfloat16, device=cuda)
    w, b = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    with pytest.raises(ValueError):        # weight on the CPU, x on CUDA
        na.layer_norm(x, w.cpu(), b, 1e-5)
    with pytest.raises(ValueError):
        torch.ops.vct.layer_norm(x, w, b.cpu(), 1e-5)
    with pytest.raises(ValueError):
        torch.ops.vct.gelu(x, "sigmoid")
    with pytest.raises(TypeError):         # the kernels take bf16 x
        torch.ops.vct.layer_norm(x.float(), w, b, 1e-5)
    with pytest.raises(TypeError):
        torch.ops.vct.gelu(x.double(), "tanh")
    with pytest.raises(TypeError):         # weight and bias of two dtypes
        torch.ops.vct.layer_norm(x, w, b.bfloat16(), 1e-5)
    with pytest.raises(TypeError):         # weights neither bf16 nor f32
        torch.ops.vct.layer_norm(x, w.half(), b.half(), 1e-5)
    with pytest.raises(ValueError):        # weight of another width
        na.layer_norm(x, w[:32], b[:32], 1e-5)


# ---- each kernel of the request path captured alone into a CUDA graph


def _tensors(out):
    return out if isinstance(out, (tuple, list)) else (out,)


def _assert_replays_bit_equal(fn, example, want, generators=()):
    """``fn`` captured alone (aot.RequestGraph) and replayed twice on
    ``example`` gives ``want``'s bits both times."""
    from video_caption_tpu_torch.aot import RequestGraph

    graph = RequestGraph.capture(fn, example, generators)
    for _ in range(2):
        got = graph.replay(example)
        torch.cuda.synchronize()
        for g, w in zip(_tensors(got), _tensors(want), strict=True):
            assert torch.equal(g, w)
    return graph


def test_norm_act_kernels_in_a_graph(cuda):
    from video_caption_tpu_torch.ops import norm_act as na

    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((48, 768), generator=g, device=cuda).bfloat16()
    w = (1 + 0.1 * torch.randn((768,), generator=g, device=cuda)).bfloat16()
    b = (0.1 * torch.randn((768,), generator=g, device=cuda)).bfloat16()

    def fn(v):
        return na.gelu(na.layer_norm(v, w, b, 1e-5), "tanh")

    graph = _assert_replays_bit_equal(fn, x, fn(x))
    assert graph.launches == {na: 2}


def test_encoder_attention_kernel_in_a_graph(cuda):
    from video_caption_tpu_torch.ops import encoder_attention as ea

    qkv = torch.randn((16, 197, 2304), generator=torch.Generator(cuda).manual_seed(0),
                      device=cuda).bfloat16()
    graph = _assert_replays_bit_equal(lambda x: ea.encoder_attention(x, 12), qkv,
                                      ea.encoder_attention(qkv, 12))
    assert {m.__name__.rsplit(".", 1)[-1]: n for m, n in graph.launches.items()} \
        == {"encoder_attention": 1}


def test_prefix_projector_kernel_in_a_graph(cuda):
    from video_caption_tpu_torch.ops import prefix_projector as pp

    g = torch.Generator(cuda).manual_seed(1)
    x = torch.randn((1, 256), generator=g, device=cuda)
    w = (torch.randn((256, 3072), generator=g, device=cuda) * 0.02).bfloat16()
    b = (torch.randn((3072,), generator=g, device=cuda) * 0.02).bfloat16()
    _assert_replays_bit_equal(lambda v: pp.prefix_project(v, w, b), x, pp.prefix_project(x, w, b))


def test_lm_head_kernel_in_a_graph(cuda):
    from video_caption_tpu_torch.ops import lm_head as lmh

    g = torch.Generator(cuda).manual_seed(2)
    x = torch.randn((6, 768), generator=g, device=cuda).bfloat16()
    w = (torch.randn((768, 50304), generator=g, device=cuda) * 0.02).bfloat16()
    w[:, 50257:] = 0
    _assert_replays_bit_equal(lambda v: lmh.lm_head_stats(v, w, 50257), x,
                              lmh.lm_head_stats(x, w, 50257))


@pytest.mark.parametrize("deferred", [False, True])
def test_beam_attention_kernel_in_a_graph(cuda, deferred):
    from video_caption_tpu_torch.ops import beam_attention as ba

    q, k_new, v_new, gkv, pk, pv, valid, anc = selfcheck.beam_attention_case(2, 3, 48, 24, cuda)
    kw = dict(k_new=k_new, v_new=v_new) if deferred else {}
    q = q.contiguous()

    def fn(x):
        return ba.beam_attention(x, gkv, pk, pv, valid, anc, 12, 3, 12, **kw)

    _assert_replays_bit_equal(fn, q, fn(q))


@pytest.mark.parametrize("length", [64, 1024])       # 1024: a cluster launch (cudaLaunchKernelEx)
def test_decode_attention_kernel_in_a_graph(cuda, length):
    from video_caption_tpu_torch.ops import decode_attention as da

    q, k, v, valid = selfcheck.decode_attention_case(1, length, cuda)
    assert (da.plan(1, 12, length, 2).splits > 1) == (length == 1024)
    q = q.contiguous()
    _assert_replays_bit_equal(lambda x: da.decode_attention(x, k, v, valid), q,
                              da.decode_attention(q, k, v, valid))


def test_decode_layer_kernel_in_a_graph(cuda):
    """The cooperative launch captures; each replay gives the eager step's
    bits (output and cache), and leaves every ticket at zero."""
    from video_caption_tpu_torch.ops import decode_layer as dl

    x, kvf, valid, blocks = selfcheck.decode_layer_case(1, cuda)
    kvf_eager, kvf_graph = kvf.clone(), kvf.clone()
    want, _ = dl.gpt2_decode_step(x, kvf_eager, valid, 40, blocks, 12)
    _assert_replays_bit_equal(lambda v: dl.gpt2_decode_step(v, kvf_graph, valid, 40, blocks, 12)[0],
                              x, want)
    assert torch.equal(kvf_graph, kvf_eager)
    assert dl._tickets and all(int(t.abs().sum()) == 0 for t in dl._tickets.values())


def test_request_graph_draws_what_eager_draws(cuda):
    """A generator registered with the graph: each replay draws what the
    same call made eagerly draws, and advances the generator as much."""
    graph_gen = torch.Generator(cuda).manual_seed(9)
    eager_gen = torch.Generator(cuda).manual_seed(9)
    x = torch.zeros(1000, device=cuda)

    def draw(v, gen):
        return v + torch.rand(v.shape, generator=gen, device=v.device)

    from video_caption_tpu_torch.aot import RequestGraph

    graph = RequestGraph.capture(lambda v: draw(v, graph_gen), x, (graph_gen,))
    draws = []
    for _ in range(3):
        got = graph.replay(x).clone()
        want = draw(x, eager_gen)
        assert torch.equal(got, want)
        draws.append(got)
    assert not torch.equal(draws[0], draws[1])
    assert torch.equal(torch.rand(4, generator=graph_gen, device=cuda),
                       torch.rand(4, generator=eager_gen, device=cuda))


def test_build_engine_captures_the_three_stages(cuda, tmp_path):
    from video_caption_tpu_torch import aot
    from video_caption_tpu_torch.config import default_inference_config

    report = aot.build_engine(default_inference_config(ckpt=str(tmp_path / "absent.pt"),
                                                       num_frames=2))
    assert list(report) == ["encoder", "projector", "decoder"]
    for stage in report.values():
        assert stage["compile_s"] > 0 and stage["flops"] is None


def _full_width_engines(tmp_path, **compile_kw):
    """A full-width engine (seeded random weights, 2 frames) on the request
    graph and its eager twin on the same parameters and seed."""
    import dataclasses

    from video_caption_tpu_torch.config import default_inference_config
    from video_caption_tpu_torch.engine import InferenceEngine

    cfg = default_inference_config(ckpt=str(tmp_path / "absent.pt"), num_frames=2)
    cfg = dataclasses.replace(cfg, compile=dataclasses.replace(cfg.compile, **compile_kw))
    graph = InferenceEngine(cfg, seed=4)
    eager = InferenceEngine(dataclasses.replace(cfg, compile=dataclasses.replace(
        cfg.compile, aot_request_program=False)), params=graph.params, seed=4)
    return graph, eager


def _videos(cuda, counts):
    g = torch.Generator(cuda).manual_seed(0)
    return [torch.randint(0, 256, (v, 2, 3, 224, 224), generator=g, device=cuda,
                          dtype=torch.uint8) for v in counts]


def test_request_and_batch_graphs_draw_what_eager_draws(cuda, tmp_path):
    """A bucket-2 graph and the single-request graph, both registering the
    engine's generator, replayed in turns: every replay's ids (the sampled
    group's included) equal the same programs run op by op in that order."""
    import numpy as np

    graph, eager = _full_width_engines(tmp_path)
    for video in _videos(cuda, (2, 1, 2, 1, 1, 2)):
        for got, want in zip(graph.request_ids(video), eager.request_ids(video)):
            assert np.array_equal(got, want)
    assert sorted(k[0] for k in graph._graphs) == [1, 2] and not eager._graphs


def test_dispatch_before_collect_keeps_each_batchs_ids(cuda, tmp_path):
    """Two dispatches of one bucket's graph before either is collected: each
    handle's pinned copy holds its own batch's ids (stream order puts the
    second replay after the first copy)."""
    import numpy as np

    graph, eager = _full_width_engines(tmp_path)
    videos = _videos(cuda, (4, 4))
    handles = [graph._dispatch_videos(v) for v in videos]
    assert all(h.ids.is_pinned() and h.done is not None for h in handles)
    for h, v in zip(handles, videos):
        for got, want in zip(graph._collect_ids(h), eager.request_ids(v)):
            assert np.array_equal(got, want)
