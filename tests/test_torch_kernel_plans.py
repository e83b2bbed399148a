"""The launch plans of the fused_pool, prefix_projector, beam_attention and
decode_attention kernels on the CPU, and the port's C++ frame loader built
by several processes at once.

- Each plan (ops/fused_pool.py::plan, ops/prefix_projector.py::plan) over a
  sweep of geometries: every pooled row, or every K index, row of x and
  output column, is covered exactly once, within the limits the C entry
  points check.
- A torch emulation of each kernel's summation order under its plan (f32
  sums of each thread's slice; the slices of an output added in runs of
  neighbouring lanes, in order, and the runs pairwise, as the kernels' warp
  butterflies do; then cluster ranks or K chunks in order) against the JAX
  package's ``_xla_pool`` and
  ``prefix_project``, from numpy inputs made from a seed, at the kernels'
  f32 tolerances (1e-5 pool, 1e-4 projector).
- beam_attention (ops/beam_attention.py::plan) over every step of a sweep
  of geometries in both modes and both dtypes: the chunks cover every
  logical column once, hold at most ``stage_rows`` rows, start exactly above
  the staging limit, and the shared memory stays within 227 KB; a numpy
  mirror of the kernel (staged rows looked up through the ancestry, a dot per
  (beam, column) in eight interleaved sums, the warp softmax, AV by column
  groups, the self column last) against the JAX package's ``_beam_attend`` at 1e-5.
- decode_attention (ops/decode_attention.py::plan) over B in {1, 3, 64} and
  L in {1, 17, 64, 300, 1024} in both dtypes, as planned and under every
  forced split and chunking: each cache row is read by exactly one block of
  its (row, head), a cluster holds at most 8 blocks, the shared memory stays
  within 227 KB; a torch mirror of the kernel's split-and-combine order (f32
  logits from four 16-dim partial dots, the online softmax over chunks, AV
  by column groups, the groups and warps added in order, the cluster's
  blocks rescaled and added in rank order) against the Pallas kernel in
  interpret mode at 1e-5 abs + 1e-4 rel, with split and chunked plans, a
  row with no visible column and stale columns holding 1e4.
- decode_layer (ops/decode_layer.py::plan) over B in {1, 3, 8, 64}, H in
  {256, 768}, max_len in {1, 20, 64, 1024} in both dtypes, with 132 blocks
  and with fewer: each weight element of each product phase belongs to
  exactly one (tile, split) and each unit to one block, the grid is the
  blocks given, the shared memory stays within 227 KB; a torch mirror of
  the kernel's split-K order (per split: thread groups over strided rows,
  a warp's groups pairwise, the warps in order; then the splits in order)
  through a whole 2-layer step at width 128, against the Pallas kernel in
  interpret mode at 1e-5 abs + 1e-4 rel.
- Six processes started from one barrier build the native loader into one
  empty cache; each loads it and decodes a JPEG equal to PIL's.
- The tensor-parallel shapes (a rank's 6 or 3 of 12 heads): the
  beam-attention plan over them, and encoder_attention's and
  beam_attention's plain versions on a head group's columns equal to the
  whole 12-head call's columns of those heads (and beam_attention's to the
  JAX package's ``_beam_attend`` at the local heads).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from jax.experimental.pallas import tpu as pltpu
from torch_kernel_geometries import (BEAM_GEOMETRIES, BEAM_TP_GEOMETRIES, DECODE_GEOMETRIES,
                                     ENCODER_TP_GEOMETRIES, LAYER_GEOMETRIES, POOL_GEOMETRIES,
                                     PROJECTOR_GEOMETRIES)
from video_caption_tpu.models import gpt2 as jg2
from video_caption_tpu.ops.pallas import decode_attention as jda
from video_caption_tpu.ops.pallas import decode_layer as jdl
from video_caption_tpu.ops.pallas import fused_pool as jfp
from video_caption_tpu.ops.pallas import prefix_projector as jpp
from video_caption_tpu_torch.ops import beam_attention as ba
from video_caption_tpu_torch.ops import decode_attention as da
from video_caption_tpu_torch.ops import decode_layer as dl
from video_caption_tpu_torch.ops import encoder_attention as ea
from video_caption_tpu_torch.ops import fused_pool as fpl
from video_caption_tpu_torch.ops import prefix_projector as pp

ROOT = Path(__file__).resolve().parents[1]
SMEM_LIMIT = 200 * 1024          # csrc/prefix_projector.cu kMaxSmem


# ---- fused_pool ------------------------------------------------------------

def _pool_row_counts(p: fpl.Plan) -> np.ndarray:
    """How often the kernel reads each pooled row of a video under plan p."""
    counts = np.zeros(p.rows, np.int64)
    for split in range(p.splits):
        begin = split * p.rows_per_split
        end = min(p.rows, begin + p.rows_per_split)
        for lane in range(p.lanes):
            counts[begin + lane:end:p.lanes] += 1
    return counts


@pytest.mark.parametrize("dtype_bytes", [4, 2])
@pytest.mark.parametrize("batch,frames,seq,h", POOL_GEOMETRIES)
def test_fused_pool_plan_reads_every_row_once(batch, frames, seq, h, dtype_bytes):
    for mode in ("gap", "cls"):
        p = fpl.plan(batch, frames, seq, h, dtype_bytes, mode=mode)
        assert p.rows == frames * (seq - 1 if mode == "gap" else 1)
        assert (_pool_row_counts(p) == 1).all(), p
        # the C entry point's checks
        assert 1 <= p.splits <= fpl.MAX_SPLITS and p.splits * p.rows_per_split >= p.rows
        assert (p.splits - 1) * p.rows_per_split < p.rows
        assert p.tile_vecs in (4, 8, 16, 32) and p.lanes * p.tile_vecs == fpl.THREADS
        assert p.vec * dtype_bytes == 16 and p.tile_vecs * p.vec <= 256
        tile_cols = p.tile_vecs * p.vec
        assert (p.tiles - 1) * tile_cols < h <= p.tiles * tile_cols
        assert p.blocks == p.splits * p.tiles * batch
    if (batch, frames, seq) == (4, 8, 197) and h >= 768:
        assert fpl.plan(batch, frames, seq, h, dtype_bytes).blocks >= 2 * 132


def _pairwise(values):
    """A warp butterfly's sum of a power-of-two list: neighbours pairwise,
    level by level."""
    while len(values) > 1:
        values = [values[i] + values[i + 1] for i in range(0, len(values), 2)]
    return values[0]


def _lane_sum(lane_sums, run):
    """The kernels' block reduction: runs of ``run`` neighbouring lanes
    summed in order, the runs pairwise."""
    runs = []
    for start in range(0, len(lane_sums), run):
        s = torch.zeros_like(lane_sums[0])
        for lane in range(start, start + run):
            s = s + lane_sums[lane]
        runs.append(s)
    return _pairwise(runs)


def _emulate_pool(tokens: torch.Tensor, batch: int, frames: int, mode: str,
                  p: fpl.Plan) -> torch.Tensor:
    """The kernel's order: each thread's rows summed in f32, the row lanes of
    a block in runs of ``vec`` lanes then pairwise, the blocks of a cluster
    in rank order, one division by the row count."""
    _, seq, h = tokens.shape
    x = tokens.float().view(batch, frames, seq, h)
    pooled = (x[:, :, 1:] if mode == "gap" else x[:, :, :1]).reshape(batch, p.rows, h)
    total = torch.zeros(batch, h)
    for split in range(p.splits):
        begin = split * p.rows_per_split
        end = min(p.rows, begin + p.rows_per_split)
        lanes = [pooled[:, begin + lane:end:p.lanes].sum(dim=1) for lane in range(p.lanes)]
        total = total + _lane_sum(lanes, p.vec)
    return total / p.rows


@pytest.mark.parametrize("batch,frames,seq,h,mode", [
    (4, 8, 197, 64, "gap"), (3, 5, 17, 100, "gap"), (2, 8, 197, 770, "cls"), (1, 1, 2, 64, "gap")])
def test_fused_pool_summation_order_matches_jax(batch, frames, seq, h, mode):
    tokens = np.random.RandomState(11).randn(batch * frames, seq, h).astype(np.float32)
    p = fpl.plan(batch, frames, seq, h, 4, mode=mode)
    got = _emulate_pool(torch.from_numpy(tokens), batch, frames, mode, p)
    want = np.asarray(jfp._xla_pool(jnp.asarray(tokens), batch, frames, mode))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


# ---- prefix_projector -------------------------------------------------------

def _projector_counts(p: pp.Plan, rows: int, din: int):
    """How often the kernel takes each K index and each row of x under plan p."""
    k_counts, row_counts = np.zeros(din, np.int64), np.zeros(rows, np.int64)
    for k0 in range(0, din, p.kc):
        kn = min(p.kc, din - k0)
        for lane in range(p.klanes):
            k_counts[k0 + lane:k0 + kn:p.klanes] += 1
    for r0 in range(0, rows, p.row_chunk):
        rn = min(p.row_chunk, rows - r0)
        for group in range(p.rowgroups):
            for i in range(p.rows_per_thread):
                if group + i * p.rowgroups < rn:
                    row_counts[r0 + group + i * p.rowgroups] += 1
    return k_counts, row_counts


@pytest.mark.parametrize("rows,din,dout", PROJECTOR_GEOMETRIES)
def test_prefix_projector_plan_takes_every_k_and_row_once(rows, din, dout):
    for w_bytes in (2, 4):
        p = pp.plan(rows, din, dout, w_bytes)
        k_counts, row_counts = _projector_counts(p, rows, din)
        assert (k_counts == 1).all() and (row_counts == 1).all(), p
        assert (p.blocks - 1) * pp.COLS < dout <= p.blocks * pp.COLS
        # the C entry point's checks, and a warp inside one row group
        assert p.rowgroups in (1, 2, 4, 8) and p.rows_per_thread in (1, 2, 4, 8)
        assert 1 <= p.kc <= pp.MAX_KC and p.row_chunk == p.rowgroups * p.rows_per_thread
        assert p.groups * p.klanes * p.rowgroups == pp.THREADS and p.groups * p.klanes >= 32
        assert p.vec * w_bytes == 16 and p.smem <= SMEM_LIMIT
        if dout == 3072:
            assert p.blocks >= 96


def _emulate_projector(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       p: pp.Plan) -> torch.Tensor:
    """The kernel's order: each K lane's products summed in f32; the lanes
    in runs of klanes / sub (sub threads an output, as many as a full pass
    of row_chunk rows leaves the block, up to 8) then pairwise; the K chunks
    in order, the bias last."""
    rows, din = x.shape
    y = None
    for k0 in range(0, din, p.kc):
        kn = min(p.kc, din - k0)
        lanes = [x[:, ks] @ w[ks] for ks in (torch.arange(k0 + lane, k0 + kn, p.klanes)
                                             for lane in range(p.klanes))]
        passes = []
        for r0 in range(0, rows, p.row_chunk):
            rn = min(p.row_chunk, rows - r0)
            sub = 1
            while sub < 8 and 2 * sub <= p.klanes and 2 * sub * p.row_chunk * pp.COLS <= pp.THREADS:
                sub *= 2
            passes.append(_lane_sum([lane[r0:r0 + rn] for lane in lanes], p.klanes // sub))
        chunk = torch.cat(passes)
        y = chunk if y is None else y + chunk
    return y + b


@pytest.mark.parametrize("rows,din,dout", [(1, 256, 3072), (4, 256, 3072), (65, 100, 300),
                                           (9, 600, 64)])
def test_prefix_projector_summation_order_matches_jax(rows, din, dout):
    rng = np.random.RandomState(12)
    x = (rng.randn(rows, din) * 0.4).astype(np.float32)
    w = (rng.randn(din, dout) * 0.02).astype(np.float32)
    b = (rng.randn(dout) * 0.02).astype(np.float32)
    p = pp.plan(rows, din, dout, 2)
    got = _emulate_projector(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), p)
    want = np.asarray(jpp.prefix_project(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


# ---- beam_attention ---------------------------------------------------------

def _staged_rows(chunk, s0, steps, beams):
    """Rows the kernel stages for logical columns [l0, l1): one a prefill
    column, ``beams`` a generated step."""
    l0, l1 = chunk
    prefill = max(0, min(s0, l1) - l0)
    return prefill + (l1 - l0 - prefill) * beams


def _beam_smem(p: ba.Plan, s0: int, dtype_bytes: int, deferred: bool) -> int:
    """The shared memory the plan's regions need, counted afresh."""
    def a16(x):
        return -(-x // 16) * 16

    stage = 2 * p.stage_rows * (64 * dtype_bytes + 16)
    rows_of_q = p.beams * 64 * dtype_bytes * (3 if deferred else 1)
    per_beam = a16(4 * p.beams * (s0 + p.steps + 1))
    return stage + rows_of_q + 2 * per_beam + a16(4 * s0) + a16(4 * p.beams * p.steps) \
        + ba.THREADS * 8 * 4


@pytest.mark.parametrize("videos,beams,s0,n", BEAM_GEOMETRIES)
def test_beam_attention_plan_stages_every_column_once(videos, beams, s0, n):
    for dtype_bytes in (2, 4):
        limit = ba.stage_limit(dtype_bytes)
        for deferred in (False, True):
            for t in range(n):
                p = ba.plan(videos, beams, s0, n, t, dtype_bytes, deferred)
                steps = t if deferred else t + 1
                assert p.steps == steps and p.rows == s0 + beams * steps
                assert p.stage_rows == min(p.rows, limit) and p.stage_rows >= min(p.rows, beams)
                covered = [l for l0, l1 in p.chunks for l in range(l0, l1)]
                assert covered == list(range(s0 + steps)), p
                assert all(_staged_rows(c, s0, steps, beams) <= p.stage_rows for c in p.chunks)
                assert (len(p.chunks) > 1) == (p.rows > limit), p   # chunks exactly above it
                assert p.smem == _beam_smem(p, s0, dtype_bytes, deferred) <= ba.SMEM_LIMIT
                assert p.groups * beams * 8 <= ba.THREADS


def test_beam_attention_plan_limits():
    """The staging limit in rows (96 KB of padded K and V rows), and the
    largest call the wrapper takes within 227 KB."""
    assert ba.stage_limit(2) == 341 and ba.stage_limit(4) == 180
    assert ba.plan(2, 3, 48, 24, 12, 2, False).chunks == ((0, 61),)
    assert len(ba.plan(1, 4, 48, 40, 39, 4, False).chunks) == 2      # f32, 208 rows
    p = ba.plan(1, ba.MAX_BEAMS, ba.MAX_PREFILL, 64, 63, 4, True)
    assert p.smem <= ba.SMEM_LIMIT and len(p.chunks) > 1


def _fma(acc, x, y):
    """f32 fused multiply-add, through f64 (the f32 product is exact there)."""
    return np.float32(np.float64(acc) + np.float64(x) * np.float64(y))


def _warp_sum(lanes):
    """vct::warp_sum: a butterfly over 32 lanes, offsets 16, 8, 4, 2, 1."""
    v = np.asarray(lanes, np.float32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[np.arange(32) ^ o]).astype(np.float32)
    return v[0]


def _dot64(a, b):
    """The kernel's dot64: value j into sum j mod 8 in order, the eight sums
    added pairwise."""
    sums = [np.float32(0)] * 8
    for j in range(64):
        sums[j % 8] = _fma(sums[j % 8], a[j], b[j])
    return _pairwise(sums)


def _emulate_beam_attention(q, gkv, pk, pv, valid, anc, t, k, dtype_bytes,
                            k_new=None, v_new=None):
    """numpy mirror of csrc/beam_attention.cu for one head of 64 (f32 data,
    the ``dtype_bytes`` plan): per video, the staged K/V rows of each chunk,
    each (beam, column) logit the kernel's dot64 (masked columns
    -1e30, an ancestor outside the video masked), the warp softmax per beam
    (32 lanes each summing columns lane, lane + 32, ..., then the butterfly),
    AV by column groups l = g (mod groups) summed in order, the groups added
    in order, the self column last."""
    b_count, s0 = valid.shape
    deferred = k_new is not None
    out = np.zeros(q.shape, np.float32)
    for b in range(b_count):
        p = ba.plan(b_count, k, s0, gkv.shape[0], t, dtype_bytes, deferred)
        lcols, row0 = s0 + p.steps, b * k
        lg = np.zeros((k, lcols + 1), np.float32)
        rows = np.zeros((k, lcols), np.int64)
        staged = {}
        for l0, l1 in p.chunks:
            prefill = max(0, min(s0, l1) - l0)
            g0 = max(l0, s0) - s0
            gen = [(g0 + rr // k, row0 + rr % k) for rr in range((l1 - l0 - prefill) * k)]
            for which, pre in ((0, pk), (1, pv)):
                staged[l0, which] = np.concatenate(
                    [pre[b, l0:l0 + prefill]] + [gkv[nn, which, wr][None] for nn, wr in gen])
            for kq in range(k):
                for l in range(l0, l1):
                    if l < s0:
                        vis, row = valid[b, l] > 0, l - l0
                    else:
                        kv = anc[row0 + kq, l - s0] - row0
                        vis = 0 <= kv < k
                        row = prefill + (l - s0 - g0) * k + (kv if vis else 0)
                    rows[kq, l] = row
                    dot = _dot64(q[row0 + kq], staged[l0, 0][row])
                    lg[kq, l] = dot * np.float32(0.125) if vis else np.float32(-1e30)
        if deferred:
            for kq in range(k):
                lg[kq, lcols] = _dot64(q[row0 + kq], k_new[row0 + kq]) * np.float32(0.125)
        ncols = lcols + int(deferred)
        for kq in range(k):
            row = lg[kq, :ncols]
            mx = row.max()
            lanes = [np.float32(0)] * 32
            for c in range(ncols):
                lanes[c % 32] = np.float32(lanes[c % 32] + np.exp(row[c] - mx, dtype=np.float32))
            lg[kq, :ncols] = np.exp(row - mx, dtype=np.float32) / _warp_sum(lanes)
        for kq in range(k):
            partials = []
            for g in range(p.groups):
                acc = np.zeros(64, np.float32)
                for l0, l1 in p.chunks:
                    for l in range(l0, l1):
                        if l % p.groups == g:
                            acc = (np.float64(acc) + np.float64(lg[kq, l])
                                   * np.float64(staged[l0, 1][rows[kq, l]])).astype(np.float32)
                partials.append(acc)
            s = np.zeros(64, np.float32)
            for part in partials:
                s = (s + part).astype(np.float32)
            if deferred:
                s = (np.float64(s) + np.float64(lg[kq, lcols]) * np.float64(v_new[row0 + kq])
                     ).astype(np.float32)
            out[row0 + kq] = s
    return out


@pytest.mark.parametrize("b,k,s0,n,t,dtype_bytes,deferred", [
    (2, 3, 7, 6, 0, 4, False), (2, 3, 7, 6, 5, 4, True), (1, 4, 5, 6, 3, 2, True),
    (2, 2, 0, 3, 0, 4, True), (1, 4, 160, 24, 20, 4, False), (1, 4, 160, 24, 20, 4, True)])
def test_beam_attention_kernel_order_matches_jax(b, k, s0, n, t, dtype_bytes, deferred):
    """One head of 64; the last two cases run 244 and 240 rows in f32, over
    the 180-row limit: two chunks."""
    rng = np.random.RandomState(14 + t)
    r = b * k
    q, k_new, v_new = (rng.randn(r, 64).astype(np.float32) for _ in range(3))
    gkv = rng.randn(n, 2, r, 64).astype(np.float32)
    pk, pv = (rng.randn(b, s0, 64).astype(np.float32) for _ in range(2))
    valid = (rng.rand(b, s0) > 0.3).astype(np.int32)
    anc = (np.arange(r)[:, None] // k * k + rng.randint(0, k, (r, n))).astype(np.int32)
    anc[0, 0] = (anc[0, 0] + k) % (r + k)      # an ancestor outside the video: masked
    extra = dict(k_new=k_new, v_new=v_new) if deferred else {}
    got = _emulate_beam_attention(q, gkv, pk, pv, valid, anc, t, k, dtype_bytes, **extra)
    cfg = jg2.GPT2Config(vocab_size=64, n_embd=64, n_layer=1, n_head=1, dtype=jnp.float32)
    sel = jg2.ancestry_mask(jnp.asarray(anc), b, k, jnp.int32(t - 1 if deferred else t))
    want = jg2._beam_attend(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
                            jnp.asarray(gkv[:, 0]), jnp.asarray(gkv[:, 1]), jnp.asarray(valid),
                            sel, jg2.head_block_mask(cfg), k, cfg,
                            **{key: jnp.asarray(v) for key, v in extra.items()})
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    if s0 == 160:
        assert len(ba.plan(b, k, s0, n, t, dtype_bytes, deferred).chunks) == 2


# ---- decode_attention -------------------------------------------------------

def _decode_smem(p: da.Plan, dtype_bytes: int) -> int:
    """The shared memory the plan's regions need, counted afresh: K and V
    stages of padded rows, q, valid and logits of a chunk, 4 warp maxima, 4
    warps' (acc[64], sum) padded to 68 floats, and a cluster's 68 floats a
    block in rank 0."""
    def a16(x):
        return -(-x // 16) * 16

    return 2 * p.stage_rows * (64 * dtype_bytes + 16) + 64 * dtype_bytes \
        + 2 * a16(4 * p.stage_rows) + 4 * 4 + 4 * 4 * 68 \
        + (4 * 68 * p.splits if p.splits > 1 else 0)


def _decode_plans(batch, length, dtype_bytes):
    """The plan and every forced geometry: splits 1, 2, 4, 8 that leave no
    block empty, each staging its run at once or in chunks of half of it."""
    yield da.plan(batch, 12, length, dtype_bytes)
    for splits in (1, 2, 4, 8):
        cols = -(-length // splits)
        if (splits - 1) * cols >= length:
            with pytest.raises(ValueError):
                da.plan(batch, 12, length, dtype_bytes, splits=splits)
            continue
        most = min(cols, da.stage_limit(dtype_bytes))
        for stage_rows in {most, min(most, -(-cols // 2))}:
            yield da.plan(batch, 12, length, dtype_bytes, splits=splits, stage_rows=stage_rows)


@pytest.mark.parametrize("dtype_bytes", [2, 4])
@pytest.mark.parametrize("batch,length", DECODE_GEOMETRIES)
def test_decode_attention_plan_reads_every_row_once(batch, length, dtype_bytes):
    for p in _decode_plans(batch, length, dtype_bytes):
        counts = np.zeros(length, np.int64)
        for begin, end in p.runs():
            assert begin < end, p                      # no block without a column
            chunks = p.chunks(begin, end)
            assert all(c1 - c0 <= p.stage_rows for c0, c1 in chunks), p
            for c0, c1 in chunks:
                counts[c0:c1] += 1
        assert (counts == 1).all(), p
        assert 1 <= p.splits <= da.MAX_SPLITS and p.grid == (p.splits, 12, batch)
        assert p.stage_rows <= da.stage_limit(dtype_bytes)
        assert p.smem == _decode_smem(p, dtype_bytes) <= da.SMEM_LIMIT, p


def test_decode_attention_plan_choices():
    """One block per (row, head) at the request's B=1, L=64 and at B=64;
    clusters where a block would hold more than 16 KB of K and V and the
    card is not full; chunks of equal size beyond 96 KB of K and V a block,
    or 64 KB once the grid holds more than two blocks an SM."""
    assert da.stage_limit(2) == 341 and da.stage_limit(4) == 180
    p = da.plan(1, 12, 64, 2)
    assert (p.splits, p.stage_rows, p.runs()) == (1, 64, ((0, 64),))
    assert da.plan(64, 12, 64, 2).splits == 1 and da.plan(64, 12, 1024, 2).splits == 1
    assert da.plan(1, 12, 64, 4).splits == 2                  # 32 KB of f32 K and V
    assert da.plan(2, 12, 300, 2).splits == 8 and da.plan(1, 12, 1024, 2).cols == 128
    assert da.plan(1, 12, 4096, 2).chunks(0, 512) == ((0, 256), (256, 512))   # equal chunks
    assert da.plan(64, 12, 300, 2).stage_rows == 150          # 64 KB stages: the card is full
    assert da.plan(64, 12, 1024, 2).stage_rows == 205 and da.plan(2, 12, 1024, 2).cols == 128
    with pytest.raises(ValueError):
        da.plan(1, 12, 64, 2, splits=16)
    with pytest.raises(ValueError):
        da.plan(1, 12, 64, 2, stage_rows=65)


def _emulate_decode_attention(q, k, v, valid, p: da.Plan) -> torch.Tensor:
    """torch mirror of csrc/decode_attention.cu in f32 for all (row, head)
    at once: per block of the plan, per chunk, logits from four 16-dim
    partial dots added pairwise (select -1e30 where not visible), the
    running max and the rescale of the sums (a factor of 0 clears them), p =
    exp(l - m), AV by column groups (row r of a chunk in group r mod 16, in
    order, p * v added only where p != 0); the 16 groups added pairwise in
    fours (a warp), the 4 warps in order; then the cluster's blocks rescaled
    by exp(m_r - M) (skipped where 0) and added in rank order."""
    b, nh, hd = q.shape
    scale = torch.tensor(hd ** -0.5, dtype=torch.float32)
    qq = q.reshape(b, nh, 4, 16)
    stats = []
    for begin, end in p.runs():
        acc = torch.zeros(b, nh, da.ROW_GROUPS, hd)
        psum = torch.zeros(b, nh, da.ROW_GROUPS)
        m_run = torch.full((b, nh), -torch.inf)
        for c0, c1 in p.chunks(begin, end):
            kk = k[:, c0:c1].reshape(b, c1 - c0, nh, 4, 16)
            quarters = torch.einsum("bhqd,blhqd->bhlq", qq, kk)
            dot = (quarters[..., 0] + quarters[..., 1]) + (quarters[..., 2] + quarters[..., 3])
            lg = torch.where(valid[:, None, c0:c1] > 0, dot * scale, torch.tensor(-1e30))
            m_new = torch.maximum(m_run, lg.amax(dim=-1))
            f = torch.exp(m_run - m_new)
            acc = torch.where(f[..., None, None] != 0, acc * f[..., None, None], 0.0)
            psum = torch.where(f[..., None] != 0, psum * f[..., None], 0.0)
            m_run = m_new
            pr = torch.exp(lg - m_new[..., None])                      # [b, nh, n]
            for r0 in range(0, c1 - c0, da.ROW_GROUPS):
                rows = torch.arange(r0, min(c1 - c0, r0 + da.ROW_GROUPS))
                pg = pr[:, :, rows]                                     # groups 0..len-1
                vg = v[:, c0 + rows].permute(0, 2, 1, 3)                # [b, nh, g, hd]
                n = len(rows)
                acc[:, :, :n] = torch.where(pg[..., None] != 0, acc[:, :, :n] + pg[..., None] * vg,
                                            acc[:, :, :n])
                psum[:, :, :n] = torch.where(pg != 0, psum[:, :, :n] + pg, psum[:, :, :n])
        o, s = torch.zeros(b, nh, hd), torch.zeros(b, nh)
        for w in range(da.ROW_GROUPS // 4):
            g = 4 * w
            o = o + ((acc[:, :, g] + acc[:, :, g + 1]) + (acc[:, :, g + 2] + acc[:, :, g + 3]))
            s = s + ((psum[:, :, g] + psum[:, :, g + 1]) + (psum[:, :, g + 2] + psum[:, :, g + 3]))
        stats.append((o, m_run, s))
    if p.splits == 1:
        o, _, s = stats[0]
        return o / s[..., None]
    big = torch.stack([m for _, m, _ in stats]).amax(dim=0)
    o, s = torch.zeros(b, nh, hd), torch.zeros(b, nh)
    for o_r, m_r, s_r in stats:
        w = torch.exp(m_r - big)
        o = torch.where(w[..., None] != 0, o + o_r * w[..., None], o)
        s = torch.where(w != 0, s + s_r * w, s)
    return o / s[..., None]


@pytest.mark.parametrize("b,nh,length,dtype_bytes,splits,stage_rows", [
    (2, 2, 64, 2, None, None),      # the request's plan: one block, one chunk
    (1, 2, 300, 2, None, None),     # 8 blocks of 38 columns
    (2, 2, 300, 4, 4, 20),          # 4 blocks of 75 columns, chunks of 20
    (3, 2, 17, 4, None, 5),         # one block, chunks of 5
    (2, 1, 1024, 2, None, None)])   # 8 blocks of 128 columns
def test_decode_attention_kernel_order_matches_pallas(b, nh, length, dtype_bytes, splits,
                                                      stage_rows):
    """Row 0 has no visible column (its output is the mean of its V rows,
    stale ones included); row 1 is left-padded over 60% of the columns, so
    leading blocks and chunks see none; every column that is not visible
    holds 1e4 in K and V."""
    rng = np.random.RandomState(15 + length)
    q = rng.randn(b, nh, 64).astype(np.float32)
    k, v = (rng.randn(b, length, nh, 64).astype(np.float32) for _ in range(2))
    valid = (rng.rand(b, length) > 0.3).astype(np.int32)
    valid[0] = 0
    if b > 1:
        valid[1, : length * 3 // 5] = 0
    k[valid == 0] = 1e4
    v[valid == 0] = 1e4
    p = da.plan(b, nh, length, dtype_bytes, splits=splits, stage_rows=stage_rows)
    assert (p.splits == 1 and p.stage_rows == length) == (length == 64)   # else split or chunked
    got = _emulate_decode_attention(*(torch.from_numpy(x) for x in (q, k, v, valid)), p)
    with pltpu.force_tpu_interpret_mode():
        want = jda.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(valid))
        assert jda.last_backend == "pallas"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)


# ---- decode_layer ------------------------------------------------------------

def _layer_smem(p: dl.Plan) -> int:
    """The shared memory the plan needs, counted afresh: two slabs, then the
    larger of the products' region (input rows, 8 warps' sums of 32
    columns a row, 2 statistics a row, a flag, the residual's B x 32 tile)
    and the attention's (padded K and V stages, q, valid flags, logits of
    the whole row, block scratch, 8 warps' 68 floats)."""
    def a16(x):
        return -(-x // 16) * 16

    es = p.dtype_bytes
    gemv = a16(p.rows * p.xlen * es) + 4 * 8 * p.rows * 32 + a16(8 * p.rows) + 16 \
        + a16(p.batch * 32 * es)
    att = 2 * p.stage_rows * (64 * es + 16) + 64 * es + a16(4 * p.stage_rows) \
        + a16(4 * p.max_len) + 128 + 4 * 8 * 68
    return 2 * p.slab + max(gemv, att)


@pytest.mark.parametrize("blocks", [132, 40])
@pytest.mark.parametrize("dtype_bytes", [2, 4])
@pytest.mark.parametrize("batch,h,max_len", LAYER_GEOMETRIES)
def test_decode_layer_plan_takes_every_weight_once(batch, h, max_len, dtype_bytes, blocks):
    p = dl.plan(batch, h, 12, max_len, dtype_bytes, blocks)
    most = max([ph.units for ph in p.phases] + [batch * h // 64])
    assert p.grid == min(blocks, most) and p.rows == dl.rows_per_pass(batch)
    assert [(ph.k, ph.n) for ph in p.phases] == [(h, 3 * h), (h, h), (h, 4 * h), (4 * h, h)]
    for ph in p.phases:
        counts = np.zeros((ph.k, ph.n), np.int64)
        owner = np.zeros(ph.units, np.int64)
        for block in range(p.grid):
            for u in range(block, ph.units, p.grid):   # the kernel's units of a block
                owner[u] += 1
                tile, split = u % ph.tiles, u // ph.tiles
                k0, k1 = ph.runs()[split]
                assert k0 < k1 and k1 - k0 <= ph.rows and k0 % 8 == 0, ph
                assert dl.slab_bytes(ph.rows, dtype_bytes, ph.n != h and ph.k == h) <= p.slab, ph
                counts[k0:k1, tile * 32:(tile + 1) * 32] += 1
        assert (counts == 1).all() and (owner == 1).all(), ph
        # a phase with fewer tiles than blocks gives the blocks more units
        assert ph.units >= min(p.grid, ph.tiles)
    assert p.xlen == max([h] + [ph.rows for ph in p.phases])
    assert 1 <= p.stage_rows == min(max_len, dl.stage_limit(dtype_bytes))
    assert p.smem == _layer_smem(p) <= dl.SMEM_LIMIT, p
    split = [ph for ph in p.phases if ph.splits > 1]
    assert p.part_floats == max([ph.units * batch * 32 for ph in split], default=1)


def test_decode_layer_plan_choices():
    """B=1 in bf16: one unit a block, out split 4 ways (3072 rows pass the
    slab), a grid of 96 (no phase has more units); B=8 splits proj and out
    over 120 blocks; B=64 splits every phase (8 passes a slab), several units
    a block on all 132; one block takes the whole step; a forced split count
    that leaves a split empty or passes the slab is refused."""
    p = dl.plan(1, 768, 12, 64, 2)
    assert p.splits == (1, 1, 1, 4) and p.grid == 96
    assert p.slab == 769 * 32 * 2 + 8 * 768   # QKV, fc: rows, biases, LayerNorm weights
    assert [ph.units for ph in p.phases] == [72, 24, 96, 96]
    assert (dl.plan(8, 768, 12, 64, 2).splits, dl.plan(8, 768, 12, 64, 2).grid) == ((1, 3, 1, 5), 120)
    assert dl.plan(64, 768, 12, 64, 2).splits == (3, 5, 4, 11)
    assert dl.plan(64, 768, 12, 64, 2).grid == 132
    one = dl.plan(1, 768, 12, 64, 2, blocks=1)
    assert one.grid == 1 and one.splits == (1, 1, 1, 2)
    assert dl.plan(1, 768, 12, 20000, 4).smem <= dl.SMEM_LIMIT    # the logits of a long row
    with pytest.raises(ValueError):
        dl.plan(1, 768, 12, 64, 2, splits=(1, 1, 1, 1))           # out: 3072 rows > the slab
    with pytest.raises(ValueError):
        dl.plan(1, 768, 12, 64, 2, splits=(97, 1, 1, 5))          # more splits than 8-row runs
    with pytest.raises(ValueError):
        dl.plan(1, 700, 12, 64, 2)                                # not heads of 64


def _emulate_product(x: torch.Tensor, w: torch.Tensor, ph: dl.Split) -> torch.Tensor:
    """x [B, K] @ w [K, N] in f32 in the order of csrc/decode_layer.cu (f32:
    8 threads across a 32-column tile, 32 row groups): per split, group g
    sums the split's rows g, g + 32, ... in order; the 4 groups of a warp
    pairwise (the shuffle butterfly), the 8 warps in order from 0; then the
    splits in order from 0 (the last arriver's sum)."""
    groups, per_warp = 32, 4
    total = None
    for k0, k1 in ph.runs():
        xs, ws = x[:, k0:k1], w[k0:k1]
        sums = []
        for g in range(groups):
            acc = torch.zeros(x.shape[0], w.shape[1])
            for k in range(g, k1 - k0, groups):
                acc = acc + xs[:, k:k + 1] * ws[k]
            sums.append(acc)
        s = torch.zeros(x.shape[0], w.shape[1])
        for wp in range(groups // per_warp):
            g = sums[wp * per_warp:(wp + 1) * per_warp]
            s = s + ((g[0] + g[1]) + (g[2] + g[3]))
        total = s if ph.splits == 1 else (torch.zeros_like(s) if total is None else total) + s
    return total


def _emulate_decode_step(x, kvf, valid, offset, blocks, nh, eps, p: dl.Plan):
    """The f32 step of csrc/decode_layer.cu: the LayerNorms and the
    attention as the plain version computes them, the four products in the
    kernel's split-K order."""
    h = x.shape[1]
    qkv_ph, proj_ph, fc_ph, out_ph = p.phases
    row = torch.arange(kvf.shape[1])[:, None]
    mask = (row <= offset) & (valid.t() > 0)
    for layer in range(kvf.shape[0]):
        blk = {k: v[layer] for k, v in blocks.items()}
        xn = dl._ln(x, blk["ln1_scale"], blk["ln1_bias"], eps)
        qkv = _emulate_product(xn, blk["attn_w"], qkv_ph) + blk["attn_b"]
        kvf[layer, offset] = qkv[:, h:]
        kc = kvf[layer, :, :, :h].reshape(kvf.shape[1], -1, nh, 64)
        vc = kvf[layer, :, :, h:].reshape(kvf.shape[1], -1, nh, 64)
        q = qkv[:, :h].reshape(-1, nh, 64)
        logits = torch.where(mask[:, :, None], (q[None] * kc).sum(-1) * 0.125, -1e30)
        heads = (torch.softmax(logits, dim=0)[..., None] * vc).sum(0).reshape(-1, h)
        x = x + (_emulate_product(heads, blk["proj_w"], proj_ph) + blk["proj_b"])
        mn = dl._ln(x, blk["ln2_scale"], blk["ln2_bias"], eps)
        m = torch.nn.functional.gelu(_emulate_product(mn, blk["fc_w"], fc_ph) + blk["fc_b"],
                                     approximate="tanh")
        x = x + (_emulate_product(m, blk["out_w"], out_ph) + blk["out_b"])
    return x, kvf


@pytest.mark.parametrize("batch,offset,blocks,splits", [
    (1, 9, 132, None), (3, 0, 132, (2, 4, 2, 8)), (3, 15, 4, (4, 1, 3, 16))])
def test_decode_layer_split_order_matches_pallas(batch, offset, blocks, splits):
    """2 layers at width 128 (2 heads) over a 16-row cache in f32: row 0 is
    left-padded, rows past the offset hold 1e4; the plan's geometry (out
    split 5 ways) and two forced ones that split more, the last with 4
    blocks taking several units each."""
    rng = np.random.RandomState(20 + offset)
    n_layer, h, max_len = 2, 128, 16

    def nrm(*shape, std=0.2):
        return (rng.randn(*shape) * std).astype(np.float32)

    blocks_np = {"ln1_scale": 1 + nrm(n_layer, h, std=0.1), "ln1_bias": nrm(n_layer, h, std=0.1),
                 "attn_w": nrm(n_layer, h, 3 * h), "attn_b": nrm(n_layer, 3 * h, std=0.1),
                 "proj_w": nrm(n_layer, h, h), "proj_b": nrm(n_layer, h, std=0.1),
                 "ln2_scale": 1 + nrm(n_layer, h, std=0.1), "ln2_bias": nrm(n_layer, h, std=0.1),
                 "fc_w": nrm(n_layer, h, 4 * h), "fc_b": nrm(n_layer, 4 * h, std=0.1),
                 "out_w": nrm(n_layer, 4 * h, h), "out_b": nrm(n_layer, h, std=0.1)}
    x = nrm(batch, h, std=1.0)
    kvf = nrm(n_layer, max_len, batch, 2 * h, std=1.0)
    kvf[:, offset + 1:] = 1e4
    valid = np.zeros((batch, max_len), np.int32)
    valid[:, :offset + 1] = 1
    valid[0, :min(3, offset)] = 0
    p = dl.plan(batch, h, n_layer, max_len, 4, blocks, splits=splits)
    assert p.splits == (splits or (1, 1, 1, 5))
    got, got_kvf = _emulate_decode_step(torch.from_numpy(x), torch.from_numpy(kvf.copy()),
                                        torch.from_numpy(valid), offset,
                                        {k: torch.from_numpy(v) for k, v in blocks_np.items()},
                                        h // 64, 1e-5, p)
    with pltpu.force_tpu_interpret_mode():
        want, want_kvf = jdl.gpt2_decode_step(jnp.asarray(x), jnp.asarray(kvf),
                                              jnp.asarray(valid), jnp.int32(offset),
                                              {k: jnp.asarray(v) for k, v in blocks_np.items()},
                                              h // 64, 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got_kvf.numpy(), np.asarray(want_kvf), atol=1e-5, rtol=1e-4)


# ---- the native loader, built by six processes at once -----------------------

_BUILD_AND_DECODE = r"""
import os, sys, time
from pathlib import Path
import numpy as np
from video_caption_tpu_torch.native import loader
from video_caption_tpu_torch.preprocessing.frame_loader import load_image_u8
ready, n, jpeg, size = Path(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4])
(ready / str(os.getpid())).touch()
while len(list(ready.iterdir())) < n:      # the barrier: every process imported
    time.sleep(0.001)
out = loader.load_frames_native_u8([jpeg], size, n_threads=1)
assert out is not None, loader.last_error
np.testing.assert_array_equal(out[0], load_image_u8(jpeg, size))
print("decoded", loader.last_backend)
"""


def test_native_loader_builds_atomically_under_concurrent_processes(tmp_path):
    jpeg = tmp_path / "frame_00000.jpg"
    Image.fromarray(np.random.RandomState(13).randint(0, 255, (48, 64, 3), np.uint8)).save(
        jpeg, quality=95)
    cache, ready, n = tmp_path / "cache", tmp_path / "ready", 6
    ready.mkdir()
    env = {**os.environ, "VIDEO_CAPTION_TORCH_NATIVE_CACHE": str(cache)}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_DECODE, str(ready), str(n),
                               str(jpeg), "32"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for _ in range(n)]
    outs = [proc.communicate(timeout=240)[0] for proc in procs]
    for proc, out in zip(procs, outs):
        assert proc.returncode == 0 and "decoded native" in out, out
    libs = sorted(p.name for p in cache.iterdir())
    assert len(libs) == 1 and libs[0].startswith("libvct_loader_") and libs[0].endswith(".so")
    assert ".tmp" not in libs[0]


def test_sweep_plans_needs_a_gpu(capsys):
    from video_caption_tpu_torch.cli import sweep_plans

    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a GPU")
    assert sweep_plans.main([]) == 1
    assert "NVIDIA GPU" in capsys.readouterr().err


# ---- the tensor-parallel shapes ---------------------------------------------

def _head_group(x: torch.Tensor, heads: int, group: int, groups: int, parts: int = 1):
    """The columns of head group ``group`` of ``groups`` in each of the
    ``parts`` [heads * 64] thirds of x's last dim (a rank's fused QKV shard
    for parts=3)."""
    per = heads // groups * 64
    t = x.unflatten(-1, (parts, heads * 64))[..., group * per:(group + 1) * per]
    return t.flatten(-2)


@pytest.mark.parametrize("frames,seq,heads", ENCODER_TP_GEOMETRIES)
def test_encoder_attention_on_a_head_group(frames, seq, heads):
    """The plain version at a rank's heads, on its head-grouped fused QKV,
    equals the 12-head call's output columns of those heads, in f32."""
    groups = 12 // heads
    qkv = torch.randn((frames, seq, 3 * 12 * 64), generator=torch.Generator().manual_seed(heads))
    whole = ea.encoder_attention_ref(qkv, 12)
    for g in range(groups):
        got = ea.encoder_attention_ref(_head_group(qkv, 12, g, groups, 3).contiguous(), heads)
        torch.testing.assert_close(got, _head_group(whole, 12, g, groups), rtol=0, atol=1e-6)


@pytest.mark.parametrize("videos,beams,s0,n,heads", BEAM_TP_GEOMETRIES)
def test_beam_attention_on_a_head_group(videos, beams, s0, n, heads):
    """The plan at every step stages every column once (it does not depend
    on the heads: the grid is (videos, heads)); the plain version at a
    rank's heads on its head group's columns equals the 12-head call's
    columns of those heads and the JAX package's ``_beam_attend`` at the
    local heads, at t = 0, N/2 and N-1 in both modes, in f32."""
    groups = 12 // heads
    live = (beams, beams, 1) if videos == 3 else None
    q, k_new, v_new, gkv, pk, pv, valid, anc = selfcheck_case(videos, beams, s0, n, live)
    jcfg = jg2.GPT2Config(vocab_size=64, n_embd=heads * 64, n_layer=1, n_head=heads,
                          dtype=jnp.float32)
    for t in sorted({0, n // 2, n - 1}):
        for deferred in (False, True):
            p = ba.plan(videos, beams, s0, n, t, 4, deferred)
            covered = [l for l0, l1 in p.chunks for l in range(l0, l1)]
            assert covered == list(range(s0 + p.steps))
            kw = dict(k_new=k_new, v_new=v_new) if deferred else {}
            whole = ba.beam_attention_ref(q, gkv, pk, pv, valid, anc, t, beams, 12, **kw)
            sel = jg2.ancestry_mask(jnp.asarray(anc.numpy()), videos, beams,
                                    jnp.int32(t - 1 if deferred else t))
            for g in range(groups):
                def grp(x):
                    return _head_group(x, 12, g, groups).contiguous()
                local = {k: grp(v) for k, v in kw.items()}
                got = ba.beam_attention_ref(grp(q), grp(gkv), grp(pk), grp(pv), valid, anc, t,
                                            beams, heads, **local)
                torch.testing.assert_close(got, grp(whole), rtol=0, atol=1e-6)
                want = jg2._beam_attend(
                    jnp.asarray(grp(q).numpy()), jnp.asarray(grp(pk).numpy()),
                    jnp.asarray(grp(pv).numpy()), jnp.asarray(grp(gkv)[:, 0].numpy()),
                    jnp.asarray(grp(gkv)[:, 1].numpy()), jnp.asarray(valid.numpy()), sel,
                    jg2.head_block_mask(jcfg), beams, jcfg,
                    **{k: jnp.asarray(v.numpy()) for k, v in local.items()})
                np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def selfcheck_case(videos, beams, s0, n, live):
    """ops/selfcheck.py's seeded beam-attention inputs at 12 heads in f32."""
    from video_caption_tpu_torch.ops import selfcheck

    return selfcheck.beam_attention_case(videos, beams, s0, n, "cpu", heads=12,
                                         dtype=torch.float32, live=live)
