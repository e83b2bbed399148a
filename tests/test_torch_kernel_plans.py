"""The launch plans of the fused_pool, prefix_projector and beam_attention
kernels on the CPU, and the port's C++ frame loader built by several
processes at once.

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
- Six processes started from one barrier build the native loader into one
  empty cache; each loads it and decodes a JPEG equal to PIL's.
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

from torch_kernel_geometries import BEAM_GEOMETRIES, POOL_GEOMETRIES, PROJECTOR_GEOMETRIES
from video_caption_tpu.models import gpt2 as jg2
from video_caption_tpu.ops.pallas import fused_pool as jfp
from video_caption_tpu.ops.pallas import prefix_projector as jpp
from video_caption_tpu_torch.ops import beam_attention as ba
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
