"""The launch plans of the fused_pool and prefix_projector kernels on the
CPU, and the port's C++ frame loader built by several processes at once.

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

from torch_kernel_geometries import POOL_GEOMETRIES, PROJECTOR_GEOMETRIES
from video_caption_tpu.ops.pallas import fused_pool as jfp
from video_caption_tpu.ops.pallas import prefix_projector as jpp
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
