"""A whole K=1 GPT-2 decode step over the flat KV cache (kernel K6).

Counterpart of video_caption_tpu/ops/pallas/decode_layer.py. The CUDA
kernel is ``csrc/decode_layer.cu`` (one cooperative launch per step, every
layer inside, its geometry from :func:`plan`); ``gpt2_decode_step_ref`` is
the plain PyTorch version, the
mirror of the Pallas body ``_decode_step_kernel`` in its rounding order:
LayerNorm in f32 then cast; each product accumulated in f32, cast, and only
then its bias added in the compute dtype; attention probabilities cast
before the product with V (accumulated in f32); both residual adds in the
compute dtype; tanh-GELU in f32.

The flat cache is ``kvf [n_layer, max_len, B, 2H]`` (K in ``[..., :H]``, V in
``[..., H:]``); the step writes its K/V row at ``offset`` IN PLACE. Weights
arrive as ``models/gpt2.prepare_decode_params`` leaves them: LayerNorm
weights in f32, the rest in the compute dtype, projections ``[in, out]``.

Off by default, as in the JAX package; ``GPT2Config.use_pallas_decode_layer``
(``CompileConfig.use_pallas_decode_layer``) selects the flat cache and this
step for greedy/sampled decode.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from video_caption_tpu_torch.ops import build

HEAD_DIM = 64       # the head dim the kernel is built for
THREADS = 256       # threads of a block
TILE = 32           # output columns of a product unit
SLAB_BYTES = 112 * 1024       # a unit's weight slab and biases, at most (two are in shared memory)
ATT_STAGE_BYTES = 48 * 1024   # K and V rows an attention block stages at once
SMEM_LIMIT = 232448           # 227 KB: the most shared memory a block can take
# The plan's cost model of the busiest block's chain in a product phase, in
# ns: estimates fit by hand to this kernel's per-phase stamps on an H100
# (trace_step). A unit's fixed latency (input rows after the barrier,
# LayerNorm, reduction, stores), its slab's bytes (issuing the cp.async
# copies holds the block while the memory system takes them), each slab row
# times each input row (the FMAs), the ticket of a split phase (fence,
# atomic, the partials read back), and each block the phase keeps in the
# grid (its share of the five grid barriers a layer).
UNIT_NS = 1500.0
BYTE_NS = 0.027
MAC_NS = 0.6
TICKET_NS = 1000.0
GRID_NS = 20.0
PHASES = ("qkv", "proj", "fc", "out")
_NEG = -1e30

LN_KEYS = ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias")

launches = 0
"""Number of times ``gpt2_decode_step`` launched its CUDA kernel."""


def _a16(x: int) -> int:
    return -(-x // 16) * 16


def phase_shape(phase: str, h: int) -> Tuple[int, int]:
    """(K, N) of a product phase at width h."""
    return {"qkv": (h, 3 * h), "proj": (h, h), "fc": (h, 4 * h), "out": (4 * h, h)}[phase]


def split_rows(k: int, splits: int) -> int:
    """Rows of a split: ceil(K / splits) rounded up to 8 (16-byte slices)."""
    per = -(-k // splits)
    return -(-per // 8) * 8


def slab_bytes(rows: int, dtype_bytes: int, ln: bool) -> int:
    """A unit's slab: rows x TILE weights, the tile's TILE biases, and for a
    LayerNorm phase (qkv, fc) the f32 scale and shift of its rows."""
    return (rows + 1) * TILE * dtype_bytes + (8 * rows if ln else 0)


def rows_per_pass(batch: int) -> int:
    """Input rows a unit takes in one pass over its slab."""
    return 1 if batch <= 1 else 2 if batch <= 2 else 4 if batch <= 4 else 8


def stage_row_bytes(dtype_bytes: int) -> int:
    """A staged K or V row: 64 values and 16 bytes of padding."""
    return HEAD_DIM * dtype_bytes + 16


def stage_limit(dtype_bytes: int) -> int:
    """K and V rows an attention block stages at once (170 bf16, 90 f32)."""
    return ATT_STAGE_BYTES // (2 * stage_row_bytes(dtype_bytes))


def smem_bytes(dtype_bytes: int, batch: int, rows: int, slab: int, xlen: int,
               stage_rows: int, max_len: int) -> int:
    """The source's ``layout``: two slab buffers, then the larger of the
    products' region (``rows`` input rows of ``xlen`` values, the 8 warps'
    f32 sums of 32 columns a row, 2 f32 statistics a row, a 16-byte flag,
    the residual's tile of ``batch`` x 32 values) and the attention's (K and
    V stages, q, valid flags, f32 logits of the whole cache row, 32 floats
    of block scratch, 8 warps' 68 floats)."""
    gemv = _a16(rows * xlen * dtype_bytes) + 4 * 8 * rows * TILE + _a16(8 * rows) + 16 \
        + _a16(batch * TILE * dtype_bytes)
    att = 2 * stage_rows * stage_row_bytes(dtype_bytes) + HEAD_DIM * dtype_bytes \
        + _a16(4 * stage_rows) + _a16(4 * max_len) + 4 * 32 + 4 * 8 * (HEAD_DIM + 4)
    return 2 * slab + max(gemv, att)


@dataclass(frozen=True)
class Split:
    """One product phase: ``tiles`` tiles of TILE columns, the K rows cut
    into ``splits`` runs of ``rows`` (the last shorter). Unit u is (tile u %
    tiles, split u // tiles); block i takes units i, i + grid, ..."""

    k: int
    n: int
    tiles: int
    splits: int
    rows: int

    @property
    def units(self) -> int:
        return self.tiles * self.splits

    def runs(self) -> Tuple[Tuple[int, int], ...]:
        return tuple((s * self.rows, min(self.k, (s + 1) * self.rows))
                     for s in range(self.splits))


@dataclass(frozen=True)
class Plan:
    """Launch geometry of ``csrc/decode_layer.cu``: ``grid`` blocks of
    THREADS threads (cooperative, every block resident), ``phases`` the four
    products in order, ``rows`` input rows a pass, two weight slabs of
    ``slab`` bytes, ``stage_rows`` K/V rows an attention block stages at
    once, ``smem`` bytes of dynamic shared memory, ``part_floats`` f32
    partial sums of the split phases."""

    batch: int
    width: int
    n_layer: int
    max_len: int
    dtype_bytes: int
    grid: int
    rows: int
    phases: Tuple[Split, ...]
    slab: int
    xlen: int
    stage_rows: int
    smem: int
    part_floats: int

    @property
    def splits(self) -> Tuple[int, ...]:
        return tuple(ph.splits for ph in self.phases)


def _chain_ns(k: int, tiles: int, splits: int, grid: int, batch: int,
              dtype_bytes: int) -> float:
    """The cost model's chain of the busiest block in a phase."""
    rows = split_rows(k, splits)
    unit = UNIT_NS + rows * TILE * dtype_bytes * BYTE_NS + rows * batch * MAC_NS
    return -(-tiles * splits // grid) * unit + (TICKET_NS if splits > 1 else 0.0) \
        + GRID_NS * min(grid, tiles * splits)


def _choose_splits(k: int, tiles: int, grid: int, batch: int, dtype_bytes: int,
                   cap_rows: int) -> int:
    """The split count of the shortest chain (:func:`_chain_ns`) among those
    whose slab rows fit ``cap_rows``; ties to fewer splits."""
    best = None
    for s in range(1, k // 8 + 1):
        rows = split_rows(k, s)
        if rows > cap_rows or (s - 1) * rows >= k:
            continue
        cost = _chain_ns(k, tiles, s, grid, batch, dtype_bytes)
        if best is None or cost < best[0]:
            best = (cost, s)
    if best is None:
        raise ValueError(f"no split of {k} rows fits a slab of {cap_rows} rows")
    return best[1]


def plan(b: int, h: int, n_layer: int, max_len: int, dtype_bytes: int, blocks: int = 132,
         splits: Optional[Tuple[int, int, int, int]] = None) -> Plan:
    """The geometry of one step at batch b, width h (heads of 64) over a
    ``max_len``-row cache in ``dtype_bytes``-byte values, with ``blocks``
    resident blocks (one an SM); the grid is all of them, or the most units
    (or attention's (row, head) pairs) a phase has where that is fewer: a
    block with no work still pays for every grid barrier. Each product
    phase gets the split count
    of :func:`_choose_splits` under a slab cap of SLAB_BYTES (at 132
    blocks, B=1, bf16: QKV 1, proj 1, fc 1, out 5); the slab is the largest
    the splits need (:func:`slab_bytes`), and the cap
    shrinks by 4 KB steps while the shared memory exceeds 227 KB.
    ``splits`` forces the four split counts."""
    if h % HEAD_DIM or b < 1 or max_len < 1 or blocks < 1:
        raise ValueError(f"no plan for B={b}, H={h}, max_len={max_len}, {blocks} blocks")
    rows = rows_per_pass(b)
    stage_rows = min(max_len, stage_limit(dtype_bytes))
    cap_bytes = SLAB_BYTES
    while True:
        phases = []
        for i, name in enumerate(PHASES):
            k, n = phase_shape(name, h)
            ln = name in ("qkv", "fc")
            cap = (cap_bytes - TILE * dtype_bytes) // (TILE * dtype_bytes + (8 if ln else 0))
            s = splits[i] if splits is not None \
                else _choose_splits(k, n // TILE, blocks, b, dtype_bytes, cap)
            r = split_rows(k, s)
            if not 1 <= s <= k // 8 or (s - 1) * r >= k or r > cap:
                raise ValueError(f"{s} splits of {name}'s {k} rows leave one empty or pass "
                                 f"the {cap}-row slab")
            phases.append(Split(k, n, n // TILE, s, r))
        slab = max(slab_bytes(ph.rows, dtype_bytes, name in ("qkv", "fc"))
                   for ph, name in zip(phases, PHASES))
        xlen = max([h] + [ph.rows for ph in phases])
        smem = smem_bytes(dtype_bytes, b, rows, slab, xlen, stage_rows, max_len)
        if smem <= SMEM_LIMIT:
            break
        if splits is not None or cap_bytes <= 8192:
            raise ValueError(f"{smem} bytes of shared memory at B={b}, max_len={max_len}")
        cap_bytes -= 4096
    part = max([ph.units * b * TILE for ph in phases if ph.splits > 1], default=1)
    grid = min(blocks, max([ph.units for ph in phases] + [b * (h // HEAD_DIM)]))
    return Plan(b, h, n_layer, max_len, dtype_bytes, grid, rows, tuple(phases), slab, xlen,
                stage_rows, smem, part)


@functools.lru_cache(maxsize=256)
def _plan_for(b: int, h: int, n_layer: int, max_len: int, dtype_bytes: int, device: int) -> Plan:
    return plan(b, h, n_layer, max_len, dtype_bytes,
                torch.cuda.get_device_properties(device).multi_processor_count)


_tickets: Dict[Tuple[int, int], torch.Tensor] = {}


def _tickets_for(x: torch.Tensor, h: int, stream: int) -> torch.Tensor:
    """The kernel's tile tickets on x's device and stream: zeros once, and
    zero again at the end of every launch (the last block at a tile resets
    it), so they are kept, not cleared per call."""
    key = (x.get_device(), stream)
    t = _tickets.get(key)
    if t is None or t.numel() < 4 * h // TILE:
        if torch.cuda.is_current_stream_capturing():
            # made inside a capture they would come from the graph's private
            # pool, and a later graph on this stream handle would share them
            raise RuntimeError("decode_layer's tickets are made outside a CUDA graph capture: "
                               "run the step once on the capture stream before capturing")
        t = _tickets[key] = torch.zeros(4 * h // TILE, dtype=torch.int32, device=x.device)
    return t


def _ln(xf: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps) * scale + bias


def _product(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated in f32 (both operands upcast: products of bf16
    values are exact in f32), cast to x's dtype, then ``+ b`` in that dtype."""
    return (x.float() @ w.float()).to(x.dtype) + b


def gpt2_decode_step_ref(x: torch.Tensor, kvf: torch.Tensor, valid: torch.Tensor, offset: int,
                         blocks: Dict[str, torch.Tensor], num_heads: int,
                         ln_eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`gpt2_decode_step` (same arguments and result)."""
    dt = x.dtype
    b, h = x.shape
    n_layer, max_len = kvf.shape[:2]
    hd = h // num_heads
    row = torch.arange(max_len, device=x.device)[:, None]
    mask = (row <= offset) & (valid.t() > 0)                               # [L, B]
    for layer in range(n_layer):
        blk = {k: v[layer] for k, v in blocks.items()}
        xn = _ln(x.float(), blk["ln1_scale"], blk["ln1_bias"], ln_eps).to(dt)
        qkv = _product(xn, blk["attn_w"], blk["attn_b"])
        kvf[layer, offset] = qkv[:, h:]
        kc = kvf[layer, :, :, :h].float().reshape(max_len, b, num_heads, hd)
        vc = kvf[layer, :, :, h:].float().reshape(max_len, b, num_heads, hd)
        q = qkv[:, :h].float().reshape(b, num_heads, hd)
        logits = (q[None] * kc).sum(dim=-1) * (hd ** -0.5)                 # [L, B, nh]
        logits = torch.where(mask[:, :, None], logits, _NEG)
        attn = torch.softmax(logits, dim=0).to(dt)
        heads = (attn.float()[..., None] * vc).sum(dim=0).to(dt)           # [B, nh, hd]
        x = x + _product(heads.reshape(b, h), blk["proj_w"], blk["proj_b"])
        mn = _ln(x.float(), blk["ln2_scale"], blk["ln2_bias"], ln_eps).to(dt)
        m = _product(mn, blk["fc_w"], blk["fc_b"])
        m = F.gelu(m.float(), approximate="tanh").to(dt)
        x = x + _product(m, blk["out_w"], blk["out_b"])
    return x, kvf


def gpt2_decode_step(x: torch.Tensor, kvf: torch.Tensor, valid: torch.Tensor, offset: int,
                     blocks: Dict[str, torch.Tensor], num_heads: int,
                     ln_eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every layer of one decode step: x [B, H] in the compute dtype, kvf
    [n_layer, max_len, B, 2H] (its row ``offset`` written in place), valid
    [B, max_len] int32, ``blocks`` the stacked layer weights (LayerNorm in
    f32, the rest in x's dtype). Returns (x_out [B, H], kvf).

    CPU tensors take the plain version; CUDA tensors launch the kernel, which
    takes float32 or bfloat16, head dim 64 and contiguous tensors, and raises
    on anything else (a grid the card cannot hold resident at once included)."""
    if x.device.type == "cpu":
        return gpt2_decode_step_ref(x, kvf, valid, offset, blocks, num_heads, ln_eps)
    build.require_cuda(x, "x")
    build.require_cuda(kvf, "kvf")
    build.require_cuda(valid, "valid")
    b, h = x.shape
    n_layer, max_len = kvf.shape[:2]
    if h != num_heads * HEAD_DIM:
        raise ValueError(f"width {h} is not {num_heads} heads of {HEAD_DIM}")
    if kvf.shape != (n_layer, max_len, b, 2 * h) or kvf.dtype != x.dtype:
        raise ValueError(f"kvf must be [n_layer, max_len, {b}, {2 * h}] in {x.dtype}, got "
                         f"{tuple(kvf.shape)} {kvf.dtype}")
    if valid.dtype != torch.int32 or valid.shape != (b, max_len):
        raise ValueError(f"valid must be int32 [{b}, {max_len}], got {valid.dtype} "
                         f"{tuple(valid.shape)}")
    if not 0 <= offset < max_len:
        raise ValueError(f"offset {offset} outside the {max_len}-row cache")
    shapes = {"ln1_scale": (h,), "ln1_bias": (h,), "ln2_scale": (h,), "ln2_bias": (h,),
              "attn_w": (h, 3 * h), "attn_b": (3 * h,), "proj_w": (h, h), "proj_b": (h,),
              "fc_w": (h, 4 * h), "fc_b": (4 * h,), "out_w": (4 * h, h), "out_b": (h,)}
    for name, shape in shapes.items():
        t = blocks[name]
        build.require_cuda(t, name)
        want = torch.float32 if name in LN_KEYS else x.dtype
        if t.shape != (n_layer, *shape) or t.dtype != want:
            raise ValueError(f"{name} must be {want} {(n_layer, *shape)}, got {t.dtype} "
                             f"{tuple(t.shape)} (prepare_decode_params casts them)")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if x.data_ptr() % 16 or kvf.data_ptr() % 16:
        raise ValueError("x and kvf must be 16-byte aligned")
    p = _plan_for(b, h, n_layer, max_len, x.element_size(), x.get_device())
    return _launch(x, kvf, valid, offset, blocks, num_heads, ln_eps, p)


def _launch(x: torch.Tensor, kvf: torch.Tensor, valid: torch.Tensor, offset: int,
            blocks: Dict[str, torch.Tensor], num_heads: int, ln_eps: float, p: Plan,
            trace: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel under plan ``p`` (the wrapper's checks done);
    ``trace``: int64 [1 + 10 n_layer, grid] for the kernel's %globaltimer
    stamps (:func:`trace_step`)."""
    global launches
    b, h = x.shape
    es = x.element_size()
    out = torch.empty_like(x)
    # one scratch buffer: q [B, H], attn [B, H], hid [B, 4H] in x's dtype, then f32 partials
    sizes = (_a16(b * h * es), _a16(b * h * es), _a16(4 * b * h * es), 4 * p.part_floats)
    scratch = torch.empty(sum(sizes), dtype=torch.uint8, device=x.device)
    base = scratch.data_ptr()
    q, attn, hid, part = (base + sum(sizes[:i]) for i in range(4))
    stream = build.stream_of(x)
    tickets = _tickets_for(x, h, stream)
    build.launch("vct_decode_layer", x.data_ptr(), out.data_ptr(), kvf.data_ptr(),
                 valid.data_ptr(), *(blocks[k].data_ptr() for k in ("ln1_scale", "ln1_bias")),
                 *(blocks[k].data_ptr() for k in ("attn_w", "attn_b", "proj_w", "proj_b")),
                 *(blocks[k].data_ptr() for k in ("ln2_scale", "ln2_bias")),
                 *(blocks[k].data_ptr() for k in ("fc_w", "fc_b", "out_w", "out_b")),
                 q, attn, hid, part, tickets.data_ptr(),
                 trace.data_ptr() if trace is not None else None, b, h, num_heads, p.n_layer, p.max_len,
                 int(offset), float(ln_eps), build.dtype_code(x.dtype), *p.splits, p.slab,
                 p.stage_rows, p.grid, p.rows, p.smem, x.get_device(), stream)
    launches += 1
    return out, kvf


TRACE_PHASES = ("qkv", "attention", "proj", "fc", "out")


def trace_step(x: torch.Tensor, kvf: torch.Tensor, valid: torch.Tensor, offset: int,
               blocks: Dict[str, torch.Tensor], num_heads: int,
               ln_eps: float = 1e-5) -> Dict[str, float]:
    """One step on the card with the kernel's %globaltimer stamps on, read
    back as us summed over the layers: for each phase, ``<phase>`` from the
    last block's exit of the barrier before it (the kernel's start for the
    first QKV) to the last block's end of work, and ``<phase> barrier`` from
    there to the last block's exit of the barrier after it; ``total`` from
    the first stamp to the last. (Thread 0 of each block stores one stamp a
    phase and barrier.)"""
    n_layer = kvf.shape[0]
    p = _plan_for(x.shape[0], x.shape[1], n_layer, kvf.shape[1], x.element_size(),
                  x.get_device())
    trace = torch.zeros((1 + 10 * n_layer, p.grid), dtype=torch.int64, device=x.device)
    _launch(x, kvf, valid, offset, blocks, num_heads, ln_eps, p, trace)
    t = trace.cpu().double() / 1e3
    out = {name: 0.0 for ph in TRACE_PHASES for name in (ph, f"{ph} barrier")}
    for layer in range(n_layer):
        for i, ph in enumerate(TRACE_PHASES):
            s = 1 + 10 * layer + 2 * i
            begin = t[s - 1].max() if s > 1 else t[0].min()
            out[ph] += float(t[s].max() - begin)
            out[f"{ph} barrier"] += float(t[s + 1].max() - t[s].max())
    out["total"] = float(t[-1].max() - t[0].min())
    return out
