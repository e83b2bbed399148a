"""GPT-2 decoder with a static-shape KV cache (counterpart of
video_caption_tpu/models/gpt2.py).

Parameters keep the JAX package's layout (blocks stacked along a leading
layer axis, projections stored ``[in, out]`` as in HF GPT-2's Conv1D). The
cache layouts of the JAX package:

- contiguous ``[L, B, max_len, 2, nh, hd]`` for greedy/sampled decode, read
  by plain PyTorch attention, or with ``use_pallas_decode`` by the
  decode-attention kernel (ops/decode_attention.py) at one query token;
- flat ``kvf [L, max_len, B, 2H]`` with ``use_pallas_decode_layer``: the
  prefill runs over a contiguous cache and is reshaped into it once, and
  every K=1 step runs all layers in the decode-layer kernel
  (ops/decode_layer.py);
- for beam search, a read-only prefill cache ``{k, v: [L, B, S0, H]}``
  shared by a video's beams plus an append-only, time-major generated cache
  ``[L, N, 2, R, H]`` read by the beam-attention kernel
  (ops/beam_attention.py) through the ancestry index ``anc``;
- the same split pair at K=1 with ``sample_split_cache`` (off by default,
  as in the JAX package): greedy/sampled steps through
  ``gpt2_sample_step``, whose attention (``_sample_attend``) is plain
  PyTorch, as it is XLA einsums there.

Both decode switches are off by default, as in the JAX package; with both
set, the flat cache (decode_layer) takes the step. ``deferred_cache_write``
(off by default, as there) holds each layer's new K/V of a decode step and
writes them all in one store after the layer loop; attention then reads the
cache strictly before the step and takes the step's own K/V as an extra
column (``_attend_deferred`` for K=1, the beam-attention kernel's deferred
mode for beams). The flat cache still takes precedence, and with
``use_pallas_decode`` set as well the K=1 step takes ``_attend_deferred``,
as in the JAX package.

Unlike the JAX package, the caches are updated IN PLACE: a forward writes
its new K/V rows into the buffer it was given and returns the same dict.
That is why the training forward (``gpt2_logits_nocache``, teacher forcing)
has no cache at all: each layer attends over its own K/V, since an in-place
write would bump the version of a tensor autograd saved for the backward.
The LM head of every decode step runs through the lm-head kernel
(ops/lm_head.py), which also emits the selection statistics.

The four block matmul weights may be stored int8 with f32 scales
(models/quantize.py); every product takes its weight through
``block_weight``, which dequantizes it into the compute dtype.

Under a mesh with a model axis (``GPT2Config.mesh``, parallel/mesh.py) the
blocks hold the rank's head group: ``attn`` and ``fc`` are column parallel,
``proj`` and ``out`` row parallel (their biases added once, after the
all-reduce), the caches hold the local heads (``local_heads``,
``local_embd``) and the attention kernels run on them. The inference
placement keeps ``wte`` replicated, so every model rank computes the full
logits and selects on its own. The training placement shards ``wte``'s
vocab where it divides: ``gpt2_logits_nocache`` then returns the rank's
vocab shard of the logits and ``lm_loss`` takes the vocab-parallel
cross-entropy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from video_caption_tpu_torch.models.quantize import block_weight, is_quantized
from video_caption_tpu_torch.models.vit import linear, row_linear
from video_caption_tpu_torch.ops.beam_attention import beam_attention
from video_caption_tpu_torch.ops.decode_attention import decode_attention
from video_caption_tpu_torch.ops.decode_layer import gpt2_decode_step
from video_caption_tpu_torch.ops.lm_head import WINDOW, lm_head_stats
from video_caption_tpu_torch.ops.norm_act import gelu, layer_norm
from video_caption_tpu_torch.parallel import collectives as coll

Params = Dict[str, Any]
Cache = Dict[str, torch.Tensor]
_NEG = -1e30


@dataclass(frozen=True)
class GPT2Config:
    """Geometry of HF ``gpt2`` base."""

    vocab_size: int = 50257
    max_position_embeddings: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    dtype: torch.dtype = torch.bfloat16
    ln_eps: float = 1e-5
    use_pallas_decode: bool = False
    """K=1 decode attention through the decode-attention kernel."""
    use_pallas_decode_layer: bool = False
    """K=1 decode steps through the whole-step decode-layer kernel over the
    flat ``kvf`` cache (init_cache). Takes precedence over use_pallas_decode."""
    deferred_cache_write: bool = False
    """Decode steps hold every layer's new K/V and write the whole stack
    with one store after the layer loop; attention takes the current token
    as an explicit extra column. Tokens are those of the per-layer writes."""
    sample_split_cache: bool = False
    """Greedy/sampled (K=1) decode over the beam path's split cache: the
    prefill K/V once per row ([L,B,S0,H], heads merged, read-only) and a
    time-major generated region [L,N,2,B,H] (``gpt2_sample_step``). Taken
    only when neither use_pallas_decode_layer nor use_pallas_decode is on;
    tokens are those of the contiguous cache."""
    mesh: Any = None
    """The rank's ``parallel.mesh.Mesh``: with a model axis above 1 the
    blocks hold the rank's head group (tensor parallel); under a data axis
    above 1 ``lm_loss`` divides by the token count of the whole batch."""

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def local_heads(self) -> int:
        """Heads of this rank: all of them, or its group under TP."""
        return self.n_head // self.mesh.model if coll.tensor_parallel(self.mesh) else self.n_head

    @property
    def local_embd(self) -> int:
        """Width of this rank's attention (its heads times ``head_dim``)."""
        return self.local_heads * self.head_dim


def init_gpt2_params(gen: torch.Generator, cfg: GPT2Config, device) -> Params:
    """Random parameters with the shapes and stddevs of the JAX init."""
    h, d, mlp = cfg.n_embd, cfg.n_layer, 4 * cfg.n_embd

    def nrm(*shape):
        return torch.randn(shape, generator=gen, device=device) * 0.02

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    def ones(*shape):
        return torch.ones(shape, device=device)

    return {
        "wte": nrm(cfg.vocab_size, h),
        "wpe": nrm(cfg.max_position_embeddings, h),
        "blocks": {
            "ln1_scale": ones(d, h), "ln1_bias": zeros(d, h),
            "attn_w": nrm(d, h, 3 * h), "attn_b": zeros(d, 3 * h),
            "proj_w": nrm(d, h, h), "proj_b": zeros(d, h),
            "ln2_scale": ones(d, h), "ln2_bias": zeros(d, h),
            "fc_w": nrm(d, h, mlp), "fc_b": zeros(d, mlp),
            "out_w": nrm(d, mlp, h), "out_b": zeros(d, h),
        },
        "lnf_scale": ones(h),
        "lnf_bias": zeros(h),
    }


def init_cache(cfg: GPT2Config, batch: int, max_len: int, device,
               layout: str = "auto") -> Cache:
    """Zeroed KV cache in the compute dtype: ``contiguous`` {kv: [L, B,
    max_len, 2, nh, hd]} (K at index 0, V at 1), ``kvf`` {kvf: [L, max_len,
    B, 2H]} (K in [..., :H], V in [..., H:]) or ``beam_gen`` {kv: [L,
    max_len(N), 2, batch(R), H]} (the generated region of the beam step's
    split cache, and of the K=1 step's at batch B); ``auto`` is ``kvf`` with
    use_pallas_decode_layer, else ``contiguous``. Unlike the JAX package the
    flat layout is not gated on the device: on the CPU its step runs the
    kernel's plain version."""
    if layout == "auto":
        layout = "kvf" if cfg.use_pallas_decode_layer else "contiguous"
    if layout == "kvf":
        if coll.tensor_parallel(cfg.mesh):
            raise NotImplementedError("use_pallas_decode_layer under a model axis above 1: the "
                                      "kernel runs all layers in one launch, with no room for "
                                      "the all-reduce of a row-parallel product")
        shape = (cfg.n_layer, max_len, batch, 2 * cfg.n_embd)
        return {"kvf": torch.zeros(shape, dtype=cfg.dtype, device=device)}
    if layout == "beam_gen":
        shape = (cfg.n_layer, max_len, 2, batch, cfg.local_embd)
    elif layout == "contiguous":
        shape = (cfg.n_layer, batch, max_len, 2, cfg.local_heads, cfg.head_dim)
    else:
        raise ValueError(f"unknown cache layout {layout!r}")
    return {"kv": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def padded_vocab(cfg: GPT2Config) -> int:
    """Vp: the vocabulary rounded up to a multiple of the 128-column
    selection window (the JAX package rounds further to 1408 multiples for
    its TPU chunking; that does not carry over)."""
    return -(-cfg.vocab_size // WINDOW) * WINDOW


def lm_head_t(params: Params, cfg: GPT2Config) -> torch.Tensor:
    """Transposed LM head [H, Vp] in the compute dtype, Vp =
    ``padded_vocab(cfg)``. Pad columns are zero; the kernel masks their
    logits to -inf."""
    v = cfg.vocab_size
    vp = padded_vocab(cfg)
    wte_t = params["wte"].to(cfg.dtype).t()
    return F.pad(wte_t, (0, vp - v)) if vp != v else wte_t.contiguous()


def lm_stats(x2: torch.Tensor, wte_t: torch.Tensor, cfg: GPT2Config,
             need_row_stats: bool) -> Tuple:
    """(logits [R,Vp] f32 with -inf pads, wmax [R,Vp/128], m [R] | None,
    l [R] | None) — m/l (row max, row sum-exp) only with need_row_stats."""
    logits, wmax, m, l = lm_head_stats(x2.to(cfg.dtype).contiguous(), wte_t, cfg.vocab_size)
    if not need_row_stats:
        m = l = None
    return logits, wmax, m, l


def prepare_decode_params(params: Params, cfg: GPT2Config) -> Params:
    """The stacked block weights as the decode-layer kernel takes them, cast
    once per generate call (outside the step loop): LayerNorm weights in
    f32, the rest in the compute dtype. The kernel reads plain weights, so
    int8 blocks are refused (the engine turns the kernel off under int8)."""
    if is_quantized(params["blocks"]):
        raise ValueError("the decode-layer kernel takes plain weights, not int8 blocks")
    blocks = {k: v.float() if k.startswith("ln") else v.to(cfg.dtype)
              for k, v in params["blocks"].items()}
    return {**params, "blocks": blocks}


def _position_embeds(params: Params, positions: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """wpe rows of ``positions``, clamped into the table as JAX clamps an
    out-of-range gather (a long prompt plus a long decode can pass the end
    of a small position table)."""
    wpe = params["wpe"]
    return wpe[positions.clamp(0, wpe.shape[0] - 1)].to(dt)


def _mlp(x: torch.Tensor, blk: Params, cfg: GPT2Config) -> torch.Tensor:
    a_in = coll.column_input(layer_norm(x, blk["ln2_scale"], blk["ln2_bias"], cfg.ln_eps),
                             cfg.mesh)
    m = linear(a_in, block_weight(blk, "fc_w", x.dtype), blk["fc_b"])
    m = gelu(m, "tanh")
    return row_linear(m, block_weight(blk, "out_w", x.dtype), blk["out_b"], cfg.mesh)


def _qkv(a_in: torch.Tensor, blk: Params, cfg: GPT2Config) -> torch.Tensor:
    """The fused QKV product: [.., 3 * local_embd], the rank's head group."""
    a_in = coll.column_input(a_in, cfg.mesh)
    return linear(a_in, block_weight(blk, "attn_w", a_in.dtype), blk["attn_b"])


def _proj(a_out: torch.Tensor, blk: Params, cfg: GPT2Config) -> torch.Tensor:
    return row_linear(a_out, block_weight(blk, "proj_w", a_out.dtype), blk["proj_b"], cfg.mesh)


def _attend(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
            offset: int, valid_mask: torch.Tensor, cfg: GPT2Config) -> torch.Tensor:
    """Attention of S new tokens at positions [offset, offset+S) against the
    cache that already holds their K/V (plain PyTorch, as XLA computes it):
    q [B,S,nh,hd], caches [B,max_len,nh,hd] -> [B,S,H] (before the output
    projection)."""
    dt = cfg.dtype
    b, s = q.shape[0], q.shape[1]
    if cfg.use_pallas_decode and s == 1:
        # one query token: valid_mask marks only the columns up to its
        # position, so it already encodes causality
        out = decode_attention(q[:, 0], k_cache, v_cache, valid_mask)
        return out.reshape(b, 1, cfg.local_embd)
    max_len = k_cache.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_cache.float()) \
        * (cfg.head_dim ** -0.5)
    col = torch.arange(max_len, device=q.device)
    row = offset + torch.arange(s, device=q.device)
    mask = (col[None, :] <= row[:, None])[None, None] & (valid_mask[:, None, None, :] > 0)
    attn = torch.softmax(torch.where(mask, logits, _NEG), dim=-1).to(dt)
    out = torch.einsum("bhqk,bkhd->bqhd", attn, v_cache.to(dt))
    return out.reshape(b, s, cfg.local_embd)


def _attend_deferred(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     k_new: torch.Tensor, v_new: torch.Tensor, offset: int,
                     valid_mask: torch.Tensor, cfg: GPT2Config) -> torch.Tensor:
    """Single-token attention of the deferred-write step: q, k_new, v_new
    [B,1,nh,hd], caches [B,max_len,nh,hd] WITHOUT the new token -> [B,1,H]
    (before the output projection). The cache part is strictly causal (col <
    offset: the current column is stale) and the new token's self term is
    one extra column, last; the masking and softmax formula of ``_attend``."""
    dt = cfg.dtype
    b, max_len = q.shape[0], k_cache.shape[1]
    scale = cfg.head_dim ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_cache.float()) * scale
    col = torch.arange(max_len, device=q.device)
    mask = (col < offset)[None, None, None, :] & (valid_mask[:, None, None, :] > 0)
    logits = torch.where(mask, logits, _NEG)                              # [B,nh,1,max_len]
    lg_self = torch.einsum("bqhd,bqhd->bhq", q.float(),
                           k_new.to(q.dtype).float())[..., None] * scale  # [B,nh,1,1]
    attn = torch.softmax(torch.cat([logits, lg_self], dim=-1), dim=-1).to(dt)
    out = torch.einsum("bhqk,bkhd->bqhd", attn[..., :max_len], v_cache.to(dt))
    out = out + attn[..., max_len:].permute(0, 3, 1, 2) * v_new.to(dt)
    return out.reshape(b, 1, cfg.local_embd)


def gpt2_forward(
    params: Params,
    inputs_embeds: torch.Tensor,   # [B,S,H]
    positions: torch.Tensor,       # [B,S] absolute position ids
    valid_mask: torch.Tensor,      # [B,max_len] 1 where a real token sits
    cache: Cache,                  # contiguous or flat (kvf); updated in place
    offset: int,                   # cache write offset
    cfg: GPT2Config,
    wte_t: Optional[torch.Tensor] = None,
    last_only: bool = False,
    return_stats: bool = False,
    row_stats: bool = True,
) -> Tuple[Any, Cache]:
    """Prefill (S > 1 at offset 0) and single-token decode (S == 1 at offset
    t). Returns (logits, cache): the lm_stats 4-tuple of the last position
    over ``wte_t`` with ``return_stats`` (the decode path), else [B,S,V] f32
    logits of every position."""
    if "kvf" in cache:
        return _forward_kvf(params, inputs_embeds, positions, valid_mask, cache, offset, cfg,
                            wte_t, last_only, return_stats, row_stats)
    dt = cfg.dtype
    x = inputs_embeds.to(dt) + _position_embeds(params, positions, dt)
    b, s = x.shape[:2]
    kv = cache["kv"]
    blocks = params["blocks"]
    deferred = cfg.deferred_cache_write and s == 1
    kv_news = []
    for layer in range(cfg.n_layer):
        blk = {k: v[layer] for k, v in blocks.items()}
        a_in = layer_norm(x, blk["ln1_scale"], blk["ln1_bias"], cfg.ln_eps)
        qkv = _qkv(a_in, blk, cfg).reshape(b, s, 3, cfg.local_heads, cfg.head_dim)
        if deferred:
            # the new K/V wait for one stacked write after the loop
            kv_news.append(qkv[:, 0, 1:3])
            a_out = _attend_deferred(qkv[:, :, 0], kv[layer, :, :, 0], kv[layer, :, :, 1],
                                     qkv[:, :, 1], qkv[:, :, 2], offset, valid_mask, cfg)
        else:
            kv[layer, :, offset:offset + s] = qkv[:, :, 1:3].to(kv.dtype)
            a_out = _attend(qkv[:, :, 0], kv[layer, :, :, 0], kv[layer, :, :, 1],
                            offset, valid_mask, cfg)
        x = x + _proj(a_out, blk, cfg)
        x = x + _mlp(x, blk, cfg)
    if deferred:
        kv[:, :, offset] = torch.stack(kv_news).to(kv.dtype)     # [L, B, 2, nh, hd]
    if last_only and s > 1:
        x = x[:, -1:, :]
    x = layer_norm(x, params["lnf_scale"], params["lnf_bias"], cfg.ln_eps)
    if return_stats:
        return lm_stats(x[:, -1, :], wte_t, cfg, need_row_stats=row_stats), cache
    return x.float() @ params["wte"].to(dt).float().t(), cache


def _forward_kvf(params, inputs_embeds, positions, valid_mask, cache, offset, cfg,
                 wte_t, last_only, return_stats, row_stats):
    """gpt2_forward over the flat cache. A step (S == 1) runs every layer in
    the decode-layer kernel (weights as prepare_decode_params leaves them),
    then the final LayerNorm and the LM head; a prefill runs over a
    contiguous cache and copies it once into ``kvf`` [L, max_len, B, 2H]."""
    kvf = cache["kvf"]
    b, s = inputs_embeds.shape[:2]
    if s > 1:
        stacked = init_cache(cfg, b, kvf.shape[1], kvf.device, layout="contiguous")
        out, stacked = gpt2_forward(params, inputs_embeds, positions, valid_mask, stacked,
                                    offset, cfg, wte_t=wte_t, last_only=last_only,
                                    return_stats=return_stats, row_stats=row_stats)
        kvf.copy_(stacked["kv"].reshape(cfg.n_layer, b, kvf.shape[1], 2 * cfg.n_embd)
                  .transpose(1, 2))
        return out, cache
    dt = cfg.dtype
    x = inputs_embeds[:, 0].to(dt) + _position_embeds(params, positions[:, 0], dt)
    xb, _ = gpt2_decode_step(x, kvf, valid_mask, offset, params["blocks"], cfg.n_head, cfg.ln_eps)
    xb = layer_norm(xb, params["lnf_scale"], params["lnf_bias"], cfg.ln_eps)
    if return_stats:
        return lm_stats(xb, wte_t, cfg, need_row_stats=row_stats), cache
    return (xb.float() @ params["wte"].to(cfg.dtype).float().t())[:, None], cache


def gpt2_beam_step(
    params: Params,
    token_embeds: torch.Tensor,    # [R, H] one new token per beam row (R = B*K)
    positions: torch.Tensor,       # [R] absolute position ids
    prefill_cache: Cache,          # {k, v: [L, B, S0, H]} read-only, shared by beams
    prefill_valid: torch.Tensor,   # [B, S0] int32 left-pad flags
    gen_cache: Cache,              # {kv: [L, N, 2, R, H]} append-only, updated in place
    anc: torch.Tensor,             # [R, N] int32 writer row of each gen column
    t: int,                        # current step (gen column)
    num_beams: int,
    cfg: GPT2Config,
    wte_t: torch.Tensor,           # [H, Vp]
) -> Tuple[Tuple, Cache]:
    """One beam-search decode step over the split cache: writes step t's K/V
    at gen column t of every row, attends through the beam-attention kernel,
    and returns (lm_stats 4-tuple with row stats, gen_cache). With
    ``deferred_cache_write`` the kernel runs in its deferred mode (the new
    K/V as the self column) and all layers' K/V land in one [L, 2, R, H]
    store after the layer loop."""
    dt = cfg.dtype
    r, h = token_embeds.shape[0], cfg.local_embd
    x = token_embeds.to(dt) + _position_embeds(params, positions, dt)   # [R, H]
    gkv = gen_cache["kv"]
    pk_all, pv_all = prefill_cache["k"], prefill_cache["v"]
    blocks = params["blocks"]
    deferred = cfg.deferred_cache_write
    kv_news = []
    for layer in range(cfg.n_layer):
        blk = {k: v[layer] for k, v in blocks.items()}
        a_in = layer_norm(x, blk["ln1_scale"], blk["ln1_bias"], cfg.ln_eps)
        qkv = _qkv(a_in, blk, cfg).reshape(r, 3, h)
        if deferred:
            kv_news.append(qkv[:, 1:3].transpose(0, 1))
            new = dict(k_new=qkv[:, 1], v_new=qkv[:, 2])
        else:
            gkv[layer, t] = qkv[:, 1:3].transpose(0, 1).to(gkv.dtype)
            new = {}
        out = beam_attention(qkv[:, 0], gkv[layer], pk_all[layer], pv_all[layer],
                             prefill_valid, anc, t, num_beams, cfg.local_heads, **new)
        x = x + _proj(out, blk, cfg)
        x = x + _mlp(x, blk, cfg)
    if deferred:
        gkv[:, t] = torch.stack(kv_news).to(gkv.dtype)            # [L, 2, R, H]
    x = layer_norm(x, params["lnf_scale"], params["lnf_bias"], cfg.ln_eps)
    return lm_stats(x, wte_t, cfg, need_row_stats=True), gen_cache


def _sample_attend(q: torch.Tensor, pk: torch.Tensor, pv: torch.Tensor, gk: torch.Tensor,
                   gv: torch.Tensor, prefill_valid: torch.Tensor, t: int, cfg: GPT2Config,
                   k_new: Optional[torch.Tensor] = None,
                   v_new: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K=1 attention over the split cache (plain PyTorch, as the JAX
    package's XLA form): q [B,H], one layer's prefill K/V [B,S0,H] and gen
    K/V [N,B,H] -> [B,H] (before the output projection). Each row attends
    to its own prefill (``prefill_valid``) and its own gen columns <= t (< t
    in the deferred mode, whose ``k_new``/``v_new`` [B,H] are one extra
    self column, last). Logits and the gen-region AV in f32, the prefill AV
    in the compute dtype, as there."""
    dt = cfg.dtype
    b, s0 = prefill_valid.shape
    n, nh, hd = gk.shape[0], cfg.local_heads, cfg.head_dim
    scale = hd ** -0.5
    qh = q.reshape(b, nh, hd).float()
    lp = torch.einsum("bqd,bsqd->bqs", qh, pk.reshape(b, s0, nh, hd).float()) * scale
    lp = torch.where(prefill_valid[:, None, :] > 0, lp, _NEG)
    lg = torch.einsum("bqd,nbqd->bqn", qh, gk.reshape(n, b, nh, hd).float()) * scale
    deferred = k_new is not None
    causal = torch.arange(n, device=q.device) < (t if deferred else t + 1)
    parts = [lp, torch.where(causal, lg, _NEG)]
    if deferred:
        parts.append((qh * k_new.to(dt).reshape(b, nh, hd).float()).sum(-1, keepdim=True)
                     * scale)
    attn = torch.softmax(torch.cat(parts, dim=-1), dim=-1).to(dt)           # [B,nh,S0+N(+1)]
    out_p = torch.einsum("bqs,bsqd->bqd", attn[..., :s0], pv.reshape(b, s0, nh, hd).to(dt))
    out_g = torch.einsum("bqn,nbqd->bqd", attn[..., s0:s0 + n].float(),
                         gv.reshape(n, b, nh, hd).float()).to(dt)
    if deferred:
        out_g = out_g + attn[..., s0 + n:] * v_new.to(dt).reshape(b, nh, hd)
    return (out_p + out_g).reshape(b, cfg.local_embd)


def gpt2_sample_step(
    params: Params,
    token_embeds: torch.Tensor,    # [B, H] one new token per row
    positions: torch.Tensor,       # [B] absolute position ids
    prefill_cache: Cache,          # {k, v: [L, B, S0, H]} read-only
    prefill_valid: torch.Tensor,   # [B, S0] int32 left-pad flags
    gen_cache: Cache,              # {kv: [L, N, 2, B, H]} append-only, updated in place
    t: int,                        # current step (gen column)
    cfg: GPT2Config,
    wte_t: torch.Tensor,           # [H, Vp]
) -> Tuple[Tuple, Cache]:
    """One greedy/sampled decode step over the split cache
    (``sample_split_cache``): gpt2_beam_step's structure at K=1 with a
    causal mask instead of the ancestry. Writes step t's K/V at gen column
    t (all layers' in one store after the layer loop with
    ``deferred_cache_write``) and returns (lm_stats 4-tuple without row
    stats, gen_cache)."""
    dt = cfg.dtype
    b, h = token_embeds.shape[0], cfg.local_embd
    x = token_embeds.to(dt) + _position_embeds(params, positions, dt)   # [B, H]
    gkv = gen_cache["kv"]
    pk_all, pv_all = prefill_cache["k"], prefill_cache["v"]
    blocks = params["blocks"]
    deferred = cfg.deferred_cache_write
    kv_news = []
    for layer in range(cfg.n_layer):
        blk = {k: v[layer] for k, v in blocks.items()}
        a_in = layer_norm(x, blk["ln1_scale"], blk["ln1_bias"], cfg.ln_eps)
        qkv = _qkv(a_in, blk, cfg).reshape(b, 3, h)
        if deferred:
            kv_news.append(qkv[:, 1:3].transpose(0, 1))
            new = dict(k_new=qkv[:, 1], v_new=qkv[:, 2])
        else:
            gkv[layer, t] = qkv[:, 1:3].transpose(0, 1).to(gkv.dtype)
            new = {}
        out = _sample_attend(qkv[:, 0], pk_all[layer], pv_all[layer], gkv[layer, :, 0],
                             gkv[layer, :, 1], prefill_valid, t, cfg, **new)
        x = x + _proj(out, blk, cfg)
        x = x + _mlp(x, blk, cfg)
    if deferred:
        gkv[:, t] = torch.stack(kv_news).to(gkv.dtype)            # [L, 2, B, H]
    x = layer_norm(x, params["lnf_scale"], params["lnf_bias"], cfg.ln_eps)
    return lm_stats(x, wte_t, cfg, need_row_stats=False), gen_cache


def vocab_sharded(params: Params, cfg: GPT2Config) -> bool:
    """Whether ``wte`` holds only this rank's vocab shard (the training
    placement under TP where the vocab divides)."""
    return coll.tensor_parallel(cfg.mesh) and params["wte"].shape[0] != cfg.vocab_size


def embed_tokens(params: Params, ids: torch.Tensor, cfg: GPT2Config) -> torch.Tensor:
    """wte rows of ``ids``, from a vocab-sharded ``wte`` through the
    vocab-parallel lookup."""
    if vocab_sharded(params, cfg):
        return coll.vocab_parallel_embedding(params["wte"], ids, cfg.mesh)
    return params["wte"][ids.long()]


def gpt2_logits_nocache(params: Params, inputs_embeds: torch.Tensor, positions: torch.Tensor,
                        attn_mask: torch.Tensor, cfg: GPT2Config) -> torch.Tensor:
    """Cache-free training forward (teacher forcing): [B,S,H] embeddings,
    [B,S] positions and [B,S] mask (1 for real tokens) -> [B,S,V] f32
    logits (with a vocab-sharded ``wte``, the rank's [B,S,V/m] shard of
    them). Each layer attends over the step's own K/V with the masking and
    rounding of ``_attend`` at offset 0 (causal and ``attn_mask``), and
    writes no cache, so autograd can differentiate it."""
    dt = cfg.dtype
    x = inputs_embeds.to(dt) + _position_embeds(params, positions, dt)
    b, s = x.shape[:2]
    valid = attn_mask.to(torch.int32)
    blocks = params["blocks"]
    for layer in range(cfg.n_layer):
        blk = {k: v[layer] for k, v in blocks.items()}
        a_in = layer_norm(x, blk["ln1_scale"], blk["ln1_bias"], cfg.ln_eps)
        qkv = _qkv(a_in, blk, cfg).reshape(b, s, 3, cfg.local_heads, cfg.head_dim)
        a_out = _attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], 0, valid, cfg)
        x = x + _proj(a_out, blk, cfg)
        x = x + _mlp(x, blk, cfg)
    x = layer_norm(x, params["lnf_scale"], params["lnf_bias"], cfg.ln_eps)
    if vocab_sharded(params, cfg):
        x = coll.copy_to_model(x, cfg.mesh)
    return x.float() @ params["wte"].to(dt).float().t()


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, mesh=None,
            vocab_parallel: bool = False) -> torch.Tensor:
    """HF-style shifted causal-LM loss in f32; label -100 is ignored.
    ``vocab_parallel``: ``logits`` are the rank's vocab shard (the
    cross-entropy's reductions over ``mesh``'s model axis). Under a data
    axis above 1 the sum of this rank's token losses is divided by the
    token count of the whole batch: the ranks' losses (and gradients) then
    sum to the single-device batch's."""
    shift_logits = logits[:, :-1, :].float()
    shift_labels = labels[:, 1:].long()
    mask = shift_labels != -100
    targets = torch.where(mask, shift_labels, 0)
    if vocab_parallel:
        nll = coll.vocab_parallel_nll(shift_logits, targets, mesh)
    else:
        logp = torch.log_softmax(shift_logits, dim=-1)
        nll = -logp.gather(-1, targets[..., None])[..., 0]
    count = mask.sum()
    if mesh is not None and mesh.data > 1:
        count = coll.all_reduce(count, mesh, coll.DATA_AXIS)
    return torch.where(mask, nll, 0.0).sum() / count.clamp(min=1)
