"""Candidate-set logits processing (counterpart of
video_caption_tpu/decode/logits_process.py).

HF generate semantics over fixed-size generated-token buffers, on the path
every preset takes: the exact two-stage top-k driven by the lm-head kernel's
window maxima (``exact_topk``), the processor chain applied to the raw
top-(k + N + 1) candidates only (``topk_processed``: repetition penalty,
no-repeat-ngram, min-new-tokens), temperature, and nucleus sampling over the
sorted candidates (``sample_sorted_top_p``). The full-vocab scatter chain,
which only a repetition penalty below 1 needs, is still to port.

Every top-k here is ``_top_k``: a stable descending sort, so equal values
keep ascending-index order exactly as ``lax.top_k`` orders them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = float("-inf")


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top k along the last axis, descending, ties in ascending index order
    (lax.top_k's order)."""
    vals, idxs = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idxs[..., :k]


def _gather_windows(scores_p: torch.Tensor, widx: torch.Tensor, nwin: int,
                    window: int) -> torch.Tensor:
    """Whole windows of the padded [B, nwin*window] buffer: [B, kw, window]."""
    b = scores_p.shape[0]
    flat = scores_p.reshape(b * nwin, window)
    rows = torch.arange(b, device=widx.device)[:, None] * nwin + widx
    return flat[rows.reshape(-1)].reshape(b, widx.shape[1], window)


def _topk_flat(flat: torch.Tensor, k: int, sub: int = 8, small: int = 512):
    """Top-k of [B, M] by recursive windowed reduction (exact, see exact_topk)."""
    b, m = flat.shape
    if m <= max(small, k * sub):
        return _top_k(flat, k)
    nsub = -(-m // sub)
    if nsub * sub != m:
        flat = torch.nn.functional.pad(flat, (0, nsub * sub - m), value=NEG_INF)
    smax = flat.reshape(b, nsub, sub).amax(dim=-1)
    _, sidx = _top_k(smax, k)
    cand = _gather_windows(flat, sidx, nsub, sub)
    vals, ci = _top_k(cand.reshape(b, k * sub), k)
    idxs = torch.gather(sidx, 1, ci // sub) * sub + ci % sub
    return vals, idxs


def exact_topk(scores: torch.Tensor, k: int, wmax: torch.Tensor):
    """Exact top-k over the vocab axis from the window maxima ``wmax``
    [B, V/window] (the lm-head kernel emits them): top-k windows by max, then
    the top-k within the gathered windows. A value in the true top-k has
    fewer than k windows whose max exceeds it, so its window is always among
    the top-k window maxima. Returns (vals [B,k], idxs [B,k]) descending."""
    b, v = scores.shape
    if k >= v:
        return _top_k(scores, v)
    nwin = wmax.shape[1]
    window = v // nwin
    if nwin * window != v:
        raise ValueError(f"scores width {v} is not {nwin} windows")
    kw = min(k, nwin)
    _, widx = _top_k(wmax, kw)
    cand = _gather_windows(scores, widx, nwin, window)
    vals, ci = _topk_flat(cand.reshape(b, kw * window), k)
    idxs = torch.gather(widx, 1, ci // window) * window + ci % window
    return vals, idxs


def ngram_banned(generated: torch.Tensor, t: int, ngram_size: int):
    """Tokens banned by the no-repeat-ngram rule at step t: (banned_tok
    [B, starts], match [B, starts]); ban banned_tok[b, i] iff match[b, i]."""
    n_buf = generated.shape[1]
    ctx = ngram_size - 1
    start = min(max(t - ctx, 0), n_buf - ctx)     # lax.dynamic_slice clamps
    ctx_tok = generated[:, start:start + ctx]
    starts = n_buf - ctx
    windows = torch.stack([generated[:, j:j + starts] for j in range(ctx)], dim=-1)
    match = (windows == ctx_tok[:, None, :]).all(dim=-1)
    i_pos = torch.arange(starts, device=generated.device)[None, :]
    valid = (i_pos + ctx <= t - 1) & (t >= ctx)
    return generated[:, ctx:], match & valid


def topk_processed(
    scores: torch.Tensor,        # [B, V] raw logits
    generated: torch.Tensor,     # [B, N] int
    t: int,                      # tokens generated so far
    k: int,
    repetition_penalty: float,
    ngram_size: int,
    min_new_tokens: int,
    eos_id: int,
    wmax: torch.Tensor,                           # [B, V/window] window maxima
    shift_max: Optional[torch.Tensor] = None,     # [B]: vals := (vals - max) - logsum
    shift_logsum: Optional[torch.Tensor] = None,
):
    """Top-k of the processor-chain-modified scores without materializing
    [B, V]: with repetition_penalty >= 1 every processor only LOWERS scores,
    and only of the generated tokens and EOS, so the modified top-k lies in
    the raw top-(k + N + 1). Returns (vals [B,k], idxs [B,k]) descending."""
    v = scores.shape[1]
    k = min(k, v)
    n_buf = generated.shape[1]
    c = min(k + n_buf + 1, v)
    vals, idxs = exact_topk(scores, c, wmax)
    if shift_max is not None:
        vals = (vals - shift_max[:, None]) - shift_logsum[:, None]
    gen_seen = torch.arange(n_buf, device=scores.device)[None, :] < t
    if repetition_penalty != 1.0:
        hits = (idxs[:, :, None] == generated[:, None, :]) & gen_seen[:, None, :]
        pen = torch.where(vals > 0, vals / repetition_penalty, vals * repetition_penalty)
        vals = torch.where(hits.any(dim=-1), pen, vals)
    if ngram_size > 0 and n_buf >= ngram_size:
        banned_tok, match = ngram_banned(generated, t, ngram_size)
        banned = ((idxs[:, :, None] == banned_tok[:, None, :]) & match[:, None, :]).any(dim=-1)
        vals = torch.where(banned, NEG_INF, vals)
    if min_new_tokens > 0 and t < min_new_tokens:
        vals = torch.where(idxs == eos_id, NEG_INF, vals)
    top_vals, pick = _top_k(vals, k)
    return top_vals, torch.gather(idxs, 1, pick)


def apply_temperature(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    if temperature == 1.0 or temperature <= 0:
        return logits
    return logits / temperature


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(U)), U uniform in (0, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def top_p_filter(vals: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filter over candidates sorted descending (HF TopP on the
    TopK-filtered distribution): -inf outside the nucleus."""
    if top_p >= 1.0:
        return vals
    lse = torch.logsumexp(vals, dim=-1, keepdim=True)
    probs = torch.exp(vals - lse)
    cum = torch.cumsum(probs, dim=-1)
    return torch.where((cum - probs) < top_p, vals, NEG_INF)


def sample_sorted_top_p(
    generator: Optional[torch.Generator],
    vals: torch.Tensor,      # [B, k] candidate scores, sorted descending
    idxs: torch.Tensor,      # [B, k] their vocab ids
    top_p: float,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Nucleus filter + categorical draw over a sorted candidate set; one
    vocab id per row. The draw is argmax(vals + Gumbel noise), the form of
    ``jax.random.categorical``; ``noise`` [B, k] replaces the generator's
    noise (tests feed the JAX package's own)."""
    vals = top_p_filter(vals, top_p)
    if noise is None:
        noise = gumbel_noise(vals.shape, generator, vals.device)
    choice = torch.argmax(vals + noise, dim=-1)
    return torch.gather(idxs, 1, choice[:, None])[:, 0]
