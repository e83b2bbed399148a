"""Candidate-set logits processing (counterpart of
video_caption_tpu/decode/logits_process.py).

HF generate semantics over fixed-size generated-token buffers, on the path
every preset takes: the exact two-stage top-k driven by the lm-head kernel's
window maxima (``exact_topk``), the processor chain applied to the raw
top-(k + N + 1) candidates only (``topk_processed``: repetition penalty,
no-repeat-ngram, min-new-tokens), temperature, and nucleus sampling over the
sorted candidates (``sample_sorted_top_p``); and the full-vocab chain the
other policies take (a repetition penalty below 1, which RAISES seen scores
and breaks the candidate bound, or sampling with ``top_k = 0``):
``apply_repetition_penalty``, ``apply_no_repeat_ngram``,
``apply_min_new_tokens``, ``apply_top_k``, ``apply_top_k_top_p``,
``apply_top_p`` and ``sample_top_k_top_p``. A draw is ``argmax(scores +
Gumbel noise)``, the form of ``jax.random.categorical``.

Every top-k here is ``_top_k``: a stable descending sort, so equal values
keep ascending-index order exactly as ``lax.top_k`` orders them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

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
        flat = F.pad(flat, (0, nsub * sub - m), value=NEG_INF)
    smax = flat.reshape(b, nsub, sub).amax(dim=-1)
    _, sidx = _top_k(smax, k)
    cand = _gather_windows(flat, sidx, nsub, sub)
    vals, ci = _top_k(cand.reshape(b, k * sub), k)
    idxs = torch.gather(sidx, 1, ci // sub) * sub + ci % sub
    return vals, idxs


def exact_topk(scores: torch.Tensor, k: int, wmax: Optional[torch.Tensor] = None):
    """Exact top-k over the vocab axis from the window maxima ``wmax``
    [B, V/window] (the lm-head kernel emits them over 128-wide windows;
    computed here alike, the scores padded with -inf, when None): top-k
    windows by max, then the top-k within the gathered windows. A value in
    the true top-k has fewer than k windows whose max exceeds it, so its
    window is always among the top-k window maxima. Returns (vals [B,k],
    idxs [B,k]) descending."""
    b, v = scores.shape
    if k >= v:
        return _top_k(scores, v)
    if wmax is None:
        window = 128
        nwin = -(-v // window)
        if nwin * window != v:
            scores = F.pad(scores, (0, nwin * window - v), value=NEG_INF)
        wmax = scores.reshape(b, nwin, window).amax(dim=-1)
        v = nwin * window
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


# ---- the full-vocab chain -------------------------------------------------


def _scatter_rows(logits: torch.Tensor, idx: torch.Tensor, src, keep: torch.Tensor
                  ) -> torch.Tensor:
    """A copy of ``logits`` [B, V] with ``src`` (a tensor shaped as ``idx``,
    or a number) written at columns ``idx`` where ``keep`` holds; the other
    entries go to one extra column that is dropped (the JAX package's
    out-of-bounds ``mode="drop"`` scatter). Every duplicate kept index
    carries the same value, so the result is deterministic."""
    b, v = logits.shape
    out = F.pad(logits, (0, 1))
    out.scatter_(1, torch.where(keep, idx.long(), v), src)
    return out[:, :v]


def apply_repetition_penalty(logits: torch.Tensor, generated: torch.Tensor, t: int,
                             penalty: float) -> torch.Tensor:
    """HF CTRL-style penalty on the tokens generated so far (the first
    ``t`` columns of ``generated``): a seen score s > 0 becomes s / p, else
    s * p, computed from the incoming scores."""
    if penalty == 1.0:
        return logits
    cur = torch.gather(logits, 1, generated.long())
    pen = torch.where(cur > 0, cur / penalty, cur * penalty)
    seen = torch.arange(generated.shape[1], device=logits.device)[None, :] < t
    return _scatter_rows(logits, generated, pen, seen.expand_as(generated))


def apply_no_repeat_ngram(logits: torch.Tensor, generated: torch.Tensor, t: int,
                          ngram_size: int) -> torch.Tensor:
    """Ban token x if (generated[t-n+1 : t], x) already occurred as an n-gram."""
    if ngram_size <= 0 or generated.shape[1] < ngram_size:
        return logits
    banned_tok, match = ngram_banned(generated, t, ngram_size)
    return _scatter_rows(logits, banned_tok, NEG_INF, match)


def apply_min_new_tokens(logits: torch.Tensor, t: int, min_new_tokens: int,
                         eos_id: int) -> torch.Tensor:
    """EOS is unreachable until ``min_new_tokens`` tokens have been generated."""
    if min_new_tokens <= 0 or t >= min_new_tokens:
        return logits
    out = logits.clone()
    out[:, eos_id] = NEG_INF
    return out


def apply_top_k(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Keep only the top_k logits per row (HF TopKLogitsWarper)."""
    if top_k <= 0:
        return logits
    kth = torch.topk(logits, min(top_k, logits.shape[-1]), dim=-1).values[..., -1:]
    return torch.where(logits < kth, NEG_INF, logits)


def _nucleus_threshold(top_vals: torch.Tensor, lse: torch.Tensor, top_p: float) -> torch.Tensor:
    """The smallest kept value of the nucleus over descending ``top_vals``
    (softmax normalised by ``lse``) [B, 1]."""
    probs = torch.exp(top_vals - lse)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p
    return torch.where(keep, top_vals, float("inf")).amin(dim=-1, keepdim=True)


def apply_top_k_top_p(logits: torch.Tensor, top_k: int, top_p: float) -> torch.Tensor:
    """HF TopK(k) -> TopP(p) in one top-k pass: the nucleus of the
    TopK-filtered distribution lies within the top-k values."""
    if top_k <= 0:
        return apply_top_p(logits, top_p)
    if top_p >= 1.0:
        return apply_top_k(logits, top_k)
    top_vals = torch.topk(logits, min(top_k, logits.shape[-1]), dim=-1).values
    lse = torch.logsumexp(top_vals, dim=-1, keepdim=True)
    thresh = torch.maximum(top_vals[..., -1:], _nucleus_threshold(top_vals, lse, top_p))
    return torch.where(logits >= thresh, logits, NEG_INF)


def apply_top_p(logits: torch.Tensor, top_p: float, nucleus_cap: int = 2048) -> torch.Tensor:
    """Nucleus filtering (HF TopPLogitsWarper, min_tokens_to_keep=1) over
    the full-vocab softmax, the nucleus sought within the top
    ``nucleus_cap`` logits (exact whenever it fits there, as in the JAX
    package). Padded columns at -inf stay -inf."""
    if top_p >= 1.0:
        return logits
    top_vals = torch.topk(logits, min(nucleus_cap, logits.shape[-1]), dim=-1).values
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    return torch.where(logits >= _nucleus_threshold(top_vals, lse, top_p), logits, NEG_INF)


def sample_top_k_top_p(generator: Optional[torch.Generator], logits: torch.Tensor, top_k: int,
                       top_p: float, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One token per row from the TopK -> TopP-filtered distribution, drawn
    over the exact top-k candidates (tokens outside them have probability
    0). ``noise`` [B, min(top_k, V)] as in ``sample_sorted_top_p``."""
    v = logits.shape[-1]
    vals, idxs = exact_topk(logits, min(top_k if top_k > 0 else v, v))
    return sample_sorted_top_p(generator, vals, idxs, top_p, noise=noise)


def sample_full(generator: Optional[torch.Generator], logits: torch.Tensor,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One token per row from softmax(logits) over the whole vocabulary:
    argmax(logits + Gumbel noise [B, V]), ``jax.random.categorical``."""
    if noise is None:
        noise = gumbel_noise(logits.shape, generator, logits.device)
    return torch.argmax(logits + noise, dim=-1)
