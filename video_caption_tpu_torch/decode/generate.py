"""Autoregressive generation with a static KV cache (counterpart of
video_caption_tpu/decode/generate.py).

Greedy / temperature-top-k-top-p sampling over the contiguous cache (or,
with ``GPT2Config.sample_split_cache``, the split cache), and HF beam search
(2K candidate expansion, EOS candidates moved to a finished set scored with
length_penalty=1) over the split cache. The decode loops are Python loops
over steps in the JAX package's forward-then-select order: token t is
selected in the step whose forward produced its logits. Finished rows keep
stepping with their outputs frozen to EOS. By default every step of
``max_new_tokens`` runs; with ``DecodeParams.early_stop`` the loop ends
early: a greedy/sampled decode once every row has finished, a beam search
at HF's ``is_done``. The condition is read on the host before every step.
Early stop runs eagerly (a captured graph runs a fixed number of steps),
where the host issues each step's few hundred kernels one by one and the
device is idle long before the read, so a read per step costs little and
saves the most steps; the ids are those of the full-length loop at any
interval, since finished rows are frozen to EOS. A sampled decode draws the
Gumbel noise of all its steps at once before its first step
(``sample_noise``), as the unified decode does for each sampled group, so
both take the same draws.

Selection takes the candidate-set path (``logits_process.topk_processed``)
where it is exact, and the full-vocab processor chain otherwise
(``_candidate_path_ok``): a repetition penalty below 1, or sampling with
``top_k = 0``.

do_sample gating is the reference's rule:
``do_sample = (num_beams == 1 and temperature != 1.0)``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from video_caption_tpu_torch.decode import logits_process as lp
from video_caption_tpu_torch.models import gpt2 as g2


@dataclass(frozen=True)
class DecodeParams:
    """Static decode policy (the same fields and rule as the JAX package's)."""

    max_new_tokens: int = 24
    num_beams: int = 1
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 50
    no_repeat_ngram_size: int = 3
    repetition_penalty: float = 1.1
    min_new_tokens: int = 8
    eos_id: int = 50256
    early_stop: bool = False

    @property
    def do_sample(self) -> bool:
        return self.num_beams == 1 and self.temperature != 1.0


def _candidate_path_ok(dp: DecodeParams) -> bool:
    """The candidate-set path is exact only when every processor can only
    LOWER scores, i.e. repetition_penalty >= 1; else the full-vocab chain."""
    return dp.repetition_penalty >= 1.0


def _process_logits(logits: torch.Tensor, generated: torch.Tensor, t: int,
                    dp: DecodeParams) -> torch.Tensor:
    """The full-vocab processor chain: repetition penalty, no-repeat-ngram,
    min-new-tokens."""
    logits = lp.apply_repetition_penalty(logits, generated, t, dp.repetition_penalty)
    logits = lp.apply_no_repeat_ngram(logits, generated, t, dp.no_repeat_ngram_size)
    return lp.apply_min_new_tokens(logits, t, dp.min_new_tokens, dp.eos_id)


def _topk_processed(scores, generated, t, k, dp: DecodeParams, **kw):
    return lp.topk_processed(scores, generated, t, k, dp.repetition_penalty,
                             dp.no_repeat_ngram_size, dp.min_new_tokens, dp.eos_id, **kw)


def _prefill(params, cfg: g2.GPT2Config, inputs_embeds: torch.Tensor, max_len: int,
             prefill_mask: Optional[torch.Tensor], wte_t: torch.Tensor, split: bool,
             row_stats: bool):
    """Run the prompt through the model. Left-padded rows: pad columns are
    excluded from attention and position ids count real tokens only
    (cumsum(mask) - 1, clamped at 0). Returns (lm_stats of the last
    position, cache, valid [B, max_len] int32, row_lengths [B])."""
    b, s0, _ = inputs_embeds.shape
    device = inputs_embeds.device
    cache = g2.init_cache(cfg, b, max_len, device, layout="contiguous" if split else "auto")
    mask = torch.ones((b, s0), dtype=torch.int32, device=device) if prefill_mask is None \
        else prefill_mask.to(torch.int32)
    valid = torch.zeros((b, max_len), dtype=torch.int32, device=device)
    valid[:, :s0] = mask
    positions = (torch.cumsum(mask, dim=1) - 1).clamp_min(0)
    stats, cache = g2.gpt2_forward(params, inputs_embeds, positions, valid, cache, 0, cfg,
                                   wte_t=wte_t, last_only=True, return_stats=True,
                                   row_stats=row_stats)
    if split:
        # repack once into merged-head K and V [L, B, S0, H] for the beam step
        kv = cache["kv"]
        l, bb, s, _, nh, hd = kv.shape
        cache = {"k": kv[:, :, :, 0].reshape(l, bb, s, nh * hd).contiguous(),
                 "v": kv[:, :, :, 1].reshape(l, bb, s, nh * hd).contiguous()}
    return stats, cache, valid, mask.sum(dim=1)


def sample_select(
    last_logits: torch.Tensor,    # [B, Vp] raw logits of the previous forward
    generated: torch.Tensor,      # [B, N] int64, updated in place
    finished: torch.Tensor,       # [B] bool
    t: int,
    dp: DecodeParams,
    generator: Optional[torch.Generator],
    wmax: torch.Tensor,           # [B, Vp/128] window maxima of last_logits
    noise: Optional[torch.Tensor] = None,   # [B, top_k] Gumbel noise for the draw
):
    """One greedy/sampled selection step. Returns (token [B], generated,
    finished)."""
    if _candidate_path_ok(dp) and (not dp.do_sample or dp.top_k > 0):
        if dp.do_sample:
            vals, idxs = _topk_processed(last_logits, generated, t, dp.top_k, dp, wmax=wmax)
            vals = lp.apply_temperature(vals, dp.temperature)
            token = lp.sample_sorted_top_p(generator, vals, idxs, dp.top_p, noise=noise)
        else:
            _, idxs = _topk_processed(last_logits, generated, t, 1, dp, wmax=wmax)
            token = idxs[:, 0]
    else:
        logits = _process_logits(last_logits, generated, t, dp)
        if dp.do_sample:
            logits = lp.apply_temperature(logits, dp.temperature)
            if dp.top_k > 0:
                token = lp.sample_top_k_top_p(generator, logits, dp.top_k, dp.top_p,
                                              noise=noise)
            else:
                token = lp.sample_full(generator, lp.apply_top_p(logits, dp.top_p),
                                       noise=noise)
        else:
            token = torch.argmax(logits, dim=-1)
    token = torch.where(finished, dp.eos_id, token)
    generated[:, t] = token
    return token, generated, finished | (token == dp.eos_id)


def sample_noise(dp: DecodeParams, rows: int, vocab_padded: int,
                 generator: Optional[torch.Generator], device) -> Optional[torch.Tensor]:
    """The Gumbel noise of every step of a sampled decode of ``rows`` rows,
    [max_new_tokens, rows, min(top_k, vocab_padded)] (the whole padded
    vocabulary with top_k = 0), drawn at once; None for a greedy or beam
    policy, which draws nothing. Every sampled decode
    (``greedy_or_sample``, ``unified.generate_unified``) draws its noise
    here, before its first step, so programs that decode the same groups
    in the same order take the same draws from one generator."""
    if not dp.do_sample:
        return None
    width = min(dp.top_k, vocab_padded) if dp.top_k > 0 else vocab_padded
    return lp.gumbel_noise((dp.max_new_tokens, rows, width), generator, device)


def greedy_or_sample(params, cfg: g2.GPT2Config, inputs_embeds: torch.Tensor,
                     dp: DecodeParams, generator: Optional[torch.Generator] = None,
                     prefill_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy or sampled decode over the contiguous cache (the flat one with
    ``cfg.use_pallas_decode_layer``; the split one with
    ``cfg.sample_split_cache`` where neither fused-decode switch is on, the
    JAX package's rule); returns ids [B, max_new_tokens] (EOS after a row
    finishes)."""
    b, s0, _ = inputs_embeds.shape
    n = dp.max_new_tokens
    device = inputs_embeds.device
    split = cfg.sample_split_cache and not cfg.use_pallas_decode_layer \
        and not cfg.use_pallas_decode
    if cfg.use_pallas_decode_layer:
        # the decode-layer kernel's weight dtypes, cast once per call; no
        # copy and no kernel where the caller prepared them (the engine
        # does, once, so a captured request replays no cast)
        params = g2.prepare_decode_params(params, cfg)
    wte_t = g2.lm_head_t(params, cfg)
    noise = sample_noise(dp, b, wte_t.shape[1], generator, device)
    (logits, wmax, _, _), cache, valid, row_len = _prefill(
        params, cfg, inputs_embeds, s0 if split else s0 + n, prefill_mask, wte_t, split=split,
        row_stats=False)
    if split:
        gen_cache = g2.init_cache(cfg, b, n, device, layout="beam_gen")
    generated = torch.full((b, n), dp.eos_id, dtype=torch.int64, device=device)
    finished = torch.zeros((b,), dtype=torch.bool, device=device)
    token, generated, finished = sample_select(logits, generated, finished, 0, dp,
                                               generator, wmax=wmax,
                                               noise=None if noise is None else noise[0])
    for t in range(1, n):
        if dp.early_stop and bool(finished.all()):
            break
        # forward of token t-1: its K/V lands at cache column s0 + t - 1
        # (gen column t - 1 of the split cache)
        embeds = params["wte"][token]
        if split:
            (logits, wmax, _, _), gen_cache = g2.gpt2_sample_step(
                params, embeds, row_len + t - 1, cache, valid, gen_cache, t - 1, cfg, wte_t)
        else:
            valid[:, s0 + t - 1] = 1
            (logits, wmax, _, _), cache = g2.gpt2_forward(
                params, embeds[:, None, :], (row_len + t - 1)[:, None], valid, cache,
                s0 + t - 1, cfg, wte_t=wte_t, return_stats=True, row_stats=False)
        token, generated, finished = sample_select(logits, generated, finished, t, dp,
                                                   generator, wmax=wmax,
                                                   noise=None if noise is None else noise[t])
    return generated


def beam_select(
    last_logits: torch.Tensor,    # [B*K, Vp] raw logits
    beam_scores: torch.Tensor,    # [B, K]
    generated: torch.Tensor,      # [B, K, N]
    fin_scores: torch.Tensor,     # [B, K]
    fin_seqs: torch.Tensor,       # [B, K, N]
    t: int,
    dp: DecodeParams,
    k: int,
    stats: Tuple,                 # (wmax [B*K, Vp/128], m [B*K], l [B*K])
):
    """One beam-search selection step (HF semantics). Processors run on
    log-softmax scores: on the candidate path the ranking uses raw logits
    and only the candidates are shifted by (m, log l); the full-vocab chain
    processes the whole log-softmax. Returns (new_token [B,K], flat_parent
    [B*K], beam_scores, generated, fin_scores, fin_seqs)."""
    b, _, n = generated.shape
    neg = -1e9
    flat_gen = generated.reshape(b * k, n)
    if _candidate_path_ok(dp):
        wmax, m, l = stats
        row_vals, row_idx = _topk_processed(
            last_logits.float(), flat_gen, t, 2 * k, dp,
            shift_max=m, shift_logsum=torch.log(l), wmax=wmax)
        cand = (beam_scores.reshape(b * k, 1) + row_vals).reshape(b, 2 * k * k)
        top_scores, pick = lp._top_k(cand, 2 * k)                    # [B, 2K]
        parent = pick // (2 * k)
        token = torch.gather(row_idx.reshape(b, 2 * k * k), 1, pick)
    else:
        logp = _process_logits(torch.log_softmax(last_logits.float(), dim=-1), flat_gen, t, dp)
        v = logp.shape[-1]
        cand = (beam_scores.reshape(b * k, 1) + logp).reshape(b, k * v)
        top_scores, top_idx = lp._top_k(cand, 2 * k)                 # [B, 2K]
        parent = top_idx // v
        token = top_idx % v

    is_eos = token == dp.eos_id
    # finished hypotheses, normalized by generated length incl. EOS
    eos_norm = torch.where(is_eos, top_scores / float(t + 1), float("-inf"))
    cand_seqs = torch.gather(generated, 1, parent[..., None].expand(-1, -1, n)).clone()
    cand_seqs[:, :, t] = token
    all_scores = torch.cat([fin_scores, eos_norm], dim=1)           # [B, 3K]
    all_seqs = torch.cat([fin_seqs, cand_seqs], dim=1)              # [B, 3K, N]
    fin_scores, fin_pick = lp._top_k(all_scores, k)
    fin_seqs = torch.gather(all_seqs, 1, fin_pick[..., None].expand(-1, -1, n))

    # continuing beams: the best K non-EOS of the 2K
    cont_rank = top_scores + torch.where(is_eos, neg * 2, 0.0)
    _, cont_pick = lp._top_k(cont_rank, k)
    new_scores = torch.gather(top_scores, 1, cont_pick)
    new_parent = torch.gather(parent, 1, cont_pick)
    new_token = torch.gather(token, 1, cont_pick)
    new_gen = torch.gather(generated, 1, new_parent[..., None].expand(-1, -1, n)).clone()
    new_gen[:, :, t] = new_token
    flat_parent = (new_parent + torch.arange(b, device=new_parent.device)[:, None] * k).reshape(-1)
    return new_token, flat_parent, new_scores, new_gen, fin_scores, fin_seqs


def beam_finalize(beam_scores, generated, fin_scores, fin_seqs, n: int) -> torch.Tensor:
    """Merge the running beams, normalized by full length; best sequence
    per batch row [B, N]."""
    all_scores = torch.cat([fin_scores, beam_scores / float(n)], dim=1)
    all_seqs = torch.cat([fin_seqs, generated], dim=1)
    best = torch.argmax(all_scores, dim=1)
    return all_seqs[torch.arange(all_seqs.shape[0], device=best.device), best]


def beams_done(beam_scores: torch.Tensor, fin_scores: torch.Tensor, t: int) -> bool:
    """HF ``is_done`` (early_stopping=False) before step t, read on the
    host: every video's K finished hypotheses beat the best running beam's
    attainable score, ``min(fin_scores) >= max(beam_scores) / t``."""
    best_possible = beam_scores.amax(dim=1) / max(float(t), 1.0)
    return bool((fin_scores.amin(dim=1) >= best_possible).all())


def beam_search(params, cfg: g2.GPT2Config, inputs_embeds: torch.Tensor, dp: DecodeParams,
                prefill_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fixed-shape beam search over the split cache; returns ids
    [B, max_new_tokens]. The prefill runs once per video at B rows and its
    K/V is shared read-only by the video's beams; the beam reorder permutes
    the ancestry index ``anc``, never the cache."""
    b, s0, _ = inputs_embeds.shape
    k, n = dp.num_beams, dp.max_new_tokens
    r = b * k
    device = inputs_embeds.device
    wte_t = g2.lm_head_t(params, cfg)
    (logits, wmax, m, l), pcache, pvalid, row_len = _prefill(
        params, cfg, inputs_embeds, s0, prefill_mask, wte_t, split=True, row_stats=True)
    stats = tuple(x.repeat_interleave(k, dim=0) for x in (wmax, m, l))
    logits = logits.repeat_interleave(k, dim=0)
    row_len_flat = row_len.repeat_interleave(k, dim=0)

    gen_cache = g2.init_cache(cfg, r, n, device, layout="beam_gen")
    anc = torch.zeros((r, n), dtype=torch.int32, device=device)
    rows = torch.arange(r, dtype=torch.int32, device=device)
    beam_scores = torch.full((b, k), -1e9, dtype=torch.float32, device=device)
    beam_scores[:, 0] = 0.0
    generated = torch.full((b, k, n), dp.eos_id, dtype=torch.int64, device=device)
    fin_scores = torch.full((b, k), float("-inf"), dtype=torch.float32, device=device)
    fin_seqs = torch.full((b, k, n), dp.eos_id, dtype=torch.int64, device=device)

    token, parent, beam_scores, generated, fin_scores, fin_seqs = beam_select(
        logits, beam_scores, generated, fin_scores, fin_seqs, 0, dp, k, stats)
    anc = anc[parent]
    anc[:, 0] = rows
    for t in range(1, n):
        if dp.early_stop and beams_done(beam_scores, fin_scores, t):
            break
        # forward of token t-1: its K/V lands at gen column t-1
        embeds = params["wte"][token.reshape(-1)]
        (logits, wmax, m, l), gen_cache = g2.gpt2_beam_step(
            params, embeds, row_len_flat + t - 1, pcache, pvalid, gen_cache, anc, t - 1,
            k, cfg, wte_t)
        token, parent, beam_scores, generated, fin_scores, fin_seqs = beam_select(
            logits, beam_scores, generated, fin_scores, fin_seqs, t, dp, k, (wmax, m, l))
        anc = anc[parent]
        anc[:, t] = rows
    return beam_finalize(beam_scores, generated, fin_scores, fin_seqs, n)


def generate_prefixed(params, cfg: g2.GPT2Config, prefix: torch.Tensor,
                      prompt_ids: torch.Tensor, prompt_mask: torch.Tensor, dp: DecodeParams,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """prefix [B,P,H] + LEFT-padded prompts [B,L] -> ids [B, max_new_tokens].
    Each row is [prefix, pad..., prompt]; the pads carry mask 0, which is
    attention- and position-equivalent to left padding."""
    tok = params["wte"][prompt_ids.long()]
    embeds = torch.cat([prefix.to(tok.dtype), tok], dim=1)
    mask = torch.cat([torch.ones(prefix.shape[:2], dtype=torch.int32, device=prefix.device),
                      prompt_mask.to(torch.int32)], dim=1)
    return generate(params, cfg, embeds, dp, generator, mask)


def generate(params, cfg: g2.GPT2Config, inputs_embeds: torch.Tensor, dp: DecodeParams,
             generator: Optional[torch.Generator] = None,
             prefill_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Beam search when the policy has beams, else greedy or sampled decode;
    ids [B, max_new_tokens]."""
    if dp.num_beams > 1:
        return beam_search(params, cfg, inputs_embeds, dp, prefill_mask)
    return greedy_or_sample(params, cfg, inputs_embeds, dp, generator, prefill_mask)

