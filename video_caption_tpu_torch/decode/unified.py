"""Unified per-row-policy decode: every preset of every video in one beam-step
loop (counterpart of video_caption_tpu/decode/unified.py).

Every prompt instance carries K_max = max(num_beams) decode rows, so each
step is one ``g2.gpt2_beam_step`` over the whole instance set: the GPT-2
weights are read once a step for every policy group, instead of once a step
per group. Narrower groups pad their blocks with dead rows (identity
ancestry, EOS tokens, never selected); a sampled or greedy row is the k=0
row of its instance block, also with identity ancestry. Selection runs per
group on its rows through the grouped path's own ``beam_select`` and
``sample_select`` (so a group takes the candidate-set or the full-vocab
chain as it would alone, and int8 block weights serve the shared step as
any other); a group whose ``max_new_tokens`` has passed is frozen (its
state kept, EOS fed) while the loop runs to the longest horizon. Early stop
keeps a request out of this loop (the engine's ``_unified_eligible``).

The ids equal ``generate_prefixed`` run group by group, for any number of
sampled groups: a sampled group draws its Gumbel noise for all of its steps
at once, in group order, as ``greedy_or_sample`` does, so both programs take
the same draws from one generator.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from video_caption_tpu_torch.decode.generate import (
    DecodeParams, _prefill, beam_finalize, beam_select, sample_noise, sample_select,
)
from video_caption_tpu_torch.models import gpt2 as g2


def _prefill_rows(wte, prefix, prompts, l_max):
    """Embeddings and masks of every instance, group-major and video-major
    within a group: [prefix, pad..., prompt]. A group's extra pads (up to the
    longest prompt) sit between prefix and prompt with mask 0, which is
    position- and attention-equivalent to its own shorter padding."""
    v, p, _ = prefix.shape
    emb_rows, mask_rows, n_inst = [], [], []
    for ids_g, mask_g in prompts:
        n_g, l_g = ids_g.shape
        tok = wte[ids_g.long()]                                      # [n_g, L_g, H]
        mask_g = mask_g.to(torch.int32)
        if l_g < l_max:
            tok = F.pad(tok, (0, 0, l_max - l_g, 0))
            mask_g = F.pad(mask_g, (l_max - l_g, 0))
        emb_rows.append(torch.cat([prefix.repeat_interleave(n_g, dim=0).to(tok.dtype),
                                   tok.repeat(v, 1, 1)], dim=1))
        mask_rows.append(torch.cat([torch.ones((v * n_g, p), dtype=torch.int32,
                                               device=prefix.device), mask_g.repeat(v, 1)], dim=1))
        n_inst.append(v * n_g)
    return torch.cat(emb_rows), torch.cat(mask_rows), n_inst


def generate_unified(params, cfg: g2.GPT2Config, prefix: torch.Tensor,
                     prompts: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                     dps: Sequence[DecodeParams],
                     generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
    """Decode V videos (prefix [V, P, H]) under every policy group at once.

    ``prompts`` holds per group its LEFT-padded (ids [n_g, L_g], mask
    [n_g, L_g]); ``dps`` its policy. Group g has I_g = V * n_g instances
    (video-major) and returns ids [I_g, max_new_tokens_g], equal to
    ``generate_prefixed`` on that group's rows. Makes no host
    synchronisation (a CUDA graph can capture it)."""
    device = prefix.device
    wte = params["wte"]
    l_max = max(int(ids.shape[1]) for ids, _ in prompts)
    n_max = max(dp.max_new_tokens for dp in dps)
    k_max = max(dp.num_beams for dp in dps)
    embeds, pmask, n_inst = _prefill_rows(wte, prefix, prompts, l_max)
    r_tot = sum(n_inst) * k_max
    wte_t = g2.lm_head_t(params, cfg)
    # the noise of every sampled group, drawn first and in group order
    noises = [sample_noise(dp, n, wte_t.shape[1], generator, device)
              for dp, n in zip(dps, n_inst)]

    # one prefill for every instance of every group, with the row statistics
    # beam selection needs; every row of a block starts from its instance's
    # statistics
    stats, pcache, pvalid, row_len = _prefill(params, cfg, embeds, embeds.shape[1], pmask,
                                              wte_t, split=True, row_stats=True)
    stats = tuple(x.repeat_interleave(k_max, dim=0) for x in stats)
    row_len_rows = row_len.repeat_interleave(k_max)

    # instance i owns rows [i*K_max, (i+1)*K_max); the live rows of a beam
    # group start from beam_search's zeros ancestry, every other row keeps
    # identity ancestry
    rows = torch.arange(r_tot, dtype=torch.int32, device=device)
    anc = rows[:, None].repeat(1, n_max)
    states, i_off = [], 0
    for dp, i in zip(dps, n_inst):
        k, n = dp.num_beams, dp.max_new_tokens
        if k > 1:
            blk = anc[i_off * k_max:(i_off + i) * k_max].view(i, k_max, n_max)
            blk[:, :k] = 0
            scores = torch.full((i, k), -1e9, dtype=torch.float32, device=device)
            scores[:, 0] = 0.0
            states.append([scores,
                           torch.full((i, k, n), dp.eos_id, dtype=torch.int64, device=device),
                           torch.full((i, k), float("-inf"), dtype=torch.float32, device=device),
                           torch.full((i, k, n), dp.eos_id, dtype=torch.int64, device=device)])
        else:
            states.append([torch.full((i, n), dp.eos_id, dtype=torch.int64, device=device),
                           torch.zeros((i,), dtype=torch.bool, device=device)])
        i_off += i

    def select_all(stats, anc, t):
        """Every group's selection at step t: the token of every row
        [R_tot] and the new ancestry; updates ``states``."""
        logits, wmax, m, l = stats
        tokens, anc_parts, i_off = [], [], 0
        for g, (dp, i) in enumerate(zip(dps, n_inst)):
            k, n = dp.num_beams, dp.max_new_tokens
            r0, rg = i_off * k_max, i * k_max
            blk_anc = anc[r0:r0 + rg].view(i, k_max, n_max)
            tok_blk = torch.full((i, k_max), dp.eos_id, dtype=torch.int64, device=device)
            if t >= n:                      # past the group's horizon: frozen
                anc_parts.append(anc[r0:r0 + rg])
            elif k > 1:
                live = [x[r0:r0 + rg].view(i, k_max, -1)[:, :k].reshape(i * k, -1)
                        for x in (logits, wmax)]
                live_ml = tuple(x[r0:r0 + rg].view(i, k_max)[:, :k].reshape(-1) for x in (m, l))
                tok2d, flat_parent, *states[g] = beam_select(
                    live[0], *states[g], t, dp, k, (live[1],) + live_ml)
                new_live = blk_anc[:, :k].reshape(i * k, n_max)[flat_parent]
                new_live[:, t] = rows[r0:r0 + rg].view(i, k_max)[:, :k].reshape(-1)
                new_blk = blk_anc.clone()
                new_blk[:, :k] = new_live.view(i, k, n_max)
                anc_parts.append(new_blk.view(rg, n_max))
                tok_blk[:, :k] = tok2d
            else:
                noise = None if noises[g] is None else noises[g][t]
                tok, *states[g] = sample_select(
                    logits[r0:r0 + rg:k_max], *states[g], t, dp, generator,
                    wmax=wmax[r0:r0 + rg:k_max], noise=noise)
                anc_parts.append(anc[r0:r0 + rg])
                tok_blk[:, 0] = tok
            tokens.append(tok_blk.view(-1))
            i_off += i
        return torch.cat(tokens), torch.cat(anc_parts)

    # forward-then-select: step 0 selects on the prefill's statistics, step
    # t on the forward of token t-1 (its K/V lands at generated column t-1)
    token, anc = select_all(stats, anc, 0)
    gen_cache = g2.init_cache(cfg, r_tot, n_max, device, layout="beam_gen")
    for t in range(1, n_max):
        stats, gen_cache = g2.gpt2_beam_step(params, wte[token], row_len_rows + t - 1, pcache,
                                             pvalid, gen_cache, anc, t - 1, k_max, cfg, wte_t)
        token, anc = select_all(stats, anc, t)
    return tuple(beam_finalize(*state, dp.max_new_tokens) if dp.num_beams > 1 else state[0]
                 for dp, state in zip(dps, states))
