"""Judging served ids against the reference's logits.

A served row is one decode policy's ids for one video and prompt. At each
served position t (up to and including the first EOS; the program freezes
a finished row to EOS) the reference forms the scores the policy selects
from, from its own logits given the prefix, the prompt and the served
tokens before t (HF generate's processors, in their order):

- a repetition penalty on the tokens served before t (a score s becomes
  s / p where s > 0, else s * p), on log-softmax scores for beam search and
  on the raw logits for greedy and sampled decoding;
- no-repeat-ngram: a token that would repeat an n-gram of the served
  tokens is banned;
- EOS banned before ``min_new_tokens``;
- for sampling, temperature, top-k, then top-p over the top-k.

Each policy admits a set of tokens at t, and the served token must lie in
it: greedy, the best; beam search with K beams, the row's top 2K (a token
that beam search keeps is among the best 2K continuations of its own beam,
which is the served sequence's prefix); sampling, the top-p nucleus of the
top-k. The number compared is a token's **gap**: how far its score lies
below the least admitted score, 0 inside the set (scores in log-prob units
for beam search, logits over the temperature for sampling). Rounding moves
a token across the edge of the set by a small gap; a wrong prefix, a stale
step, a dropped row or an altered token moves it far. All positions of a
row are judged at once.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence

import torch


@dataclass(frozen=True)
class Policy:
    num_beams: int
    max_new_tokens: int
    temperature: float
    top_p: float
    top_k: int
    no_repeat_ngram_size: int
    repetition_penalty: float
    min_new_tokens: int

    @property
    def do_sample(self) -> bool:
        return self.num_beams == 1 and self.temperature != 1.0


def policy(preset: dict) -> Policy:
    """A preset of the configuration file (its decode keys) as a policy."""
    return Policy(num_beams=preset["num_beams"], max_new_tokens=preset["max_new_tokens"],
                  temperature=preset.get("temperature", 1.0), top_p=preset.get("top_p", 1.0),
                  top_k=preset.get("top_k", 50),
                  no_repeat_ngram_size=preset.get("no_repeat_ngram_size", 3),
                  repetition_penalty=preset.get("repetition_penalty", 1.1),
                  min_new_tokens=preset.get("min_new_tokens", 8))


def evaluated_length(served: Sequence[int], eos_id: int) -> int:
    """Positions that the policy chose: up to and including the first EOS."""
    for i, tok in enumerate(served):
        if tok == eos_id:
            return i + 1
    return len(served)


def _processed(logits: torch.Tensor, served: Sequence[int], pol: Policy,
               eos_id: int) -> torch.Tensor:
    """The processed scores [n, V] (float64) at every evaluated position t
    (row t from ``logits[t]`` and the served tokens before t)."""
    n, vocab = logits.shape
    s = logits.double()
    if pol.num_beams > 1:
        s = torch.log_softmax(s, dim=-1)
    dev = s.device
    tokens = torch.tensor(served[:n], device=dev).clamp(0, vocab - 1)
    if pol.repetition_penalty != 1.0 and n > 1:
        before = (torch.arange(n, device=dev)[:, None] > torch.arange(n, device=dev)[None, :])
        seen = torch.zeros(n, vocab, dtype=torch.int32, device=dev)
        seen.scatter_add_(1, tokens[None, :].expand(n, n), before.to(torch.int32))
        pen = torch.where(s > 0, s / pol.repetition_penalty, s * pol.repetition_penalty)
        s = torch.where(seen > 0, pen, s)
    k = pol.no_repeat_ngram_size
    if k > 0:
        rows, cols = [], []
        for t in range(k - 1, n):
            ctx = tuple(served[t - k + 1:t])
            for i in range(t - k + 1):
                if tuple(served[i:i + k - 1]) == ctx and 0 <= served[i + k - 1] < vocab:
                    rows.append(t)
                    cols.append(served[i + k - 1])
        if rows:
            s[torch.tensor(rows, device=dev), torch.tensor(cols, device=dev)] = float("-inf")
    s[:min(pol.min_new_tokens, n), eos_id] = float("-inf")
    if pol.do_sample:
        s = s / pol.temperature
    return s


def _admitted_floor(s: torch.Tensor, pol: Policy) -> torch.Tensor:
    """The least score the policy admits at each position [n]."""
    if pol.do_sample:
        vals = torch.sort(s, dim=-1, descending=True).values[:, :pol.top_k]
        if pol.top_p < 1.0:
            probs = torch.softmax(vals, dim=-1)
            keep = (torch.cumsum(probs, dim=-1) - probs) < pol.top_p
            vals = torch.where(keep, vals, float("inf"))
        return vals.amin(dim=-1)
    width = 2 * pol.num_beams if pol.num_beams > 1 else 1
    return torch.topk(s, width, dim=-1).values[:, -1]


def row_gaps(logits: torch.Tensor, served: Sequence[int], pol: Policy,
             eos_id: int) -> List[float]:
    """The gap of every evaluated position of one served row; ``logits``
    [len, V] from ``model.row_logits``. A token outside the vocabulary, or
    one the processors ban, has an infinite gap."""
    n, vocab = logits.shape
    if n != evaluated_length(served, eos_id):
        raise ValueError("logits must cover the evaluated positions")
    s = _processed(logits, served, pol, eos_id)
    floor = _admitted_floor(s, pol)
    tok = torch.tensor(served[:n], device=s.device)
    inside = (tok >= 0) & (tok < vocab)
    score = s[torch.arange(n, device=s.device), tok.clamp(0, vocab - 1)]
    gap = torch.clamp(floor - score, min=0.0)
    gap = torch.where(inside & (score > float("-inf")), gap, math.inf)
    return gap.tolist()


def summarize(gaps: Dict[str, List[float]]) -> dict:
    """Over every judged position of every row: ``mean_gap`` (the sum of
    the gaps over the positions), ``max_gap``, ``outside`` (the share of
    positions with a gap above 0) and ``tokens``.

    ``mean_gap`` is the number compared. A served token leaves its
    admitted set only where a rounding error moved its score across the
    set's edge, so the count of such tokens grows with the error's size,
    and so does each one's gap: the mean grows with its square, and over
    thousands of positions it is far steadier from seed to seed than the
    widest single gap."""
    flat = [g for row in gaps.values() for g in row]
    if not flat:
        return {"mean_gap": math.inf, "max_gap": math.inf, "outside": 1.0, "tokens": 0}
    return {"mean_gap": sum(flat) / len(flat), "max_gap": max(flat),
            "outside": sum(g > 0 for g in flat) / len(flat), "tokens": len(flat)}
