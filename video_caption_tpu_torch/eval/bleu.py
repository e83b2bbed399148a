"""BLEU scoring utilities (counterpart of video_caption_tpu/eval/bleu.py).

The same functions and results as the JAX package's module, which calls
sacrebleu and NLTK. Neither is installed beside the port on the GPU
machine, so the scores are computed here in plain Python, by the same
algorithms:

- ``corpus_bleu``: sacrebleu's default corpus BLEU (13a tokenization, mixed
  case, n-grams up to 4, the closest reference length with ties to the
  shorter, exp smoothing), with the R x N reference regrouping of the
  reference's scripts/eval_compare.py:91-110 (references transposed into
  per-position lists padded with the first caption);
- ``sentence_bleu1``: sacrebleu's sentence BLEU at order 1 with effective
  order;
- ``nltk_bleu4``: NLTK's corpus BLEU-4 with smoothing method 1 (epsilon
  0.1) on lowercased whitespace tokens (experiments/eval_bleu_simple.py).
"""
from __future__ import annotations

import math
import re
from collections import Counter
from typing import Dict, List, Sequence, Tuple

_13A_RULES = (
    (re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),   # punctuation and symbols
    (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),   # period and comma unless after a digit
    (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),   # period and comma unless before a digit
    (re.compile(r"([0-9])(-)"), r"\1 \2 "),        # dash after a digit
)


def regroup_references(refs_per_sample: Sequence[Sequence[str]]) -> List[List[str]]:
    """[[r1a, r1b], [r2a], ...] -> sacrebleu shape [[r1a, r2a,...], [r1b, r1a-pad,...]]."""
    max_refs = max(len(r) for r in refs_per_sample)
    out: List[List[str]] = []
    for j in range(max_refs):
        out.append([refs[j] if j < len(refs) else refs[0] for refs in refs_per_sample])
    return out


def tokenize_13a(line: str) -> List[str]:
    """mteval-v13a tokenization, as sacrebleu's default tokenizer."""
    line = line.rstrip().replace("<skipped>", "").replace("-\n", "").replace("\n", " ")
    if "&" in line:
        line = (line.replace("&quot;", '"').replace("&amp;", "&").replace("&lt;", "<")
                .replace("&gt;", ">"))
    line = f" {line} "
    for pattern, repl in _13A_RULES:
        line = pattern.sub(repl, line)
    return line.split()


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def _closest_len(hyp_len: int, ref_lens: Sequence[int]) -> int:
    return min(ref_lens, key=lambda r: (abs(r - hyp_len), r))


def _segment_stats(hyp: str, refs: Sequence[str], order: int) -> List[int]:
    """[hyp_len, ref_len, correct_1..order, total_1..order] of one segment."""
    hyp_tok = tokenize_13a(hyp)
    refs_tok = [tokenize_13a(r) for r in refs if r is not None]
    correct, total = [0] * order, [0] * order
    for n in range(1, order + 1):
        ref_max: Counter = Counter()
        for ref in refs_tok:
            for gram, c in _ngrams(ref, n).items():
                ref_max[gram] = max(ref_max[gram], c)
        for gram, c in _ngrams(hyp_tok, n).items():
            total[n - 1] += c
            correct[n - 1] += min(c, ref_max[gram])
    return [len(hyp_tok), _closest_len(len(hyp_tok), [len(r) for r in refs_tok])] \
        + correct + total


def _bleu(stats: Sequence[Sequence[int]], order: int, effective_order: bool) -> float:
    """sacrebleu's BLEU (exp smoothing) of summed segment statistics."""
    sums = [sum(col) for col in zip(*stats)]
    sys_len, ref_len = sums[0], sums[1]
    correct, total = sums[2:2 + order], sums[2 + order:]
    bp = 1.0
    if sys_len < ref_len:
        bp = math.exp(1 - ref_len / sys_len) if sys_len > 0 else 0.0
    if not any(correct):
        return 0.0
    precisions = [0.0] * order
    smooth, eff_order = 1.0, order
    for n in range(1, order + 1):
        if total[n - 1] == 0:
            break
        if effective_order:
            eff_order = n
        if correct[n - 1] == 0:
            smooth *= 2
            precisions[n - 1] = 100.0 / (smooth * total[n - 1])
        else:
            precisions[n - 1] = 100.0 * correct[n - 1] / total[n - 1]
    logs = [math.log(p) if p != 0.0 else -9999999999 for p in precisions[:eff_order]]
    return bp * math.exp(sum(logs) / eff_order)


def corpus_bleu(hypotheses: Sequence[str], refs_per_sample: Sequence[Sequence[str]]) -> float:
    streams = regroup_references(refs_per_sample)
    stats = [_segment_stats(h, refs, 4) for h, refs in zip(hypotheses, zip(*streams))]
    return float(_bleu(stats, 4, effective_order=False))


def sentence_bleu1(hypothesis: str, references: Sequence[str]) -> float:
    return float(_bleu([_segment_stats(hypothesis, references, 1)], 1, effective_order=True))


def _modified_precision(refs: Sequence[Sequence[str]], hyp: Sequence[str],
                        n: int) -> Tuple[int, int]:
    counts = _ngrams(hyp, n)
    max_ref: Counter = Counter()
    for ref in refs:
        ref_counts = _ngrams(ref, n)
        for gram in counts:
            max_ref[gram] = max(max_ref[gram], ref_counts[gram])
    numerator = sum(min(c, max_ref[gram]) for gram, c in counts.items())
    return numerator, max(1, sum(counts.values()))


def nltk_bleu4(hypotheses: Sequence[str], refs_per_sample: Sequence[Sequence[str]]) -> float:
    hyp_tokens = [h.lower().split() for h in hypotheses]
    ref_tokens = [[r.lower().split() for r in refs] for refs in refs_per_sample]
    num, den = [0] * 4, [0] * 4
    hyp_len = ref_len = 0
    for refs, hyp in zip(ref_tokens, hyp_tokens):
        for n in range(1, 5):
            a, b = _modified_precision(refs, hyp, n)
            num[n - 1] += a
            den[n - 1] += b
        hyp_len += len(hyp)
        ref_len += _closest_len(len(hyp), [len(r) for r in refs])
    if num[0] == 0:
        return 0.0
    if hyp_len > ref_len:
        bp = 1.0
    elif hyp_len == 0:
        bp = 0.0
    else:
        bp = math.exp(1 - ref_len / hyp_len)
    p_n = [(0.1 if a == 0 else a) / b for a, b in zip(num, den)]   # smoothing method 1
    return float(bp * math.exp(math.fsum(0.25 * math.log(p) for p in p_n if p > 0)))


def evaluate_pairs(results: Sequence[Dict]) -> Dict[str, float]:
    """results: [{"hyp": str, "refs": [str, ...]}] -> aggregate metrics."""
    hyps = [r["hyp"] for r in results]
    refs = [r["refs"] for r in results]
    return {
        "corpus_bleu": corpus_bleu(hyps, refs),
        "bleu4_nltk": nltk_bleu4(hyps, refs),
        "mean_sentence_bleu1": sum(sentence_bleu1(h, rr) for h, rr in zip(hyps, refs)) / max(len(hyps), 1),
        "num_samples": len(hyps),
    }
