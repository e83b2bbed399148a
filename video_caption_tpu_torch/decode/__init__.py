"""Decode stack of the port: candidate-set logits processing, greedy/sampled
and beam-search generation over a static KV cache."""
