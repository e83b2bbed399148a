"""Optimizers over the port's parameter tree (counterpart of
video_caption_tpu/training/optim.py).

The JAX package builds its optimizers from optax; the port writes the same
chain out over its dict of tensors (``TreeAdam``), in optax's order:

1. ``clip_by_global_norm(1.0)`` over EVERY leaf's gradient, frozen leaves
   included (gradients flow through the frozen GPT-2 blocks to the prefix,
   and the JAX step differentiates the whole tree), so the caller computes
   gradients even where the learning rate is 0;
2. ``scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8 added to the square root,
   bias-corrected);
3. decayed weights under the ``lr > 0`` mask;
4. scaling by the per-leaf learning rate: a scalar, or a ``[depth, 1, ..]``
   tensor of per-layer rates for stacked block parameters (a per-layer rate
   of a stacked tensor is not a ``torch.optim`` param group), times the
   schedule's rate at this step where there is one;
5. negation, then ``param + update``.

A leaf whose rate is 0 everywhere (and that does not decay) keeps no Adam
moments and is not updated: its update would be an exact 0.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Tuple, Union

import torch

Params = Dict[str, Any]
Rate = Union[float, torch.Tensor]
Schedule = Callable[[int], float]


def leaves(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(``/a/b`` path, leaf) pairs in the tree's insertion order."""
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


def map_tree(fn, tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    """The tree with ``fn(path, leaf)`` at every leaf."""
    return {k: map_tree(fn, v, f"{prefix}/{k}") if isinstance(v, Mapping) else fn(f"{prefix}/{k}", v)
            for k, v in tree.items()}


def mapper_lr_tree(params: Params, lr: float = 3e-4, lr_gpt2: float = 1e-5,
                   unfreeze_last: int = 0, n_layer: int = 12) -> Dict[str, Any]:
    """Learning rates matching ``params``: ``lr`` for the mapper and the
    projection adapters, ``lr_gpt2`` for the last ``unfreeze_last`` GPT-2
    blocks (a [n_layer, 1, .., 1] tensor on stacked block leaves), 0 for the
    rest (the encoder, the embeddings, the final LayerNorm)."""

    def rate(path: str, leaf: torch.Tensor) -> Rate:
        if path.startswith("/mapper") or path.startswith("/proj"):
            return lr
        if path.startswith("/decoder/blocks"):
            mask = torch.zeros(n_layer, dtype=torch.float32, device=leaf.device)
            if unfreeze_last > 0:
                mask[n_layer - unfreeze_last:] = lr_gpt2
            return mask.reshape((n_layer,) + (1,) * (leaf.ndim - 1))
        return 0.0

    return map_tree(rate, params)


def full_finetune_lr_tree(params: Params, lr: float) -> Dict[str, Any]:
    """The same rate on every leaf (joint training)."""
    return map_tree(lambda path, leaf: lr, params)


def _trains(rate: Rate) -> bool:
    return bool((rate > 0).any()) if isinstance(rate, torch.Tensor) else rate > 0


def global_norm(grads: List[Optional[torch.Tensor]]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (None counts as 0), f32."""
    sq = [g.float().square().sum() for g in grads if g is not None]
    return torch.stack(sq).sum().sqrt() if sq else torch.zeros(())


class TreeAdam:
    """The optax chain of the module docstring over a parameter tree. The
    parameters are updated in place (the JAX step returns new arrays);
    ``step`` returns the global gradient norm before clipping."""

    def __init__(self, lr_tree: Mapping, weight_decay: float, decay_all: bool = False,
                 clip_norm: Optional[float] = None, schedule: Optional[Schedule] = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.rates = dict(leaves(lr_tree))
        self.decays = {p: decay_all or _trains(r) for p, r in self.rates.items()}
        self.active = {p: self.decays[p] or _trains(r) for p, r in self.rates.items()}
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu: Dict[str, torch.Tensor] = {}
        self.nu: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, params: Params, grads: Mapping[str, Optional[torch.Tensor]]) -> torch.Tensor:
        """One update of ``params`` (in place) from ``grads`` {path: gradient
        or None for a leaf the loss does not reach}."""
        flat = dict(leaves(params))
        norm = global_norm(list(grads.values()))
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        # optax counts a schedule's steps from 0
        scale = self.schedule(self.count - 1) if self.schedule else 1.0
        for path, p in flat.items():
            if not self.active[path]:
                continue
            g = grads.get(path)
            g = torch.zeros_like(p) if g is None else g.to(p.dtype)
            if self.clip_norm is not None:
                # optax: where(norm < max, g, g / norm * max)
                g = torch.where(norm < self.clip_norm, g, g / norm * self.clip_norm)
            if path not in self.mu:
                self.mu[path] = torch.zeros_like(p)
                self.nu[path] = torch.zeros_like(p)
            mu = self.mu[path].mul_(self.b1).add_((1 - self.b1) * g)
            nu = self.nu[path].mul_(self.b2).add_((1 - self.b2) * g.square())
            update = (mu / c1) / ((nu / c2).sqrt() + self.eps)
            if self.decays[path]:
                update = update + self.weight_decay * p
            p.add_(-(update * (self.rates[path] * scale)))
        return norm

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "mu": dict(self.mu), "nu": dict(self.nu)}


def build_optimizer(lr_tree: Mapping, weight_decay: float = 0.01) -> TreeAdam:
    """AdamW whose update is scaled leaf-wise by ``lr_tree``, after clipping
    the gradients' global norm to 1.0; weights decay where the rate is > 0."""
    return TreeAdam(lr_tree, weight_decay, clip_norm=1.0)


def adamw(params: Params, lr: Union[float, Schedule], weight_decay: float = 1e-4,
          clip_norm: Optional[float] = None) -> TreeAdam:
    """``optax.adamw(lr)`` at optax's defaults: weight decay 1e-4 on every
    leaf (torch's AdamW defaults to 1e-2); ``lr`` a rate or a schedule of
    the step count. ``clip_norm`` puts ``optax.clip_by_global_norm`` in
    front, as ``optax.chain(clip_by_global_norm(c), adamw(lr))``."""
    if callable(lr):
        return TreeAdam(full_finetune_lr_tree(params, 1.0), weight_decay, decay_all=True,
                        clip_norm=clip_norm, schedule=lr)
    return TreeAdam(full_finetune_lr_tree(params, lr), weight_decay, decay_all=True,
                    clip_norm=clip_norm)


def warmup_cosine_decay(init_value: float, peak_value: float, warmup_steps: int,
                        decay_steps: int, end_value: float = 0.0) -> Schedule:
    """``optax.warmup_cosine_decay_schedule``: a linear ramp from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine
    decay to ``end_value`` at ``decay_steps`` (warmup included), then
    constant."""
    span = decay_steps - warmup_steps
    if span <= 0:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed warmup_steps ({warmup_steps})")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return init_value + (peak_value - init_value) * count / warmup_steps
        t = min(count - warmup_steps, span)
        return peak_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / span)) + alpha)

    return schedule
