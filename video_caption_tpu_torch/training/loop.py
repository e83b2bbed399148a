"""Generic training loop (counterpart of video_caption_tpu/training/loop.py):
one optimizer step per batch, CSV metrics (events.csv / val.csv), periodic
validation, best-val checkpointing, max-steps cutoff.

The JAX package jits ``value_and_grad`` of the loss over the whole parameter
tree; here ``value_and_grad`` runs autograd over every floating leaf, and
``TreeAdam`` (training/optim.py) updates the tree in place. Batches come as
host numpy (data/data_loader.py) and are moved to the parameters' device
here.
"""
from __future__ import annotations

import csv
import logging
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from video_caption_tpu_torch.training.checkpoint import save_checkpoint
from video_caption_tpu_torch.training.optim import TreeAdam, leaves

log = logging.getLogger(__name__)


@dataclass
class LoopConfig:
    epochs: int = 1
    max_steps: int = 0
    val_every: int = 200
    max_val_batches: int = 50
    log_every: int = 10
    out_dir: str = "runs/train"
    ckpt_path: str = ""


def to_device(batch: Mapping, device) -> Dict[str, Any]:
    """numpy arrays of a batch -> tensors on ``device``; other values
    (video ids) as they are."""
    return {k: torch.from_numpy(v).to(device) if isinstance(v, np.ndarray) else v
            for k, v in batch.items()}


def value_and_grad(loss_fn: Callable, params: Mapping, batch: Mapping
                   ) -> Tuple[torch.Tensor, Dict[str, Optional[torch.Tensor]]]:
    """(loss, {leaf path: gradient}) of ``loss_fn(params, batch)`` over every
    floating leaf of the tree; a leaf the loss does not reach (a frozen
    encoder under no_grad) gets None."""
    flat = [(path, t) for path, t in leaves(params) if t.is_floating_point()]
    for _, t in flat:
        t.requires_grad_(True)
    try:
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, [t for _, t in flat], allow_unused=True)
    finally:
        for _, t in flat:
            t.requires_grad_(False)
    return loss.detach(), {path: g for (path, _), g in zip(flat, grads)}


def sgd_step(params: Mapping, optimizer: TreeAdam, loss_fn: Callable, batch: Mapping
             ) -> torch.Tensor:
    """One optimizer step on ``params`` (in place); returns the loss."""
    loss, grads = value_and_grad(loss_fn, params, batch)
    optimizer.step(params, grads)
    return loss


def _device_of(params: Mapping) -> torch.device:
    return next(t for _, t in leaves(params)).device


def run_training(
    params: Dict[str, Any],
    loss_fn: Callable,
    optimizer: TreeAdam,
    train_loader: Iterable[Dict],
    val_loader: Optional[Iterable[Dict]] = None,
    cfg: LoopConfig = LoopConfig(),
    batch_transform: Optional[Callable] = None,
) -> Dict[str, Any]:
    """Train ``params`` (updated in place, on their device) with
    ``loss_fn(params, batch)``; returns {"params", "steps", "best_val",
    "wall_s"}."""
    out = Path(cfg.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    events, valf = out / "events.csv", out / "val.csv"
    for f, header in ((events, ["step", "loss"]), (valf, ["step", "val_loss"])):
        with f.open("w", newline="") as fh:
            csv.writer(fh).writerow(header)

    device = _device_of(params)
    step, best_val = 0, float("inf")
    t0 = time.time()

    def prepare(batch):
        if batch_transform:
            batch = batch_transform(batch)
        return to_device(batch, device)

    def validate() -> float:
        total, n = 0.0, 0
        with torch.no_grad():
            for i, batch in enumerate(val_loader):
                if i >= cfg.max_val_batches:
                    break
                total += float(loss_fn(params, prepare(batch)))
                n += 1
        return total / max(n, 1)

    def checkpoint(epoch: int) -> None:
        if cfg.ckpt_path:
            # stage-1/2 payloads carry the optimizer state, as in the JAX loop
            save_checkpoint(cfg.ckpt_path, params, step=step, epoch=epoch, best_val=best_val,
                            opt_state=optimizer.state_dict())

    stop = False
    for epoch in range(cfg.epochs):
        for batch in train_loader:
            lv = float(sgd_step(params, optimizer, loss_fn, prepare(batch)))
            step += 1
            with events.open("a", newline="") as fh:
                csv.writer(fh).writerow([step, lv])
            if step % cfg.log_every == 0:
                log.info("step %d loss %.4f", step, lv)
            if val_loader is not None and cfg.val_every and step % cfg.val_every == 0:
                val = validate()
                with valf.open("a", newline="") as fh:
                    csv.writer(fh).writerow([step, val])
                if val < best_val:
                    best_val = val
                    checkpoint(epoch)
            if cfg.max_steps and step >= cfg.max_steps:
                stop = True
                break
        if stop:
            break

    if val_loader is not None:
        val = validate()
        with valf.open("a", newline="") as fh:
            csv.writer(fh).writerow([step, val])
        if val < best_val:
            best_val = val
            checkpoint(cfg.epochs)

    return {"params": params, "steps": step, "best_val": best_val, "wall_s": time.time() - t0}
