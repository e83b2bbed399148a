"""Mapper fine-tune, the trainer whose checkpoint the product serves
(counterpart of video_caption_tpu/training/mapper_trainer.py).

ViT frozen (``freeze_encoder``: the encoder runs forward only, through the
attention kernel), GPT-2 frozen except its last ``unfreeze_last_gpt2``
blocks at ``lr_gpt2``, the mapper (and projection adapters) trained at
``lr`` through the prefix-projector kernel and its backward; the
teacher-forcing loss of ``compute_loss``; periodic validation with best-val
checkpointing; events.csv / val.csv.

One device: the step runs where the parameters are. The JAX package's
device mesh and FSDP sharding are not ported (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import csv
import dataclasses
import logging
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Iterator

import torch

from video_caption_tpu_torch.models import caption_model as cm
from video_caption_tpu_torch.training import optim as topt
from video_caption_tpu_torch.training.checkpoint import save_checkpoint
from video_caption_tpu_torch.training.loop import sgd_step, to_device

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class TrainArgs:
    lr: float = 3e-4
    lr_gpt2: float = 1e-5
    unfreeze_last_gpt2: int = 0
    weight_decay: float = 0.01
    epochs: int = 1
    max_steps: int = 0              # 0 = no cutoff
    val_every: int = 200
    max_val_batches: int = 50
    out_dir: str = "runs/mapper"
    ckpt_path: str = "checkpoints/msvd_mapper_finetune"


class MapperTrainer:
    def __init__(self, cfg: cm.CaptionModelConfig, params: Dict[str, Any],
                 args: TrainArgs = TrainArgs(), mesh: Any = None, fsdp: bool = False):
        if fsdp or (mesh is not None and getattr(mesh, "num_devices", 1) > 1):
            raise NotImplementedError("multi-device and FSDP training are not ported yet "
                                      "(ROADMAP Queue 1 item 9)")
        # the ViT is always frozen in this trainer: no backward through it
        cfg = dataclasses.replace(cfg, freeze_encoder=True)
        self.cfg = cfg
        self.args = args
        # own copy: the step updates the parameters in place
        self.params = topt.map_tree(lambda path, t: t.detach().clone(), params)
        self.device = next(t for _, t in topt.leaves(self.params)).device
        lr_tree = topt.mapper_lr_tree(self.params, args.lr, args.lr_gpt2,
                                      args.unfreeze_last_gpt2, cfg.gpt2.n_layer)
        self.optimizer = topt.build_optimizer(lr_tree, args.weight_decay)
        self.step = 0
        self.best_val = float("inf")
        self._pending: list = []
        out = Path(args.out_dir)
        out.mkdir(parents=True, exist_ok=True)
        self._events = out / "events.csv"
        self._val = out / "val.csv"
        for f, header in ((self._events, ["step", "loss"]), (self._val, ["step", "val_loss"])):
            if not f.exists():
                with f.open("w", newline="") as fh:
                    csv.writer(fh).writerow(header)

    def _loss(self, params, batch) -> torch.Tensor:
        return cm.compute_loss(params, batch["video"], batch["caption_ids"],
                               batch["attention_mask"], self.cfg)

    def _log_csv(self, path: Path, row) -> None:
        with path.open("a", newline="") as fh:
            csv.writer(fh).writerow(row)

    def run_step(self, batch: Dict[str, Any], sync: bool = True) -> float:
        """One optimizer step. ``sync=False`` defers reading the loss back
        (``float(loss)`` waits for the device): ``fit`` issues step N+1 before
        it reads step N's loss, so the loader's host work overlaps the
        device's."""
        loss = sgd_step(self.params, self.optimizer, self._loss, to_device(batch, self.device))
        self.step += 1
        if not sync:
            self._pending.append((self.step, loss))
            return self.drain_pending(keep=1)
        loss = float(loss)
        self._log_csv(self._events, [self.step, loss])
        return loss

    def drain_pending(self, keep: int = 0) -> float:
        """Read back deferred losses older than the last ``keep`` steps;
        returns the most recently read loss (nan if none yet)."""
        last = float("nan")
        while len(self._pending) > keep:
            step, loss = self._pending.pop(0)
            last = float(loss)
            self._log_csv(self._events, [step, last])
        return last

    def evaluate(self, val_iter: Iterator[Dict[str, Any]]) -> float:
        total, count = 0.0, 0
        with torch.no_grad():
            for i, batch in enumerate(val_iter):
                if i >= self.args.max_val_batches:
                    break
                total += float(self._loss(self.params, to_device(batch, self.device)))
                count += 1
        val = total / max(count, 1)
        self._log_csv(self._val, [self.step, val])
        return val

    def maybe_checkpoint(self, val_loss: float, epoch: int) -> bool:
        """Best-val checkpointing: a reference-format ``model.pt`` under
        ``ckpt_path`` (training/checkpoint.py)."""
        if val_loss < self.best_val:
            self.best_val = val_loss
            save_checkpoint(self.args.ckpt_path, self.params, step=self.step, epoch=epoch,
                            best_val=self.best_val, args=dataclasses.asdict(self.args),
                            cfg=self.cfg)
            return True
        return False

    def fit(self, train_loader, val_loader=None) -> Dict[str, float]:
        t0 = time.time()
        for epoch in range(self.args.epochs):
            for batch in train_loader:
                loss = self.run_step(batch, sync=False)
                if self.args.max_steps and self.step >= self.args.max_steps:
                    break
                if val_loader is not None and self.step % self.args.val_every == 0:
                    loss = self.drain_pending()
                    val = self.evaluate(iter(val_loader))
                    self.maybe_checkpoint(val, epoch)
                    log.info("step %d loss %.4f val %.4f", self.step, loss, val)
            if self.args.max_steps and self.step >= self.args.max_steps:
                break
        self.drain_pending()
        if val_loader is not None:
            val = self.evaluate(iter(val_loader))
            self.maybe_checkpoint(val, self.args.epochs)
        return {"steps": self.step, "best_val": self.best_val, "wall_s": time.time() - t0}
