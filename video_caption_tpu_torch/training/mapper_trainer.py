"""Mapper fine-tune, the trainer whose checkpoint the product serves
(counterpart of video_caption_tpu/training/mapper_trainer.py).

ViT frozen (``freeze_encoder``: the encoder runs forward only, through the
attention kernel), GPT-2 frozen except its last ``unfreeze_last_gpt2``
blocks at ``lr_gpt2``, the mapper (and projection adapters) trained at
``lr`` through the prefix-projector kernel and its backward; the
teacher-forcing loss of ``compute_loss``; periodic validation with best-val
checkpointing; events.csv / val.csv.

The step runs where the parameters are, on one device or on this rank of a
``(data, model)`` mesh (parallel/mesh.py; every rank builds the trainer and
takes every step, as under ``torchrun``), as the JAX trainer shards its
state over its mesh:

- the parameters are cut to this rank's shards by the training placement
  (TP over ``model``, ``wte`` vocab-sharded where the vocab divides) and,
  with ``fsdp``, their large leaves over ``data`` as well; the Adam moments
  live on the local shards only;
- every batch is cut to this data rank's rows; the loss is the rank's
  share (``g2.lm_loss``) and the data ranks' gradients are summed (FSDP's
  claimed leaves: gathered at the step, their gradients reduce-scattered);
- the clip's global norm is the single-device one (``topt.global_norm``
  with replicas over the mesh);
- the checkpoint is gathered from every rank and written by rank 0, as are
  events.csv and val.csv.
"""
from __future__ import annotations

import csv
import dataclasses
import logging
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Iterator, Optional

import torch

from video_caption_tpu_torch.config import MeshConfig
from video_caption_tpu_torch.models import caption_model as cm
from video_caption_tpu_torch.parallel import collectives as coll
from video_caption_tpu_torch.parallel import mesh as pmesh
from video_caption_tpu_torch.training import optim as topt
from video_caption_tpu_torch.training.checkpoint import save_checkpoint
from video_caption_tpu_torch.training.loop import to_device, value_and_grad

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


def _shard_rate(rate, spec, mesh: pmesh.Mesh):
    """A leaf's learning rate on its shard: a per-layer rate tensor is cut
    along the dims its leaf is sharded over where it has more than one
    entry there."""
    if not isinstance(rate, torch.Tensor):
        return rate
    for dim, axis in enumerate(spec):
        if axis is not None and rate.shape[dim] > 1:
            rate = rate.chunk(mesh.size(axis), dim)[mesh.coord(axis)]
    return rate


class MapperTrainer:
    def __init__(self, cfg: cm.CaptionModelConfig, params: Dict[str, Any],
                 args: TrainArgs = TrainArgs(), mesh: Optional[MeshConfig] = None,
                 fsdp: bool = False, fsdp_min_elems: Optional[int] = None):
        """``mesh``: the ``(data, model)`` shape, made into this rank's mesh
        over the initialised process group (``parallel.mesh.make_mesh``); by
        default every rank of a launcher's world on ``data``, else the
        single device. ``fsdp``
        shards leaves of at least ``fsdp_min_elems`` elements over
        ``data`` (the JAX package's threshold by default)."""
        # the ViT is always frozen in this trainer: no backward through it
        cfg = dataclasses.replace(cfg, freeze_encoder=True)
        self.args = args
        # own copy: the step updates the parameters in place
        full = topt.map_tree(lambda path, t: t.detach().clone(), params)
        self.device = next(t for _, t in topt.leaves(full)).device
        self.mesh = mesh = pmesh.make_mesh(mesh, self.device)
        if mesh.model > 1:
            pmesh.check_heads(cfg.vit.num_heads, mesh, "ViT")
            pmesh.check_heads(cfg.gpt2.n_head, mesh, "GPT-2")
        self.cfg = dataclasses.replace(cfg, vit=dataclasses.replace(cfg.vit, mesh=mesh),
                                       gpt2=dataclasses.replace(cfg.gpt2, mesh=mesh))
        kw = {} if fsdp_min_elems is None else {"fsdp_min_elems": fsdp_min_elems}
        self.params, self.specs = pmesh.shard_params(full, mesh, fsdp=fsdp, **kw)
        self._spec_of = dict(topt.leaves(self.specs))
        lr_tree = topt.mapper_lr_tree(full, args.lr, args.lr_gpt2, args.unfreeze_last_gpt2,
                                      cfg.gpt2.n_layer)
        lr_tree = topt.map_tree(lambda path, r: _shard_rate(r, self._spec_of[path], mesh),
                                lr_tree)
        self.optimizer = topt.build_optimizer(
            lr_tree, args.weight_decay,
            norm_fn=self._global_norm if mesh.num_devices > 1 else None)
        self.step = 0
        self.grad_norm: Optional[torch.Tensor] = None   # the last step's, before clipping
        self.best_val = float("inf")
        self._pending: list = []
        out = Path(args.out_dir)
        out.mkdir(parents=True, exist_ok=True)
        self._events = out / "events.csv"
        self._val = out / "val.csv"
        for f, header in ((self._events, ["step", "loss"]), (self._val, ["step", "val_loss"])):
            if mesh.rank == 0 and not f.exists():
                with f.open("w", newline="") as fh:
                    csv.writer(fh).writerow(header)

    def _gathered(self, params):
        """The tree the model runs on: FSDP's claimed leaves gathered over
        ``data`` (their gradients reduce-scattered back), the rest as held."""
        def leaf(path, t):
            spec = self._spec_of[path]
            if pmesh.DATA_AXIS not in spec:
                return t
            return coll.gather_from_data(t, self.mesh, spec.index(pmesh.DATA_AXIS))

        return topt.map_tree(leaf, params)

    def _loss(self, params, batch) -> torch.Tensor:
        return cm.compute_loss(self._gathered(params), batch["video"], batch["caption_ids"],
                               batch["attention_mask"], self.cfg)

    def _batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """This data rank's rows of a batch (host arrays or tensors) on the
        device: the JAX trainer's ``shard_batch`` of every batch."""
        return to_device(pmesh.shard_batch(batch, self.mesh), self.device)

    def _whole(self, loss: torch.Tensor) -> torch.Tensor:
        """The batch's loss from the data ranks' shares."""
        return coll.all_reduce(loss, self.mesh, pmesh.DATA_AXIS) if self.mesh.data > 1 else loss

    def _global_norm(self, grads: Dict[str, Optional[torch.Tensor]]) -> torch.Tensor:
        """The single-device global norm of sharded gradients."""
        paths = list(grads)
        return topt.global_norm(
            [grads[p] for p in paths], [pmesh.replicas(self._spec_of[p], self.mesh) for p in paths],
            reduce=lambda t: coll.all_reduce(coll.all_reduce(t, self.mesh, pmesh.MODEL_AXIS),
                                             self.mesh, pmesh.DATA_AXIS))

    def _log_csv(self, path: Path, row) -> None:
        if self.mesh.rank != 0:
            return
        with path.open("a", newline="") as fh:
            csv.writer(fh).writerow(row)

    def run_step(self, batch: Dict[str, Any], sync: bool = True) -> float:
        """One optimizer step. ``sync=False`` defers reading the loss back
        (``float(loss)`` waits for the device): ``fit`` issues step N+1 before
        it reads step N's loss, so the loader's host work overlaps the
        device's."""
        loss, grads = value_and_grad(self._loss, self.params, self._batch(batch))
        if self.mesh.data > 1:
            # DP: the data ranks' gradients summed (their losses are shares
            # of the batch's); FSDP's claimed leaves were by the reduce-scatter
            grads = {p: g if g is None or pmesh.DATA_AXIS in self._spec_of[p]
                     else coll.all_reduce(g, self.mesh, pmesh.DATA_AXIS)
                     for p, g in grads.items()}
        self.grad_norm = self.optimizer.step(self.params, grads)
        loss = self._whole(loss)
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
                total += float(self._whole(self._loss(self.params, self._batch(batch))))
                count += 1
        val = total / max(count, 1)
        self._log_csv(self._val, [self.step, val])
        return val

    def maybe_checkpoint(self, val_loss: float, epoch: int) -> bool:
        """Best-val checkpointing: a reference-format ``model.pt`` under
        ``ckpt_path`` (training/checkpoint.py); under a mesh the full tree,
        gathered from every rank, written by rank 0."""
        if val_loss < self.best_val:
            self.best_val = val_loss
            save_checkpoint(self.args.ckpt_path, self.params, step=self.step, epoch=epoch,
                            best_val=self.best_val, args=dataclasses.asdict(self.args),
                            cfg=self.cfg, mesh=self.mesh, specs=self.specs)
            return True
        return False

    def full_params(self) -> Dict[str, Any]:
        """The whole parameter tree, gathered from every rank (each must call)."""
        return pmesh.gather_params(self.params, self.specs, self.mesh)

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
