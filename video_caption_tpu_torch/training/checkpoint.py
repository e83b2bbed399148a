"""Checkpoints of the port's trainers (counterpart of
video_caption_tpu/training/checkpoint.py, which writes Orbax directories).

A checkpoint is a directory holding ``model.pt`` (``torch.save``) and
``train_meta.json`` ({"step", "epoch", "best_val", "args"}), as the JAX
package's directory holds its Orbax payload and the same metadata file.

- Caption model (``cfg`` given): ``model.pt`` is the reference-format
  payload ``{"model_state", "step", "epoch", "best_val", "args"}`` of
  ``models/convert.py::save_torch_checkpoint``, so it loads into both
  packages' ``load_params`` (``InferenceConfig.ckpt = <dir>/model.pt``, or
  in the port the directory itself).
- Any other tree (the alignment model): ``{"params", "step", "epoch",
  "best_val", "args"}`` with the port's tree as f32 CPU tensors.

Either payload carries ``opt_state`` when the caller passes one, as the JAX
loop's stage-1/2 checkpoints do. Sharded parameters (``mesh`` and the spec
tree of ``parallel.mesh.shard_params``) are gathered by every rank, head
grouping undone, and written by rank 0 alone. ``restore_params`` reads
either back, shaped like a given tree; ``load_metadata`` reads
``train_meta.json``.
"""
from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from video_caption_tpu_torch.models.caption_model import CaptionModelConfig
from video_caption_tpu_torch.models.convert import (load_reference_state, save_payload,
                                                    save_torch_checkpoint)
from video_caption_tpu_torch.parallel.mesh import Mesh, gather_params

log = logging.getLogger(__name__)

MODEL_FILE = "model.pt"
META_FILE = "train_meta.json"


def _cpu(tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def save_checkpoint(path: str, params: Mapping, step: int = 0, epoch: int = 0,
                    best_val: float = float("inf"), args: Optional[Dict] = None,
                    opt_state: Any = None, cfg: Any = None, mesh: Optional[Mesh] = None,
                    specs: Any = None) -> Path:
    """Write ``<path>/model.pt`` and ``<path>/train_meta.json``; returns the
    ``model.pt`` path. ``cfg`` (a CaptionModelConfig) selects the
    reference-format payload. With ``specs``, ``params`` are this rank's
    shards on ``mesh``: every rank of the mesh must call, and rank 0 alone
    writes the gathered tree."""
    out = Path(path).absolute()
    if specs is not None:
        params = gather_params(params, specs, mesh)
        if mesh.rank != 0:
            return out / MODEL_FILE
    out.mkdir(parents=True, exist_ok=True)
    meta = {"step": step, "epoch": epoch, "best_val": best_val, "args": args or {}}
    model_file = out / MODEL_FILE
    opt_state = None if opt_state is None else _cpu(opt_state)
    if isinstance(cfg, CaptionModelConfig):
        save_torch_checkpoint(model_file, params, cfg, opt_state=opt_state, **meta)
    else:
        payload = {**meta, "params": _cpu(params)}
        if opt_state is not None:
            payload["opt_state"] = opt_state
        save_payload(payload, model_file)
    (out / META_FILE).write_text(json.dumps(meta))
    log.info("saved checkpoint to %s (step=%d best_val=%.4f)", model_file, step, best_val)
    return model_file


def _structure(tree: Mapping, prefix: str = "") -> List[Tuple[str, Tuple[int, ...]]]:
    """(path, shape) of every leaf, paths sorted at each level as a JAX
    dict pytree orders them."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            out += _structure(v, f"{prefix}/{k}")
        else:
            out.append((f"{prefix}/{k}", tuple(v.shape)))
    return out


def restore_params(path: str, like: Mapping) -> Optional[Dict[str, Any]]:
    """The parameter tree of the checkpoint directory ``path`` as f32 CPU
    tensors, shaped like ``like``; None where the directory is absent.

    ``model.pt`` holds either the caption model's reference-format state
    (read back through ``load_reference_state``, every block it holds) or a
    ``{"params"}`` tree. A checkpoint of another model must not restore
    "successfully" and fail later on a shape: where the tree or a leaf's
    shape differs from ``like``, the error is logged and None returned, as
    the JAX package's ``restore_params`` does. The reference key space has
    no Linear ``proj`` adapter, so a caption model with one does not
    restore from a directory."""
    path = Path(path).absolute()
    if not path.exists():
        return None
    model_file = path / MODEL_FILE
    if not model_file.is_file():
        log.error("checkpoint %s has no %s", path, MODEL_FILE)
        return None
    payload = torch.load(str(model_file), map_location="cpu", weights_only=True)
    if "model_state" in payload:
        params = load_reference_state(payload)
    elif "params" in payload:
        params = payload["params"]
    else:
        log.error("checkpoint %s has no 'params' entry (keys: %s)", path, sorted(payload))
        return None
    want, got = _structure(like), _structure(params)
    if [p for p, _ in want] != [p for p, _ in got]:
        log.error("checkpoint %s tree structure does not match the model (%s vs %s)", path,
                  [p for p, _ in got], [p for p, _ in want])
        return None
    mismatched = [f"{g} vs expected {w}" for (_, g), (_, w) in zip(got, want) if g != w]
    if mismatched:
        log.error("checkpoint %s has %d shape-mismatched leaves (first: %s)", path,
                  len(mismatched), mismatched[0])
        return None
    return params


def load_metadata(path: str) -> Dict:
    """``train_meta.json`` of the checkpoint directory ``path``; {} where
    there is none."""
    meta_file = Path(path) / META_FILE
    if meta_file.is_file():
        return json.loads(meta_file.read_text())
    return {}
