"""Checkpoints of the port's trainers (counterpart of
video_caption_tpu/training/checkpoint.py, which writes Orbax directories).

A checkpoint is a directory holding ``model.pt`` (``torch.save``) and
``train_meta.json`` ({"step", "epoch", "best_val", "args"}), as the JAX
package's directory holds its Orbax payload and the same metadata file.

- Caption model (``cfg`` given): ``model.pt`` is the reference-format
  payload ``{"model_state", "step", "epoch", "best_val", "args"}`` with the
  state dict of ``models/convert.py::export_torch_state``, so it loads into
  both packages' ``load_params`` (``InferenceConfig.ckpt = <dir>/model.pt``).
- Any other tree (the alignment model): ``{"params", "step", "epoch",
  "best_val", "args"}`` with the port's tree as f32 CPU tensors.

Either payload carries ``opt_state`` when the caller passes one, as the JAX
loop's stage-1/2 checkpoints do.
"""
from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import torch

from video_caption_tpu_torch.models.caption_model import CaptionModelConfig
from video_caption_tpu_torch.models.convert import export_torch_state

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
                    opt_state: Any = None, cfg: Any = None) -> Path:
    """Write ``<path>/model.pt`` and ``<path>/train_meta.json``; returns the
    ``model.pt`` path. ``cfg`` (a CaptionModelConfig) selects the
    reference-format payload."""
    out = Path(path).absolute()
    out.mkdir(parents=True, exist_ok=True)
    meta = {"step": step, "epoch": epoch, "best_val": best_val, "args": args or {}}
    payload: Dict[str, Any] = dict(meta)
    if isinstance(cfg, CaptionModelConfig):
        payload["model_state"] = export_torch_state(params, cfg)
    else:
        payload["params"] = _cpu(params)
    if opt_state is not None:
        payload["opt_state"] = _cpu(opt_state)
    model_file = out / MODEL_FILE
    tmp = model_file.with_suffix(".tmp")
    torch.save(payload, tmp)
    tmp.replace(model_file)
    (out / META_FILE).write_text(json.dumps(meta))
    log.info("saved checkpoint to %s (step=%d best_val=%.4f)", model_file, step, best_val)
    return model_file

