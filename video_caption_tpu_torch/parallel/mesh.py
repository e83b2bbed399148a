"""Device mesh and sharding rules (counterpart of
video_caption_tpu/parallel/mesh.py).

A mesh is a ``(data, model)`` grid of ranks, one process each, on a
``torch.distributed`` ``DeviceMesh``. The rules are the JAX package's
(Megatron tensor parallelism on the stacked ``[depth, in, out]`` block
weights):

- qkv / mlp-up weights and their biases: the OUT dim over ``model``
  (column parallel);
- attn-proj / mlp-down weights: the IN dim over ``model`` (row parallel);
  their biases stay replicated and are added once, after the all-reduce;
- ``wte``: the vocab dim over ``model`` where it divides, unless
  ``replicate_embeddings`` (the inference placement);
- FSDP claims, for leaves of at least ``fsdp_min_elems`` elements, the first
  free, divisible dim to the left of the TP dim over ``data``;
- everything else replicated.

``param_specs`` returns the JAX package's PartitionSpecs as tuples of axis
names. Unlike GSPMD, ``shard_params`` hands a rank its local shard as a
plain tensor, so one layout has to be chosen here: the fused QKV columns
(``qkv_w/qkv_b`` of the ViT, ``attn_w/attn_b`` of GPT-2) are ``[3, heads,
64]``, and a contiguous split of them would give rank 0 all of Q and half of
K. Their model shard is therefore the Q, K and V columns of the rank's own
head group, concatenated: the kernels then see the ``[.., 3 * H / model]``
layout they already take, at ``heads / model`` heads. ``gather_params``
undoes it.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from video_caption_tpu_torch.config import MeshConfig
from video_caption_tpu_torch.parallel import collectives as coll

DATA_AXIS = coll.DATA_AXIS
MODEL_AXIS = coll.MODEL_AXIS

Spec = Tuple[Optional[str], ...]

_COL_PARALLEL = {"qkv_w", "qkv_b", "attn_w", "attn_b", "fc1_w", "fc1_b", "fc_w", "fc_b"}
_ROW_PARALLEL = {"proj_w", "fc2_w", "out_w"}
_FUSED_QKV = {"qkv_w", "qkv_b", "attn_w", "attn_b"}
"""Column-parallel leaves whose out dim is the fused ``[3, heads, 64]``
layout: their model shard is head-grouped."""

_FSDP_MIN_ELEMS = 1 << 16
"""FSDP shards leaves at least this big over ``data``; smaller ones stay
replicated (the JAX package's threshold)."""


@dataclass(frozen=True)
class Mesh:
    """This rank's place on a ``(data, model)`` mesh. ``device_mesh`` is the
    ``torch.distributed`` DeviceMesh whose groups carry the collectives;
    without one (a single process, no process group) every collective is
    the identity."""

    data: int = 1
    model: int = 1
    data_rank: int = 0
    model_rank: int = 0
    device_mesh: Any = field(default=None, compare=False, repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def num_devices(self) -> int:
        return self.data * self.model

    @property
    def rank(self) -> int:
        """The rank's index on the mesh, data-major (the default group's rank)."""
        return self.data_rank * self.model + self.model_rank

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def coord(self, axis: str) -> int:
        return self.data_rank if axis == DATA_AXIS else self.model_rank

    def group(self, axis: str):
        """The process group of ``axis`` (None without a DeviceMesh)."""
        return None if self.device_mesh is None else self.device_mesh.get_group(axis)


def local_cuda_device() -> torch.device:
    """``cuda:LOCAL_RANK`` (a launcher's local rank; 0 without one), modulo
    the cards there are: ranks beyond them share them (over gloo)."""
    count = max(torch.cuda.device_count(), 1)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % count)


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_launched_group(device, backend: Optional[str] = None) -> bool:
    """Initialise the default process group from a launcher's environment
    (``WORLD_SIZE``, set by ``torchrun``) where none is, with ``backend``
    (default ``nccl`` on CUDA, ``gloo`` on the CPU); ``device`` becomes the
    rank's current CUDA device first. An initialised group's backend must
    be ``backend`` where one is given. Returns whether a group is
    initialised."""
    device = torch.device(device)
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            return False
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend or default_backend(device))
    elif backend is not None and dist.get_backend() != backend:
        raise ValueError(f"the process group's backend is {dist.get_backend()}, not {backend}")
    return True


def make_mesh(cfg: Optional[MeshConfig] = None, device=None,
              backend: Optional[str] = None) -> Mesh:
    """This rank's ``Mesh`` of ``cfg`` (default: every rank on ``data``)
    over the default process group (``init_launched_group``); without one,
    a 1x1 mesh is the single process and any other raises. Raises
    ValueError when ``data * model`` differs from the world size, as the
    JAX package does for the device count. ``device`` (default
    ``local_cuda_device()``) becomes the rank's current CUDA device."""
    device = torch.device(device if device is not None else local_cuda_device())
    if not init_launched_group(device, backend):
        if cfg is None or cfg.num_devices == 1:
            return Mesh()
        raise ValueError(f"mesh {cfg.data}x{cfg.model} needs a process group of "
                         f"{cfg.num_devices} ranks; none is initialised")
    world = dist.get_world_size()
    if cfg is None:
        cfg = MeshConfig(data=world, model=1)
    if cfg.num_devices != world:
        raise ValueError(f"mesh {cfg.data}x{cfg.model} != {world} devices")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(device.type, (cfg.data, cfg.model),
                          mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    data_rank, model_rank = dm.get_coordinate()
    return Mesh(cfg.data, cfg.model, data_rank, model_rank, dm)


def rows_of(x, mesh: Mesh, dim: int = 0):
    """The data rank's rows of ``x`` along ``dim`` (numpy or torch); raises
    ValueError where they do not divide, as the JAX package's placement
    does."""
    n = x.shape[dim]
    if n % mesh.data:
        raise ValueError(f"{n} rows do not divide over the data axis of size {mesh.data}")
    per = n // mesh.data
    index = [slice(None)] * x.ndim
    index[dim] = slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)
    return x[tuple(index)]


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This data rank's rows of every leaf's leading (batch) dim."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    return rows_of(batch, mesh)


# --- TP parameter rules (the JAX package's) ---------------------------------

def _spec_for(path: str, ndim: int, model_size: int, shape,
              fsdp_size: int = 1, fsdp_min_elems: int = _FSDP_MIN_ELEMS,
              replicate_embeddings: bool = False) -> Spec:
    """The axis name (or None) of every dim of one parameter leaf, keyed by
    its field name: TP placement first, then FSDP on the first free,
    divisible dim left of the TP dim (the stacked depth axis of block
    weights, where it divides)."""
    name = path.split("/")[-1]
    none: list = [None] * ndim
    if model_size > 1:
        if name in _COL_PARALLEL and shape[-1] % model_size == 0:
            none[-1] = MODEL_AXIS
        elif name in _ROW_PARALLEL and ndim >= 2 and shape[-2] % model_size == 0:
            none[-2] = MODEL_AXIS
        elif name == "wte" and shape[0] % model_size == 0 and not replicate_embeddings:
            none[0] = MODEL_AXIS
    if fsdp_size > 1 and int(np.prod(shape or (1,))) >= fsdp_min_elems:
        tp_dim = next((d for d in range(ndim) if none[d] is not None), ndim)
        for d in range(tp_dim):
            if none[d] is None and shape[d] % fsdp_size == 0:
                none[d] = DATA_AXIS
                break
    return tuple(none)


def param_specs(params: Any, model_size: int, fsdp_size: int = 1,
                fsdp_min_elems: int = _FSDP_MIN_ELEMS,
                replicate_embeddings: bool = False) -> Any:
    """The spec tree matching ``params``."""
    def walk(tree, path=""):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in tree.items()}
        return _spec_for(path, len(tree.shape), model_size, tuple(tree.shape), fsdp_size,
                         fsdp_min_elems, replicate_embeddings)

    return walk(params)


def _grouped(name: str, axis: str) -> bool:
    return axis == MODEL_AXIS and name in _FUSED_QKV


def _split(x: torch.Tensor, dim: int, parts: int, index: int, grouped: bool) -> torch.Tensor:
    if grouped:
        if (x.shape[dim] // 3) % parts:
            raise ValueError(f"fused QKV width {x.shape[dim] // 3} does not split into "
                             f"{parts} head groups")
        return x.unflatten(dim, (3, -1)).chunk(parts, dim + 1)[index].flatten(dim, dim + 1)
    return x.chunk(parts, dim)[index]


def shard_leaf(x: torch.Tensor, spec: Spec, mesh: Mesh, name: str = "") -> torch.Tensor:
    """This rank's shard of one leaf (``name`` its field name: the fused
    QKV leaves split by head groups over ``model``)."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            x = _split(x, dim, mesh.size(axis), mesh.coord(axis), _grouped(name, axis))
    return x.contiguous()


def shard_params(params: Any, mesh: Mesh, fsdp: bool = False,
                 fsdp_min_elems: int = _FSDP_MIN_ELEMS,
                 replicate_embeddings: bool = False) -> Tuple[Any, Any]:
    """(this rank's local shards, the spec tree) of a full parameter tree:
    TP over ``model``, plus FSDP over ``data`` with ``fsdp``.
    ``replicate_embeddings=True`` is the inference placement: a
    vocab-sharded ``wte`` would make every decode step gather [rows, vocab]
    logits for its selection. Optimizer state made from the result lives on
    the local shards only (the ZeRO memory win)."""
    specs = param_specs(params, mesh.model, mesh.data if fsdp else 1, fsdp_min_elems,
                        replicate_embeddings)

    def walk(tree, spec, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k], k) for k, v in tree.items()}
        return shard_leaf(tree, spec, mesh, name)

    return walk(params, specs), specs


def gather_leaf(x: torch.Tensor, spec: Spec, mesh: Mesh, name: str = "") -> torch.Tensor:
    """The full leaf from every rank's shard (inverse of ``shard_leaf``);
    every rank of the leaf's groups must call it."""
    for dim, axis in reversed(list(enumerate(spec))):
        if axis is None:
            continue
        if _grouped(name, axis):
            pieces = coll.all_gather(x.unflatten(dim, (3, -1)), mesh, axis, dim + 1)
            x = pieces.flatten(dim, dim + 1)
        else:
            x = coll.all_gather(x, mesh, axis, dim)
    return x


def gather_params(local: Any, specs: Any, mesh: Mesh) -> Any:
    """The full tree from the local shards of ``shard_params`` (bit-equal
    to the tree they were cut from)."""
    def walk(tree, spec, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k], k) for k, v in tree.items()}
        return gather_leaf(tree, spec, mesh, name)

    return walk(local, specs)


def replicas(spec: Spec, mesh: Mesh) -> int:
    """How many ranks hold the same piece of a leaf of ``spec``: the sizes
    of the axes it is not sharded over."""
    return (1 if DATA_AXIS in spec else mesh.data) * (1 if MODEL_AXIS in spec else mesh.model)


def check_heads(num_heads: int, mesh: Mesh, what: str) -> None:
    """Head-grouped shards need whole heads on every model rank."""
    if num_heads % mesh.model:
        raise ValueError(f"{what}: {num_heads} heads do not split over a model axis of "
                         f"size {mesh.model}")
