"""The collectives of the port's multi-device paths, over a mesh's process
groups (no counterpart in the JAX package, where GSPMD inserts them).

- ``copy_to_model``: identity forward, all-reduce over ``model`` backward;
  at the input of every column-parallel product, so that what feeds it
  (LayerNorm, the mapper, the prefix) gets its whole gradient;
- ``reduce_from_model``: all-reduce over ``model`` forward, identity
  backward; after every row-parallel product (its replicated bias is added
  once, after it);
- ``gather_from_data``: all-gather over ``data`` forward, reduce-scatter
  backward: FSDP's gather of a claimed leaf at the step;
- ``vocab_parallel_embedding`` and ``vocab_parallel_nll``: the lookup and
  the cross-entropy over a vocab-sharded ``wte`` (the training placement
  where the vocab divides).

Inside ``with recording() as log:`` every collective that reaches a process
group adds a record (op, axis, shape) to ``log``; the tests and the dry run
read it as the JAX package's tests read the compiled step's all-gathers and
the decode loop's largest collective. Outside one nothing is recorded. A
mesh without a DeviceMesh (one process) makes every collective the identity.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclass(frozen=True)
class Record:
    op: str                      # all_reduce | all_gather | reduce_scatter
    axis: str
    shape: Tuple[int, ...]       # the larger side: the gathered tensor, the scattered input

    @property
    def elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n


class CollectiveLog:
    """Records of the collectives made inside one ``recording`` block."""

    def __init__(self):
        self.records: List[Record] = []

    def count(self, op: str, axis: Optional[str] = None) -> int:
        return sum(r.op == op and (axis is None or r.axis == axis) for r in self.records)

    def largest(self) -> Optional[Record]:
        return max(self.records, key=lambda r: r.elements, default=None)


# the open recording's log: a module global, not a thread-local, because
# autograd runs a CUDA backward on a thread of its own
_log: Optional[CollectiveLog] = None


@contextmanager
def recording() -> Iterator[CollectiveLog]:
    """Record every collective made inside the block (on any thread) in
    the log it yields; the block's end restores the recording around it."""
    global _log
    outer, _log = _log, CollectiveLog()
    try:
        yield _log
    finally:
        _log = outer


def _record(op: str, axis: str, shape) -> None:
    if _log is not None:
        _log.records.append(Record(op, axis, tuple(int(d) for d in shape)))


def _group(mesh, axis: str):
    return None if mesh is None else mesh.group(axis)


def all_reduce(x: torch.Tensor, mesh, axis: str, op: str = "sum") -> torch.Tensor:
    """The sum (or max) of ``x`` over the ranks of ``axis``, out of place."""
    group = _group(mesh, axis)
    if group is None:
        return x
    out = x.contiguous().clone()
    _record("all_reduce", axis, out.shape)
    dist.all_reduce(out, op=_OPS[op], group=group)
    return out


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` of ``axis``, concatenated along ``dim`` in rank order."""
    group = _group(mesh, axis)
    if group is None:
        return x
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((mesh.size(axis) * xs.shape[0],) + tuple(xs.shape[1:]))
    _record("all_gather", axis, out.movedim(0, dim).shape)
    dist.all_gather_into_tensor(out, xs, group=group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """This rank's piece along ``dim`` of the sum of ``x`` over ``axis``."""
    group = _group(mesh, axis)
    if group is None:
        return x
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((xs.shape[0] // mesh.size(axis),) + tuple(xs.shape[1:]))
    _record("reduce_scatter", axis, x.shape)
    dist.reduce_scatter_tensor(out, xs, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim).contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.mesh, MODEL_AXIS), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x, mesh, MODEL_AXIS)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return all_gather(x, mesh, DATA_AXIS, dim)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad, ctx.mesh, DATA_AXIS, ctx.dim), None, None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mesh)


def gather_from_data(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    return _GatherFromData.apply(x, mesh, dim)


def vocab_parallel_embedding(wte: torch.Tensor, ids: torch.Tensor, mesh) -> torch.Tensor:
    """Rows of the full embedding from this rank's vocab shard ``wte``
    [V/m, H]: each rank looks up the ids in its range, zeros the rest, and
    the all-reduce over ``model`` sums the one row that is not zero."""
    vl = wte.shape[0]
    local = ids.long() - mesh.model_rank * vl
    inside = (local >= 0) & (local < vl)
    rows = wte[local.clamp(0, vl - 1)]
    return reduce_from_model(torch.where(inside[..., None], rows, torch.zeros_like(rows)), mesh)


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor, mesh) -> torch.Tensor:
    """-log softmax at ``labels`` from this rank's vocab shard of the logits
    [.., V/m] (f32): the row max, the sum of exponentials and the target
    logit are each reduced over ``model``."""
    vl = logits.shape[-1]
    m = all_reduce(logits.detach().amax(dim=-1), mesh, MODEL_AXIS, op="max")
    z = logits - m[..., None]
    sumexp = reduce_from_model(z.exp().sum(dim=-1), mesh)
    local = labels.long() - mesh.model_rank * vl
    inside = (local >= 0) & (local < vl)
    target = z.gather(-1, local.clamp(0, vl - 1)[..., None])[..., 0]
    target = reduce_from_model(torch.where(inside, target, torch.zeros_like(target)), mesh)
    return sumexp.log() - target


def tensor_parallel(mesh) -> bool:
    """Whether the model code splits its heads and products over ``model``."""
    return mesh is not None and mesh.model > 1


def column_input(x: torch.Tensor, mesh) -> torch.Tensor:
    """The input of a column-parallel product (``copy_to_model`` under TP)."""
    return copy_to_model(x, mesh) if tensor_parallel(mesh) else x


def row_output(partial: torch.Tensor, bias: torch.Tensor, mesh) -> torch.Tensor:
    """A row-parallel product's result: the partial sums all-reduced over
    ``model``, then the replicated bias added once."""
    return reduce_from_model(partial, mesh) + bias.to(partial.dtype)
