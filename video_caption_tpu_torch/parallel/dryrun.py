"""Multi-device dry run of the port (counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``), and the rank workers that the mesh
tests and ``chip_smoke.py``'s mesh phase spawn.

    python -m video_caption_tpu_torch.parallel.dryrun --world 4 --device cpu
    python -m video_caption_tpu_torch.parallel.dryrun --world 2 --backend gloo

spawns ``--world`` ranks (``torch.multiprocessing``, spawn start method),
joined through a ``file://`` store in a temporary directory, on ``--device``
(default ``cuda``: ranks beyond the cards share them, which NCCL refuses,
so they need ``--backend gloo``; on the CPU the backend is gloo). At a
tiny geometry whose heads are 64 wide, as the kernels take them on the card
(width 128, 2 heads, 2 layers, vocab 256, f32), the ranks run the JAX dry
run's four checks on a ``(world / 2, 2)`` mesh (``(world, 1)`` for an odd
world):

1. one mapper-trainer step: a finite loss;
2. the same step with FSDP (``fsdp_min_elems=0``; on an all-data mesh
   where the main mesh has one data rank): the loss within 1e-4 of 1.'s,
   leaves sharded over ``data`` and all-gathers over ``data`` in the step;
3. ``infer_batch`` with the serving presets (beam-3, beam-4 and the
   sampled group) on the mesh engine: results equal to a single-device
   engine's with the same seed;
4. the decode-collective gate (with a model axis): under the inference
   placement the largest collective of a decode step moves at most
   rows x n_embd elements and none has a vocab-sized dim, and a [rows,
   vocab] all-gather of sharded logits trips it.

Rank 0 prints each check. Every rank's exit code is checked, and a world
that does not finish within ``--timeout`` seconds is killed and fails.

The spawned ranks import this module and the port, never a test module
(and through one, ``jax``).
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import queue as queue_mod
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from video_caption_tpu_torch.config import MeshConfig
from video_caption_tpu_torch.parallel import collectives as coll
from video_caption_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, default_backend,
                                                   gather_leaf, gather_params, make_mesh,
                                                   shard_params)
from video_caption_tpu_torch.training.optim import leaves

FSDP_LOSS_TOL = 1e-4
"""|FSDP loss - DPxTP loss| of one step in f32 (the JAX dry run allows 1e-3)."""

WORDS = ("a man woman dog cat is are the on in with red blue small big runs walks plays "
         "sits holds ball car street park table water food girl boy child playing riding "
         "eating talking").split()


class WordTokenizer:
    """The tiny geometries' tokenizer (EOS 127): ids decode to
    words that the text cleaner keeps, so the captions of random weights
    can be compared as text."""

    eos_token_id = bos_token_id = pad_token_id = 127
    vocab_size = 128

    def encode(self, text):
        return [b % 127 for b in text.encode()] or [1]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(WORDS[int(i) % len(WORDS)] for i in ids if int(i) != 127)


def tiny_model_config():
    """The dry run's geometry in f32: 64-wide heads (the kernels' on the
    card), a vocabulary unlike the width (the decode gate tells them
    apart)."""
    from video_caption_tpu_torch.models import caption_model as cm
    from video_caption_tpu_torch.models import gpt2 as g2
    from video_caption_tpu_torch.models import vit as vt

    return cm.CaptionModelConfig(
        vit=vt.ViTConfig(image_size=32, patch_size=16, embed_dim=128, depth=2, num_heads=2,
                         out_dim=16, dtype=torch.float32),
        gpt2=g2.GPT2Config(vocab_size=256, max_position_embeddings=64, n_embd=128, n_layer=2,
                           n_head=2, dtype=torch.float32),
        prefix_len=4, video_dim=16)


def to_numpy(tree):
    """A copy of a tensor tree as numpy arrays (a step that updates the
    tensors in place leaves it as it was)."""
    return {k: to_numpy(v) if isinstance(v, dict) else np.array(v.detach().cpu())
            for k, v in tree.items()}


def to_torch(tree, device):
    return {k: to_torch(v, device) if isinstance(v, dict) else torch.from_numpy(np.array(v)).to(device)
            for k, v in tree.items()}


# ---- the world: one process per rank ---------------------------------------

@dataclass(frozen=True)
class Rank:
    """What a rank's function is told about its world."""

    rank: int
    world: int
    device: str
    backend: str

    def mesh(self, data: int, model: int):
        return make_mesh(MeshConfig(data=data, model=model), self.device, self.backend)


def _rank_main(rank: int, world: int, init: str, device: str, backend: str,
               fn: Callable, payload: Any, results) -> None:
    try:
        torch.set_num_threads(1)
        os.environ["LOCAL_RANK"] = str(rank)      # as torchrun sets it on one host
        dev = torch.device(device)
        if dev.type == "cuda":
            if dev.index is None:      # ranks beyond the cards share them
                dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
            device = str(dev)
        dist.init_process_group(backend, init_method=init, rank=rank, world_size=world)
        try:
            value = fn(Rank(rank, world, device, backend), payload)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, value))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_world(world: int, fn: Callable, payload: Any = None, device: str = "cpu",
              backend: Optional[str] = None, timeout: float = 120.0) -> List[Any]:
    """``fn(Rank, payload)`` on ``world`` spawned ranks (a module-level
    function, pickled by name), joined through a ``file://`` store in a
    fresh temporary directory; returns each rank's value in rank order.
    ``device`` ``cuda`` without an index puts rank r on card r modulo the
    cards there are.
    Raises with the rank's traceback where one fails, and TimeoutError
    (after killing the world) where the world has not finished within
    ``timeout`` seconds."""
    backend = backend or default_backend(device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    values: Dict[int, Any] = {}
    errors: Dict[int, str] = {}
    with tempfile.TemporaryDirectory(prefix="vct_world_") as tmp:
        init = f"file://{Path(tmp) / 'store'}"
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, init, device, backend, fn, payload, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        dead_since: Dict[int, float] = {}
        try:
            while len(values) + len(errors) < world and not errors:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    # a rank that died without a result (its last words may
                    # still be on their way: give them a few seconds)
                    now = time.monotonic()
                    for r, p in enumerate(procs):
                        if p.exitcode not in (None, 0) and r not in values:
                            if now - dead_since.setdefault(r, now) > 3.0:
                                errors[r] = f"rank {r} exited with {p.exitcode} without a result"
                    continue
                (values if ok else errors)[rank] = value
        finally:
            done = len(values) == world
            for p in procs:
                if done:
                    p.join(timeout=30.0)
                if p.is_alive():
                    p.kill()
                p.join()
    if errors:
        rank = min(errors)
        raise RuntimeError(f"rank {rank} of {world} failed:\n{errors[rank]}")
    missing = [r for r in range(world) if r not in values]
    if missing:
        raise TimeoutError(f"ranks {missing} of {world} did not finish within {timeout} s")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"rank exit codes {codes}")
    return [values[r] for r in range(world)]


# ---- checks a rank runs ----------------------------------------------------

def decode_collective_gate(records: Sequence[coll.Record], rows: int, n_embd: int,
                           vocab: int) -> Tuple[bool, Optional[coll.Record]]:
    """(passes, largest record) of the JAX dry run's gate on one decode
    step's collectives: every one moves at most ``rows * n_embd`` elements
    and none has a dim of the vocabulary's size (or its padded width)."""
    vocab_dims = {vocab, -(-vocab // 128) * 128}
    largest = max(records, key=lambda r: r.elements, default=None)
    ok = all(r.elements <= rows * n_embd and not vocab_dims & set(r.shape) for r in records)
    return ok, largest


def mesh_job(rank: Rank, shape: Tuple[int, int], wrong: Tuple[int, int]) -> dict:
    """The mesh's shape and this rank's coordinates; the ValueError of a
    mesh whose size is not the world's."""
    mesh = rank.mesh(*shape)
    try:
        make_mesh(MeshConfig(*wrong), rank.device, rank.backend)
        error = None
    except ValueError as e:
        error = str(e)
    return {"shape": mesh.shape, "coords": (mesh.data_rank, mesh.model_rank),
            "wrong_count_error": error}


def roundtrip_job(rank: Rank, shape: Tuple[int, int], params: dict) -> dict:
    """``gather_params(shard_params(...))`` bit-equal to the tree, in the
    inference placement, the training placement and with FSDP."""
    mesh = rank.mesh(*shape)
    full = to_torch(params, rank.device)
    out = {}
    for name, kw in (("inference", dict(replicate_embeddings=True)), ("training", {}),
                     ("fsdp", dict(fsdp=True, fsdp_min_elems=0))):
        local, specs = shard_params(full, mesh, **kw)
        flat = dict(leaves(gather_params(local, specs, mesh)))
        out[name] = all(torch.equal(flat[p], t) for p, t in leaves(full))
    return out


def engines_job(rank: Rank, shape: Tuple[int, int], model_cfg, params: dict, configs: dict,
                dirs: Sequence[str], seed: int, infer: Sequence[str] = ()) -> dict:
    """``infer_batch(dirs)`` of a mesh engine per inference config (every
    rank returns the whole batch), then for the configs named in ``infer``
    ``infer(dirs[0])`` (the one video on every data rank): {name:
    [to_api_dict() per video]} and {name + "/infer": to_api_dict()}."""
    from video_caption_tpu_torch.engine import InferenceEngine

    full = to_torch(params, rank.device)
    out = {}
    for name, cfg in configs.items():
        cfg = dataclasses.replace(cfg, mesh=MeshConfig(*shape))
        engine = InferenceEngine(cfg, params=full, model_cfg=model_cfg, seed=seed,
                                 device=rank.device)
        engine.tokenizer = WordTokenizer()
        out[name] = [r.to_api_dict() for r in engine.infer_batch(list(dirs))]
        if name in infer:
            out[f"{name}/infer"] = engine.infer(dirs[0]).to_api_dict()
    return out


def mapper_job(rank: Rank, shape: Tuple[int, int], model_cfg, params: dict, batches: list,
               out_dir: str, fsdp: bool = False, fsdp_min_elems: Optional[int] = None,
               unfreeze_last_gpt2: int = 1, ckpt_dir: Optional[str] = None) -> dict:
    """Mapper-trainer steps on the mesh, one per batch: the losses, the
    first step's gradient norm (before clipping) and all-gathers over
    ``data``, the leaves sharded over ``data``, the full parameters after
    the first step and the validation loss on the first batch then (with
    ``ckpt_dir``, the best-val checkpoint saved there)."""
    from video_caption_tpu_torch.training.mapper_trainer import MapperTrainer, TrainArgs

    args = TrainArgs(unfreeze_last_gpt2=unfreeze_last_gpt2, lr_gpt2=1e-3, val_every=10 ** 9,
                     out_dir=out_dir, ckpt_path=ckpt_dir or str(Path(out_dir) / "ckpt"))
    trainer = MapperTrainer(model_cfg, to_torch(params, rank.device), args,
                            mesh=MeshConfig(*shape), fsdp=fsdp, fsdp_min_elems=fsdp_min_elems)
    with coll.recording() as log:
        losses = [trainer.run_step(batches[0])]
    gathers = log.count("all_gather", DATA_AXIS)
    norm = float(trainer.grad_norm)
    full = to_numpy(trainer.full_params())
    val = trainer.evaluate(iter(batches[:1]))
    if ckpt_dir:
        trainer.maybe_checkpoint(val, 0)
    losses += [trainer.run_step(b) for b in batches[1:]]
    return {"losses": losses, "val": val, "grad_norm": norm, "data_gathers": gathers,
            "data_sharded": sum(DATA_AXIS in s for _, s in leaves(trainer.specs)),
            "model_sharded": sum(MODEL_AXIS in s for _, s in leaves(trainer.specs)),
            "params": full}


def gate_job(rank: Rank, shape: Tuple[int, int], model_cfg, params: dict, videos: int = 2,
             beams: int = 3, prefill: int = 6, steps: int = 4) -> dict:
    """The decode-collective gate on one beam step of this rank's rows
    (``videos`` of the batch per data rank, ``beams`` each) under the
    inference placement, and its trip on a [rows, vocab] all-gather of the
    step's logits sharded over ``model`` (what a vocab-sharded ``wte``
    would need for the selection)."""
    from video_caption_tpu_torch.models import gpt2 as g2

    mesh = rank.mesh(*shape)
    local, _ = shard_params(to_torch(params, rank.device), mesh, replicate_embeddings=True)
    cfg = dataclasses.replace(model_cfg.gpt2, mesh=mesh)
    dec, dev = local["decoder"], torch.device(rank.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    r, hl = videos * beams, cfg.local_embd

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(cfg.dtype)

    prefill_cache = {"k": randn(cfg.n_layer, videos, prefill, hl),
                     "v": randn(cfg.n_layer, videos, prefill, hl)}
    valid = torch.ones((videos, prefill), dtype=torch.int32, device=dev)
    gen_cache = g2.init_cache(cfg, r, steps, dev, layout="beam_gen")
    anc = torch.zeros((r, steps), dtype=torch.int32, device=dev)
    positions = torch.full((r,), prefill, device=dev)
    wte_t = g2.lm_head_t(dec, cfg)
    with coll.recording() as step, torch.inference_mode():
        (logits, *_), _ = g2.gpt2_beam_step(dec, randn(r, cfg.n_embd), positions, prefill_cache,
                                            valid, gen_cache, anc, 0, beams, cfg, wte_t)
    ok, largest = decode_collective_gate(step.records, r, cfg.n_embd, cfg.vocab_size)
    shard = logits[:, :cfg.vocab_size].chunk(mesh.model, dim=1)[mesh.model_rank]
    with coll.recording() as control:
        coll.all_gather(shard.contiguous(), mesh, MODEL_AXIS, dim=1)
    tripped = not decode_collective_gate(control.records, r, cfg.n_embd, cfg.vocab_size)[0]
    return {"ok": ok, "rows": r, "bound": r * cfg.n_embd,
            "largest": None if largest is None else (largest.op, largest.shape),
            "step_collectives": len(step.records), "control_tripped": tripped,
            "control": control.largest().shape}


def row_parallel_job(rank: Rank, shape: Tuple[int, int], rows: int = 5, width: int = 8,
                     out: int = 6) -> dict:
    """A row-parallel product on the mesh (``vit.row_linear``: this rank's
    input columns and weight rows, the all-reduce, the bias) against the
    whole product on one rank: the largest difference, and the bias's
    size (a bias added on every model rank would be off by
    (model - 1) x bias)."""
    from video_caption_tpu_torch.models.vit import linear, row_linear

    mesh = rank.mesh(*shape)
    gen = torch.Generator().manual_seed(7)
    x, w, b = (torch.randn(s, generator=gen) for s in ((rows, width), (width, out), (out,)))
    part = width // mesh.model
    cols = slice(mesh.model_rank * part, (mesh.model_rank + 1) * part)
    got = row_linear(x[:, cols], w[cols], b, mesh)
    return {"max_diff": float((got - linear(x, w, b)).abs().max()),
            "bias_max": float(b.abs().max())}


def chip_ranks_job(rank: Rank, **payload) -> dict:
    """``chip_mesh_ranks`` as a job of a world (its rehearsal on the CPU)."""
    return chip_mesh_ranks(rank, payload)


JOBS = {"mesh": mesh_job, "roundtrip": roundtrip_job, "engines": engines_job,
        "mapper": mapper_job, "gate": gate_job, "row_parallel": row_parallel_job,
        "chip_ranks": chip_ranks_job}


def run_jobs(rank: Rank, jobs: Sequence[Tuple[str, str, dict]]) -> dict:
    """The rank function of a world that runs several checks in one spawn:
    ``jobs`` holds (name, kind of ``JOBS``, keyword arguments); returns
    {name: result}."""
    return {name: JOBS[kind](rank, **kw) for name, kind, kw in jobs}


# ---- chip_smoke.py's mesh phase: full width on the card ---------------------

PREFILL_IDS = [[32, 65, 32, 109, 97, 110]]
"""The prompt ids after the prefix whose prefill logits the mesh phase
compares (chip_smoke.py phase 6's)."""


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def kernel_counts() -> Dict[str, int]:
    from video_caption_tpu_torch.ops import selfcheck

    return {name: spec[3].launches for name, spec in selfcheck.KERNELS.items()}


def reset_kernel_counts() -> None:
    from video_caption_tpu_torch.ops import selfcheck

    for spec in selfcheck.KERNELS.values():
        spec[3].launches = 0


def prefill_logits(params, cfg, embeds):
    """Logits [B, Vp] of the last position of one prefill (chip_smoke.py
    phase 6's)."""
    from video_caption_tpu_torch.models import gpt2 as g2

    b, s, _ = embeds.shape
    cache = g2.init_cache(cfg, b, s, embeds.device)
    valid = torch.ones((b, s), dtype=torch.int32, device=embeds.device)
    pos = torch.arange(s, device=embeds.device)[None].expand(b, s)
    (logits, _, _, _), _ = g2.gpt2_forward(params, embeds, pos, valid, cache, 0, cfg,
                                           wte_t=g2.lm_head_t(params, cfg), last_only=True,
                                           return_stats=True)
    return logits


def engine_request(engine, dirs: Sequence[str]) -> dict:
    """One ``infer_batch`` of ``dirs`` on ``engine`` with the kernels'
    counts set to 0 just before and read just after: the ids of every
    decode group, whether each group samples, the results, the launches
    and the seconds; then the prefix and the prefill logits of the first
    video."""
    from video_caption_tpu_torch.models import caption_model as cm

    dev = engine.device
    _sync(dev)
    reset_kernel_counts()
    t0 = time.perf_counter()
    handle = engine.infer_batch_dispatch(list(dirs))
    ids = engine._collect_ids(handle)
    results = [r.to_api_dict() for r in engine.infer_batch_collect(handle)]
    _sync(dev)
    seconds = time.perf_counter() - t0
    launches = kernel_counts()
    with torch.inference_mode():
        prefix = engine.compute_prefix(engine.load_video(dirs[0]))
        ids0 = torch.tensor(PREFILL_IDS, device=dev)
        emb = cm.build_decoder_inputs(engine.params, prefix, ids0, engine.model_cfg)
        logits = prefill_logits(engine.params["decoder"], engine.model_cfg.gpt2, emb)
    return {"ids": [np.array(x) for x in ids],
            "sampled": [dp.do_sample for dp, *_ in handle.group_list], "results": results,
            "launches": launches, "seconds": seconds, "prefix": np.array(prefix.float().cpu()),
            "logits": np.array(logits.float().cpu())}


def rows_alone_ids(engine, dirs: Sequence[str], data: int, seed: int) -> List[np.ndarray]:
    """What a ``(data, 1)`` mesh engine seeded ``seed`` decodes in its first
    ``infer_batch(dirs)``, from the single-device ``engine`` (same weights):
    each data rank's videos decoded alone, at the rank's own row count, on
    the rank's rows of the whole batch's noise drawn from a generator
    seeded ``seed``; the ids of every group, all ranks' rows in order."""
    from video_caption_tpu_torch.parallel.mesh import Mesh, rows_of

    program, _ = engine._program_for(len(dirs))
    gen = torch.Generator(device=engine.device).manual_seed(seed)
    noises = engine.request_noise(len(dirs), generator=gen)
    per_rank = []
    for d in range(data):
        mesh = Mesh(data=data, data_rank=d)
        video = engine._load_videos(list(rows_of(np.asarray(list(dirs), dtype=object), mesh)))
        mine = tuple(None if n is None else rows_of(n, mesh, dim=1) for n in noises)
        with torch.inference_mode():
            per_rank.append([np.array(x.cpu()) for x in program.core(engine.params, video, mine)])
    return [np.concatenate(group) for group in zip(*per_rank)]


def full_width_mapper_config(n_layer: int = 2):
    """The mapper trainer's full-width configuration (ViT-B/16 at 224,
    GPT-2 124M widths) at ``n_layer`` GPT-2 layers, bf16 compute."""
    from video_caption_tpu_torch.config import default_inference_config
    from video_caption_tpu_torch.engine import model_config_from_inference

    mc = model_config_from_inference(default_inference_config(ckpt="none.pt"))
    return dataclasses.replace(mc, gpt2=dataclasses.replace(mc.gpt2, n_layer=n_layer))


def _trained(pairs) -> Dict[str, np.ndarray]:
    """Of (path, leaf) pairs, the leaves that a mapper step with
    ``unfreeze_last_gpt2=1`` trains, in f32: the mapper's, the adapters'
    and the last GPT-2 block's."""
    return {p: np.array((t[-1] if p.startswith("/decoder/blocks/") else t).float().cpu())
            for p, t in pairs if p.startswith(("/mapper", "/proj", "/decoder/blocks/"))}


def mapper_step(mesh: Optional[MeshConfig], model_cfg, batch: dict, seed: int, out_dir: str,
                device, **kw) -> dict:
    """One mapper-trainer step (``unfreeze_last_gpt2=1``) from the seeded
    init on a ``mesh`` mesh (None: one device): its loss, gradient norm
    (before the clip), seconds and all-gathers over ``data``; from rank 0,
    the trained leaves (``_trained``) before and after the step, gathered."""
    from video_caption_tpu_torch.models import caption_model as cm
    from video_caption_tpu_torch.training.mapper_trainer import MapperTrainer, TrainArgs

    params = cm.init_caption_model(seed, model_cfg, device)
    before = _trained(leaves(params))
    trainer = MapperTrainer(model_cfg, params, TrainArgs(out_dir=out_dir, unfreeze_last_gpt2=1),
                            mesh=mesh, **kw)
    _sync(device)
    with coll.recording() as log:
        t0 = time.perf_counter()
        loss = trainer.run_step(batch)
        _sync(device)
        seconds = time.perf_counter() - t0
    launches = kernel_counts()
    specs = dict(leaves(trainer.specs))
    after = _trained((p, gather_leaf(t, specs[p], trainer.mesh, p.split("/")[-1]))
                     for p, t in leaves(trainer.params) if p in before)
    first = trainer.mesh.rank == 0
    return {"loss": loss, "grad_norm": float(trainer.grad_norm), "seconds": seconds,
            "data_gathers": log.count("all_gather", DATA_AXIS),
            "data_sharded": sum(DATA_AXIS in s for _, s in leaves(trainer.specs)),
            "launches": launches, "before": before if first else None,
            "after": after if first else None}


def _chip_engine(rank: Rank, cfg, payload: dict):
    """The engine of the mesh phase, as a user builds it on a rank: its
    mesh from ``cfg.mesh`` over the process group, its device named
    without an index (``cuda`` resolves to ``cuda:LOCAL_RANK``), seeded
    random weights at full width, or at the rehearsal's
    ``payload["model_cfg"]`` with the tiny tokenizer."""
    from video_caption_tpu_torch.engine import InferenceEngine

    engine = InferenceEngine(cfg, seed=payload["seed"], device=torch.device(rank.device).type,
                             model_cfg=payload.get("model_cfg"))
    if engine.device != torch.device(rank.device):
        raise AssertionError(f"rank {rank.rank}'s engine is on {engine.device}, "
                             f"not {rank.device}")
    if payload.get("model_cfg") is not None:
        engine.tokenizer = WordTokenizer()
    return engine


def chip_mesh_ranks(rank: Rank, payload: dict) -> dict:
    """chip_smoke.py's two ranks on one card: the full-width engine with the
    core presets at 1x2 (TP) and at 2x1 (DP), eagerly, on
    ``payload["dirs"]`` (``engine_request``); then one mapper-trainer step
    at 2x1 with ``fsdp=True, fsdp_min_elems=0`` at 2 GPT-2 layers.
    ``payload["model_cfg"]`` and ``["mapper_cfg"]`` (default: full width)
    make a rehearsal at another geometry."""
    from video_caption_tpu_torch.config import default_inference_config

    out = {}
    base = default_inference_config(ckpt=payload["ckpt"], num_frames=payload["num_frames"],
                                    image_size=payload["image_size"])
    for shape in ((1, 2), (2, 1)):
        engine = _chip_engine(rank, dataclasses.replace(base, mesh=MeshConfig(*shape)), payload)
        out[shape] = engine_request(engine, payload["dirs"])
        del engine
    out["fsdp"] = mapper_step(MeshConfig(2, 1),
                              payload.get("mapper_cfg") or full_width_mapper_config(),
                              payload["batch"], payload["seed"],
                              f"{payload['out_dir']}/rank{rank.rank}", torch.device(rank.device),
                              fsdp=True, fsdp_min_elems=0)
    return out


def chip_nccl_rank(rank: Rank, payload: dict) -> dict:
    """chip_smoke.py's one-rank NCCL group: an all-reduce, an all-gather and
    a reduce-scatter of ``parallel/collectives.py`` on CUDA tensors over
    each axis (each must return its input), then the core-preset engine,
    which on the one rank of a process group takes a 1x1 mesh (its batch's
    ids gathered over ``data`` through NCCL)."""
    from video_caption_tpu_torch.config import default_inference_config

    mesh = rank.mesh(1, 1)
    dev = torch.device(rank.device)
    x = torch.randn((4, 768), generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    same = {}
    with coll.recording() as log:
        for axis in (DATA_AXIS, MODEL_AXIS):
            same[f"all_reduce/{axis}"] = torch.equal(coll.all_reduce(x, mesh, axis), x)
            same[f"all_gather/{axis}"] = torch.equal(coll.all_gather(x, mesh, axis, 1), x)
            same[f"reduce_scatter/{axis}"] = torch.equal(coll.reduce_scatter(x, mesh, axis), x)
        _sync(dev)
    base = default_inference_config(ckpt=payload["ckpt"], num_frames=payload["num_frames"],
                                    image_size=payload["image_size"])
    engine = _chip_engine(rank, base, payload)
    with coll.recording() as request_log:
        request = engine_request(engine, payload["dirs"])
    return {"backend": dist.get_backend(), "same": same, "collectives": len(log.records),
            "on_mesh": engine.mesh is not None, "request": request,
            "request_collectives": [(r.op, r.axis, r.shape) for r in request_log.records]}


# ---- the dry run -----------------------------------------------------------

def make_frame_dirs(root: Path, count: int, frames: int = 2, size: int = 32,
                    seed: int = 0) -> List[str]:
    """``count`` directories of seeded random JPEG frames."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    dirs = []
    for v in range(count):
        d = root / f"video{v}"
        d.mkdir(parents=True, exist_ok=True)
        for i in range(frames):
            Image.fromarray(rng.randint(0, 255, (size, size, 3), np.uint8)).save(
                d / f"frame_{i:05d}.jpg")
        dirs.append(str(d))
    return dirs


def mapper_batch(size: int, seed: int = 0, frames: int = 2, image: int = 32,
                 length: int = 8, vocab: int = 127) -> dict:
    rng = np.random.RandomState(seed)
    mask = np.ones((size, length), np.int32)
    mask[0, length // 2:] = 0      # one short caption: the token count differs between rows
    return {"video": rng.randn(size, frames, 3, image, image).astype(np.float32),
            "caption_ids": rng.randint(0, vocab, (size, length)).astype(np.int32),
            "attention_mask": mask}


def dry_run_checks(rank: Rank, payload: dict) -> dict:
    """The four checks of the module docstring on this rank."""
    from video_caption_tpu_torch.config import serving_inference_config
    from video_caption_tpu_torch.engine import InferenceEngine
    from video_caption_tpu_torch.models import caption_model as cm

    cfg = tiny_model_config()
    params = to_numpy(cm.init_caption_model(0, cfg, rank.device))
    model = 2 if rank.world % 2 == 0 else 1
    shape = (rank.world // model, model)
    fsdp_shape = shape if shape[0] > 1 else (rank.world, 1)
    batch = mapper_batch(max(2 * shape[0], fsdp_shape[0] * 2))
    out_dir = payload["out_dir"]
    out = {"shape": shape}
    plain = mapper_job(rank, shape, cfg, params, [batch], f"{out_dir}/plain")
    fsdp = mapper_job(rank, fsdp_shape, cfg, params, [batch], f"{out_dir}/fsdp", fsdp=True,
                      fsdp_min_elems=0)
    out["train"] = {"loss": plain["losses"][0]}
    out["fsdp"] = {"loss": fsdp["losses"][0], "shape": fsdp_shape,
                   "data_sharded": fsdp["data_sharded"], "data_gathers": fsdp["data_gathers"]}
    infer_cfg = serving_inference_config(ckpt="missing.pt", num_frames=2, image_size=32)
    single = InferenceEngine(infer_cfg, params=to_torch(params, rank.device), model_cfg=cfg,
                             seed=5, device=rank.device)
    single.tokenizer = WordTokenizer()
    dirs = payload["dirs"]
    want = [r.to_api_dict() for r in single.infer_batch(dirs)]
    got = engines_job(rank, shape, cfg, params, {"serving": infer_cfg}, dirs, 5)["serving"]
    out["infer"] = {"identical": got == want, "videos": len(dirs)}
    if model > 1:
        out["gate"] = gate_job(rank, shape, cfg, params)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--world", type=int, default=4)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default: the ranks share the cards) or cpu")
    parser.add_argument("--backend", default=None,
                        help="process group backend (default: nccl on cuda, gloo on cpu)")
    parser.add_argument("--timeout", type=float, default=600.0)
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("dryrun: --device cuda but torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory(prefix="vct_dryrun_") as tmp:
        model = 2 if args.world % 2 == 0 else 1
        dirs = make_frame_dirs(Path(tmp), max(args.world // model, 2))
        payload = {"out_dir": tmp, "dirs": dirs}
        results = run_world(args.world, dry_run_checks, payload, args.device, args.backend,
                            args.timeout)
    res = results[0]
    if any(r != res for r in results[1:]):
        raise AssertionError(f"the ranks disagree: {results}")
    loss, fsdp = res["train"]["loss"], res["fsdp"]
    print(f"dryrun train ok: mesh {res['shape']} loss={loss:.6f}")
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    print(f"dryrun fsdp: loss={fsdp['loss']:.6f} (|diff| {abs(fsdp['loss'] - loss):.2e}, tol "
          f"{FSDP_LOSS_TOL:g}), mesh {fsdp['shape']}, {fsdp['data_sharded']} leaves data-sharded, "
          f"{fsdp['data_gathers']} all-gathers over data in the step")
    if not (abs(fsdp["loss"] - loss) < FSDP_LOSS_TOL and fsdp["data_sharded"] > 0
            and fsdp["data_gathers"] > 0):
        raise AssertionError(f"FSDP check failed: {fsdp}")
    print(f"dryrun infer: {res['infer']['videos']} videos, serving presets (beam-3, beam-4, "
          f"sampled) identical to the single-device engine: {res['infer']['identical']}")
    if not res["infer"]["identical"]:
        raise AssertionError("the mesh engine's results differ from the single-device engine's")
    if "gate" in res:
        g = res["gate"]
        print(f"dryrun decode-collective gate: {g['step_collectives']} collectives in a beam "
              f"step, largest {g['largest']} <= {g['bound']} elements ({g['rows']} rows): "
              f"{g['ok']}; [rows, vocab] all-gather control {g['control']} tripped: "
              f"{g['control_tripped']}")
        if not (g["ok"] and g["control_tripped"]):
            raise AssertionError(f"decode-collective gate failed: {g}")
    print("dryrun: every check passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
