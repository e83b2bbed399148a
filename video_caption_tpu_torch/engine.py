"""Inference engine: frames_dir -> three candidate captions -> best-of-3
(counterpart of video_caption_tpu/engine.py).

One request runs: frame load (the C++ libjpeg loader, or PIL where the
native library is unavailable) -> upload of uint8 pixels, or of raw 4:2:0
planes that the device turns into the same pixels -> ViT-B/16 -> prefix
norm -> mapper -> one grouped decode per distinct policy (presets with the
same policy decode as one left-padded batch) -> text cleaning -> best-of-3.
Every kernel of that path is a hand-written CUDA kernel on the GPU (ops/),
and its plain PyTorch version on the CPU. The compile switches
``use_pallas_decode_attention`` and ``use_pallas_decode_layer`` (off by
default, as in the JAX package) put the greedy/sampled decode steps through
the decode-attention or the whole-step decode-layer kernel;
``deferred_decode_cache_write`` (off by default) writes each decode step's
K/V once after the layer loop, with the beam-attention kernel in its
deferred mode. ``sample_split_cache`` (off by default) puts the
greedy/sampled steps on the beam path's split cache.
``quantize_decoder_int8`` stores the four block matmul weights of every
GPT-2 layer as int8 with f32 per-channel scales, quantized after the bf16
cast, and turns ``use_pallas_decode_layer`` off (that kernel reads plain
weights), as the JAX engine does. ``early_stop_decode`` ends a decode once
every row (at HF's ``is_done`` for beams) has finished, with a read of the
condition on the host; such a request runs eagerly, group by group, since a
captured graph runs a fixed number of steps.

A single video is served, as in the JAX package, by one request program
from the uploaded video to the token ids of every decode group
(``_fused_infer_program``, on with ``compile.fuse_single_request`` and
``compile.aot_request_program``, both on by default). With two or more
policy groups that program decodes them all in one beam-step loop
(``decode/unified.py``, ``compile.unified_fused_request``, on by default;
``_unified_eligible``), which reads the GPT-2 weights once a step for every
group; its ids equal the grouped decode's. On CUDA the program is captured
once per video shape into a CUDA graph (``aot.RequestGraph``, the
counterpart of ``_aot_single_exec``) and every request replays it: one host
call for the whole request instead of one per kernel. A capture that fails
raises. ``aot_request_program=False`` (``VIDEO_CAPTION_AOT_REQUEST=0``)
serves the request eagerly, op by op (``generate_presets``); on a CPU
engine the program runs uncaptured.

Batches (``infer_batch``, and its halves ``infer_batch_dispatch`` and
``infer_batch_collect`` that the serving queue double-buffers) load their
videos through a device-resident LRU (``VIDEO_CAPTION_VIDEO_CACHE_MB``,
default 256, 0 disables it) and worker threads, then run one program for
the whole batch: the request program under
``compile.fuse_request_program``, else the batch program (each policy group
decoded in turn, or all in one unified loop under ``compile.unified_decode``).
On CUDA with ``aot_request_program`` each batch size's program is a graph
of its own, captured on first use; dispatch replays it, enqueues the ids'
copy into a pinned host buffer of the handle and returns without waiting.

A request whose video is not in the device video cache takes, as in the
JAX package, the overlapped cold path (``compile.overlap_single_upload``,
on by default; ``_load_feats_overlapped``): the frames decode on the host
in chunks of 8, and each chunk is uploaded from pinned memory without
waiting and its ViT trunk (the 4:2:0 finish where the chunk came as planes,
the normalisation, every layer, the CLS token) enqueued behind it while the
host decodes the next chunk. On CUDA that trunk is one replay of a graph
per chunk shape. The per-frame features [1,T,E] then feed the feats
request program (``_fused_feats_program``: the visual branch's temporal
half, the mapper and the decode), a graph of its own keyed by their shape;
the assembled pixels fill the video cache, so a repeat request takes the
pixel program. Under ``compile.yuv420_wire`` (on by default) frames that
are 4:2:0 JPEGs at exactly the model's size travel as their raw planes
(half the bytes of RGB; ``preprocessing/yuv420.py`` finishes the decode on
the device, bit-exactly): the native loader's ``last_backend`` says which
wire a load took. Without the native loader every frame travels as RGB.

``infer``, ``infer_batch_dispatch`` and ``infer_batch_collect`` run inside
``self.memory.oom_guard()``, as in the JAX package: a device OOM logs a
snapshot of the device's memory, then re-raises.

While a torch profiler session runs, the engine records spans and
counters (``tracing``): ``engine.dispatch`` and ``engine.collect`` around
a batch's halves; under them ``engine.lookup`` (counters ``cache.hits``,
``cache.misses``; ``cache.evictions`` where a put evicts), ``engine.load``
(the misses' decode and upload), ``engine.frame_decode`` (one per host
decode, attr ``frames``; counters ``frames.yuv420``,
``frames.native_rgb``, ``frames.pil`` by the path the frames took),
``engine.upload`` (counter ``h2d.bytes``), ``engine.assemble``,
``engine.replay`` (a graph replay or the eager program; it holds
``engine.capture`` on a shape's first use, counter ``graph.captures``),
``engine.readback``, ``engine.collect_wait`` (the host waiting for the
device) and ``engine.detokenize``; a cold single request's trunk and
feats programs are ``engine.trunk`` and ``engine.feats``.

The request program's core takes the weights, the video and the sampled
groups' noise as inputs and holds no generator (``program.core``; the
program draws the noise, ``request_noise``, then runs it): that core is
what ``aot.export_request_program`` serializes.

Under a mesh (``config.mesh`` of more than one device, or the one rank of an
initialised process group; parallel/mesh.py), as in the JAX engine: every
rank of the caller's process group builds the engine on its card
(``cuda:LOCAL_RANK`` where ``device`` names none), the weights take the
inference placement
(TP over ``model``, ``wte`` replicated) and ``infer_batch`` splits its
videos over ``data``. Each data rank loads its own videos, draws the
sampled groups' noise for the whole batch from the engine's generator and
takes its rows of it, decodes, and the ids are gathered over ``data``, so
every rank returns the whole batch's results in order; ``infer`` runs its
one video on every data rank. The request program runs uncaptured there and
the overlapped cold path is off: the JAX engine gates its AOT programs and
its overlap on the mesh in the same places.
"""
from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from video_caption_tpu_torch import tracing
from video_caption_tpu_torch.aot import RequestGraph
from video_caption_tpu_torch.config import InferenceConfig
from video_caption_tpu_torch.datatypes import CaptionCandidates, InferenceResult
from video_caption_tpu_torch.decode import unified
from video_caption_tpu_torch.decode.generate import (DecodeParams, generate, generate_prefixed,
                                                    sample_noise)
from video_caption_tpu_torch.decode.presets import preset_to_kwargs
from video_caption_tpu_torch.decode.tokenizer import get_tokenizer
from video_caption_tpu_torch.postprocessing.candidate_ranker import select_best
from video_caption_tpu_torch.postprocessing.text_cleaner import clean_text
from video_caption_tpu_torch.memory import MemoryManager
from video_caption_tpu_torch.models import caption_model as cm
from video_caption_tpu_torch.models import gpt2 as g2
from video_caption_tpu_torch.models import vit as vt
from video_caption_tpu_torch.models.convert import (load_reference_state, load_torch_checkpoint,
                                                    merge_params)
from video_caption_tpu_torch.models.quantize import is_scale, quantize_gpt2_blocks
from video_caption_tpu_torch.native import loader as native_loader
from video_caption_tpu_torch.parallel import collectives as coll
from video_caption_tpu_torch.parallel.mesh import (Mesh, check_heads, local_cuda_device,
                                                   make_mesh, rows_of, shard_params)
from video_caption_tpu_torch.preprocessing import frame_loader
from video_caption_tpu_torch.preprocessing.yuv420 import (packed_plane_len,
                                                          yuv420_packed_to_rgb_chw)
from video_caption_tpu_torch.training.checkpoint import restore_params

log = logging.getLogger(__name__)

_OVERLAP_CHUNK = 8
"""Frames a chunk of the overlapped cold path (the JAX engine's)."""

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model_config_from_inference(config: InferenceConfig) -> cm.CaptionModelConfig:
    if config.compile.dtype not in _DTYPES:
        raise ValueError(f"compile.dtype must be one of {sorted(_DTYPES)}")
    dtype = _DTYPES[config.compile.dtype]
    return cm.CaptionModelConfig(
        vit=vt.ViTConfig(image_size=config.image_size, dtype=dtype),
        gpt2=g2.GPT2Config(dtype=dtype,
                           use_pallas_decode=config.compile.use_pallas_decode_attention,
                           use_pallas_decode_layer=config.compile.use_pallas_decode_layer,
                           deferred_cache_write=config.compile.deferred_decode_cache_write,
                           sample_split_cache=config.compile.sample_split_cache),
        prefix_len=config.prefix_len,
        ln_scale=config.ln_scale,
        in_weight=config.in_weight,
    )


def load_params(config: InferenceConfig, model_cfg: cm.CaptionModelConfig, seed: int,
                device) -> dict:
    """A reference-format ``.pt``/``.pth``/``.bin`` checkpoint over a random
    init (what it lacks keeps its init), a trainer's checkpoint directory
    (``training/checkpoint.py``: ``model.pt`` and ``train_meta.json``), or
    random parameters when ``config.ckpt`` does not exist. Any other
    existing path, and a directory that does not restore into this model,
    raises: the engine never serves random weights in place of a checkpoint
    it cannot read."""
    init = cm.init_caption_model(seed, model_cfg, device)
    ckpt = Path(config.ckpt)
    if ckpt.is_file() and ckpt.suffix in {".pt", ".pth", ".bin"}:
        loaded = load_reference_state(load_torch_checkpoint(str(ckpt)), model_cfg)
        log.info("loaded reference checkpoint %s (%d families)", ckpt, len(loaded))
        return merge_params(init, loaded)
    if ckpt.is_dir():
        restored = restore_params(str(ckpt), init)
        if restored is not None:
            log.info("loaded checkpoint directory %s", ckpt)
            return merge_params(init, restored)
        raise RuntimeError(f"checkpoint {ckpt} exists but could not be restored; the port "
                           "will not serve random parameters in its place (the log says why)")
    if ckpt.exists():
        raise RuntimeError(f"checkpoint {ckpt} is neither a reference-format .pt file nor a "
                           "checkpoint directory; the port will not serve random parameters")
    log.warning("checkpoint %s not found; using randomly initialized parameters", ckpt)
    return init


def _cast_floating(tree, dtype: torch.dtype):
    """Floating leaves in ``dtype``; an int8 weight's f32 scales stay f32."""
    return {k: _cast_floating(v, dtype) if isinstance(v, dict)
            else (v.to(dtype) if v.is_floating_point() and not is_scale(tree, k) else v)
            for k, v in tree.items()}




@dataclass
class Dispatched:
    """A dispatched request or batch (``infer_batch_dispatch``): ``ids``, the
    packed ids of every decode group on the host (on CUDA a pinned buffer
    that the device fills after the program, ready once ``done`` has
    passed), ``group_list`` the program's decode groups, ``videos`` V."""

    ids: torch.Tensor
    done: Optional["torch.cuda.Event"]
    group_list: list
    videos: int


class InferenceEngine:
    """frames_dir -> InferenceResult on one device, or on this rank of a
    mesh (``config.mesh`` of more than one device, or the one rank of an
    initialised process group)."""

    def __init__(self, config: InferenceConfig, params: Optional[dict] = None, seed: int = 0,
                 model_cfg: Optional[cm.CaptionModelConfig] = None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but no CUDA device is available")
        # the mesh comes from config.mesh over the caller's process group;
        # the one rank of a group takes a 1x1 mesh, its collectives on it
        on_mesh = config.mesh.num_devices > 1 or (dist.is_initialized()
                                                  and dist.get_world_size() == 1)
        if on_mesh and self.device.type == "cuda" and self.device.index is None:
            self.device = local_cuda_device()
        self.config = config
        # an OOM inside a request logs the device's memory, then re-raises
        self.memory = MemoryManager(config.memory, self.device)
        cc = config.compile
        self.model_cfg = model_cfg or model_config_from_inference(config)
        if cc.quantize_decoder_int8 and self.model_cfg.gpt2.use_pallas_decode_layer:
            log.info("quantize_decoder_int8: use_pallas_decode_layer is off (the decode-layer "
                     "kernel reads plain weights)")
            self.model_cfg = dataclasses.replace(self.model_cfg, gpt2=dataclasses.replace(
                self.model_cfg.gpt2, use_pallas_decode_layer=False))
        self.mesh = None
        if on_mesh:
            self._check_mesh_options(cc)
            self.mesh = make_mesh(config.mesh, self.device)
            self.model_cfg = dataclasses.replace(
                self.model_cfg, vit=dataclasses.replace(self.model_cfg.vit, mesh=self.mesh),
                gpt2=dataclasses.replace(self.model_cfg.gpt2, mesh=self.mesh))
        # a captured graph runs a fixed number of steps: early stop runs
        # eagerly; under a mesh the request program runs uncaptured
        self._program_on = cc.aot_request_program and not cc.early_stop_decode
        self._capture = self._program_on and self.mesh is None
        if cc.aot_request_program and cc.early_stop_decode:
            log.info("early_stop_decode: requests and batches run eagerly, group by group, "
                     "not on a captured graph")
        params = params if params is not None else load_params(
            config, self.model_cfg, seed, self.device)
        if self.model_cfg.vit.dtype == torch.bfloat16:
            # inference weights are stored bf16: every decode step reads all
            # GPT-2 weights, so f32 storage doubles the bytes of the loop
            params = _cast_floating(params, torch.bfloat16)
        if self.mesh is not None:
            # the inference placement: with wte replicated every model rank
            # computes a decode step's full logits and selects on its own,
            # so no counterpart of the JAX engine's spmd_decode gather is
            # needed
            params, _ = shard_params(params, self.mesh, replicate_embeddings=True)
        if cc.quantize_decoder_int8:
            # after the bf16 cast, as the JAX engine: the scales stay f32
            # and the int8 tensors stay int8 in device memory
            params = {**params, "decoder": quantize_gpt2_blocks(params["decoder"])}
        if self.model_cfg.gpt2.use_pallas_decode_layer:
            # the decode-layer kernel's weight dtypes, cast once here:
            # greedy_or_sample's own cast is then a no-op (no copy, no
            # kernel) in every request and every replay. LayerNorm upcasts
            # its weights anyway, so no other path changes.
            params = {**params, "decoder": g2.prepare_decode_params(params["decoder"],
                                                                    self.model_cfg.gpt2)}
        self.params = params
        self.tokenizer = get_tokenizer()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._prompt_ids: Dict[str, np.ndarray] = {}
        self._groups = None
        self._program = None            # the request program
        self._batch_program = None      # the batch program
        self._graphs: Dict[Tuple[int, ...], RequestGraph] = {}
        self._feats_program = None      # the feats request program
        self._feats_graphs: Dict[Tuple[int, ...], RequestGraph] = {}
        # the overlapped path's chunk trunk, one graph a (wire, frames in, frames out)
        self._trunk_graphs: Dict[Tuple[str, int, int], RequestGraph] = {}
        size = config.image_size
        # raw 4:2:0 planes -> uint8 RGB on the device (bit-exact with PIL)
        self._yuv_fn = lambda planes: yuv420_packed_to_rgb_chw(planes, size)
        # device-resident LRU of uploaded videos: a repeat request for an
        # unchanged frames dir skips JPEG decode and the upload
        self._video_cache: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
        self._video_cache_lock = threading.Lock()
        self._video_cache_total = 0
        self._video_cache_bytes = int(
            os.environ.get("VIDEO_CAPTION_VIDEO_CACHE_MB", "256")) * 1024 * 1024

    def _check_mesh_options(self, cc) -> None:
        """Under a model axis above 1 (checked before the mesh is made),
        int8 block weights and the decode-layer kernel raise: the JAX rules
        replicate the int8 weights beside sharded biases, and the kernel
        runs all layers in one launch, with no room for a row-parallel
        product's all-reduce; the heads must split over the axis."""
        mc, model = self.model_cfg, self.config.mesh.model
        if model > 1:
            if cc.quantize_decoder_int8:
                raise NotImplementedError("quantize_decoder_int8 under a mesh with model > 1")
            if mc.gpt2.use_pallas_decode_layer:
                raise NotImplementedError("use_pallas_decode_layer under a mesh with model > 1")
            shape = Mesh(data=self.config.mesh.data, model=model)
            check_heads(mc.vit.num_heads, shape, "ViT")
            check_heads(mc.gpt2.n_head, shape, "GPT-2")

    @classmethod
    def from_config(cls, config: InferenceConfig) -> "InferenceEngine":
        """The engine ``InferenceEngine(config)`` builds: on the card, from
        the configured checkpoint (or seeded random parameters where it is
        absent), bf16 under the bf16 policy."""
        return cls(config)

    def compute_prefix(self, video: torch.Tensor) -> torch.Tensor:
        """video [B,T,3,H,W] on the engine's device -> prefix [B,P,H] f32."""
        with torch.inference_mode():
            return cm.video_to_prefix(self.params, video, self.model_cfg)

    def _tokenize_prompt(self, prompt: str) -> np.ndarray:
        if prompt not in self._prompt_ids:
            ids = self.tokenizer.encode(prompt) if prompt else [self.tokenizer.bos_token_id]
            self._prompt_ids[prompt] = np.asarray(ids, np.int64)
        return self._prompt_ids[prompt]

    def _decode_params(self, **kw) -> DecodeParams:
        return DecodeParams(
            max_new_tokens=kw.get("max_new_tokens", 24),
            num_beams=kw.get("num_beams", 3),
            temperature=kw.get("temperature", 1.0),
            top_p=kw.get("top_p", 1.0),
            top_k=kw.get("top_k", 50),
            no_repeat_ngram_size=kw.get("no_repeat_ngram_size", 3),
            repetition_penalty=kw.get("repetition_penalty", 1.1),
            min_new_tokens=kw.get("min_new_tokens", 8),
            eos_id=self.tokenizer.eos_token_id,
            early_stop=self.config.compile.early_stop_decode,
        )

    def generate_once(self, prefix: torch.Tensor, prompt: str, **decode_kwargs) -> str:
        """One candidate caption of one video from its prefix [1,P,H] under
        the policy ``decode_kwargs`` give (defaults as ``_decode_params``)."""
        ids = torch.from_numpy(self._tokenize_prompt(prompt or "")).to(self.device)[None]
        dp = self._decode_params(**decode_kwargs)
        with torch.inference_mode():
            embeds = cm.build_decoder_inputs(self.params, prefix, ids, self.model_cfg)
            out = generate(self.params["decoder"], self.model_cfg.gpt2, embeds, dp,
                           self.generator)
        text = self.tokenizer.decode(out[0].cpu().numpy(), skip_special_tokens=True)
        return clean_text(text.strip())

    def _prompt_batch(self, prompts) -> Tuple[np.ndarray, np.ndarray]:
        """LEFT-padded prompt ids and masks [R, L] of R prompts."""
        ids_list = [self._tokenize_prompt(p or "") for p in prompts]
        max_len = max(len(ids) for ids in ids_list)
        ids_arr = np.full((len(prompts), max_len), self.tokenizer.pad_token_id, np.int64)
        mask_arr = np.zeros((len(prompts), max_len), np.int32)
        for row, ids in enumerate(ids_list):
            ids_arr[row, max_len - len(ids):] = ids
            mask_arr[row, max_len - len(ids):] = 1
        return ids_arr, mask_arr

    def _generate_group(self, prefix_rows: torch.Tensor, prompts, dp: DecodeParams) -> np.ndarray:
        """Decode R (prefix, prompt) rows under one policy as one LEFT-padded
        batch; prefix_rows is [R, P, H]."""
        ids_arr, mask_arr = self._prompt_batch(prompts)
        with torch.inference_mode():
            out = generate_prefixed(
                self.params["decoder"], self.model_cfg.gpt2, prefix_rows,
                torch.from_numpy(ids_arr).to(self.device),
                torch.from_numpy(mask_arr).to(self.device), dp, self.generator)
        return out.cpu().numpy()

    def _policy_groups(self, preset_prompt_pairs) -> Dict[DecodeParams, List[int]]:
        """{decode policy: indices of the pairs with it}, in first-use order."""
        groups: Dict[DecodeParams, List[int]] = {}
        for i, (preset, _) in enumerate(preset_prompt_pairs):
            groups.setdefault(self._decode_params(**preset_to_kwargs(preset)), []).append(i)
        return groups

    def _texts_of(self, out_ids: np.ndarray, idxs, texts) -> None:
        """Decode and clean a group's rows (video-major) into texts[v][i]."""
        for row in range(out_ids.shape[0]):
            vid, slot = divmod(row, len(idxs))
            text = self.tokenizer.decode(out_ids[row], skip_special_tokens=True)
            texts[vid][idxs[slot]] = clean_text(text.strip())

    def generate_presets(self, prefix: torch.Tensor, preset_prompt_pairs):
        """Decode presets for V videos (prefix [V, P, H]); returns texts[v][i],
        or a flat list when V == 1. Rows with the same decode policy decode as
        one program, video-major: [(v0,i0), (v0,i1), (v1,i0), ...]."""
        v = prefix.shape[0]
        texts = [[""] * len(preset_prompt_pairs) for _ in range(v)]
        for dp, idxs in self._policy_groups(preset_prompt_pairs).items():
            prompts = [preset_prompt_pairs[i][1] or "" for _ in range(v) for i in idxs]
            out_ids = self._generate_group(prefix.repeat_interleave(len(idxs), dim=0),
                                           prompts, dp)
            self._texts_of(out_ids, idxs, texts)
        return texts[0] if v == 1 else texts

    def _pairs(self):
        c = self.config
        return [(c.preset1, c.prompt1), (c.preset2, c.prompt2), (c.preset3, c.prompt3)]

    def _decode_groups(self) -> list:
        """Each decode group of the configured presets as (policy, preset
        indices, prompt ids, prompt mask), the LEFT-padded prompts uploaded
        once as constant device tensors; built once."""
        if self._groups is None:
            pairs = self._pairs()
            self._groups = []
            for dp, idxs in self._policy_groups(pairs).items():
                ids_arr, mask_arr = self._prompt_batch([pairs[i][1] or "" for i in idxs])
                self._groups.append((dp, tuple(idxs), torch.from_numpy(ids_arr).to(self.device),
                                     torch.from_numpy(mask_arr).to(self.device)))
        return self._groups

    def _unified_eligible(self, group_list, fused_program: bool = False) -> bool:
        """Whether one unified loop decodes every group (the JAX engine's
        rule): two or more groups, not the decode-layer configuration (its
        flat cache), no early stop. The request program follows
        ``unified_decode`` or ``unified_fused_request`` (on by default),
        the batch program ``unified_decode`` alone (off by default)."""
        cc = self.config.compile
        want = cc.unified_decode or (fused_program and cc.unified_fused_request)
        return (want and len(group_list) > 1
                and not self.model_cfg.gpt2.use_pallas_decode_layer
                and not any(dp.early_stop for dp, *_ in group_list))

    def run_decode_group(self, prefix: torch.Tensor, dp: DecodeParams, ids: torch.Tensor,
                         mask: torch.Tensor,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One policy group (prompt ids and mask [n_g, L] on the device) for
        every video of prefix [V,P,H]: ids [V*n_g, N], video-major. A
        sampled group draws from ``generator``, the engine's by default (a
        measurement passes a throwaway one)."""
        with torch.inference_mode():
            return _decode_group(self.params["decoder"], self.model_cfg.gpt2, prefix, dp, ids,
                                 mask, generator=generator or self.generator)

    def request_noise(self, videos: int, generator: Optional[torch.Generator] = None
                      ) -> Tuple[Optional[torch.Tensor], ...]:
        """The Gumbel noise of one run of the request program over ``videos``
        videos: for each decode group in order its ``sample_noise`` (None
        for a group that samples nothing), drawn in that order from
        ``generator``, the engine's by default, as the decodes would draw it
        themselves."""
        vp = g2.padded_vocab(self.model_cfg.gpt2)
        generator = generator or self.generator
        return tuple(sample_noise(dp, videos * len(idxs), vp, generator, self.device)
                     for dp, idxs, _, _ in self._decode_groups())

    def _make_program(self, fused: bool, from_feats: bool = False):
        """(program, group_list): ``program(video)`` takes the uploaded uint8
        videos [V,T,3,S,S] (with ``from_feats``, per-frame features
        [V,T,E] of ``cm.encode_frames``) to the token ids of every decode
        group, ``(ids of group 0 [V*R0, N0], ...)``, through one unified
        loop where ``_unified_eligible(group_list, fused)`` says so, else
        group by group. It makes no host synchronisation and no
        host-to-device copy, so a CUDA graph can capture it (counterpart of
        the JAX engine's ``_fused_infer_program`` and
        ``_fused_feats_program``).

        ``program.core(params, video, noises)`` is the same program with no
        generator inside: the weights and the noise of ``request_noise``
        are its inputs. ``program(video)`` draws the noise, then runs
        ``core`` on the engine's weights, so its ids are those of ``core``
        on the same draws."""
        group_list = self._decode_groups()
        use_unified = self._unified_eligible(group_list, fused_program=fused)
        params, model_cfg = self.params, self.model_cfg
        to_prefix = cm.frames_to_prefix if from_feats else cm.video_to_prefix

        def core(params: dict, video: torch.Tensor,
                 noises: Sequence[Optional[torch.Tensor]]) -> Tuple[torch.Tensor, ...]:
            prefix = to_prefix(params, video, model_cfg)                    # [V,P,H]
            if use_unified:
                return unified.generate_unified(
                    params["decoder"], model_cfg.gpt2, prefix,
                    [(ids, mask) for _, _, ids, mask in group_list],
                    [dp for dp, *_ in group_list], noises=noises)
            return tuple(_decode_group(params["decoder"], model_cfg.gpt2, prefix, dp, ids, mask,
                                       noise=noise)
                         for (dp, _, ids, mask), noise in zip(group_list, noises))

        def program(video: torch.Tensor) -> Tuple[torch.Tensor, ...]:
            with torch.inference_mode():
                return core(params, video, self.request_noise(video.shape[0]))

        program.core = core
        return program, group_list

    def _fused_infer_program(self):
        """The request program (one video, or every batch under
        ``fuse_request_program``), built once."""
        if self._program is None:
            self._program = self._make_program(fused=True)
        return self._program

    def _fused_feats_program(self):
        """The request program from per-frame features [1,T,E] (the second
        half of the overlapped cold path: the trunk ran chunk by chunk in
        ``_load_feats_overlapped``); its decode is the pixel request
        program's, unified or grouped alike. Built once."""
        if self._feats_program is None:
            self._feats_program = self._make_program(fused=True, from_feats=True)
        return self._feats_program

    def _batch_infer_program(self):
        """The batch program (the JAX engine's unfused dispatch: the groups
        in turn, or unified under ``unified_decode``), built once."""
        if self._batch_program is None:
            self._batch_program = self._make_program(fused=False)
        return self._batch_program

    def _program_for(self, videos: int):
        cc = self.config.compile
        if cc.fuse_request_program or (videos == 1 and cc.fuse_single_request):
            return self._fused_infer_program()
        return self._batch_infer_program()

    def _serves_on_program(self, video: torch.Tensor) -> bool:
        cc = self.config.compile
        return video.shape[0] == 1 and self._program_on and (
            cc.fuse_single_request or cc.fuse_request_program)

    @staticmethod
    def _graph_of(graphs: dict, key, fn, example: torch.Tensor,
                  generators: Sequence[torch.Generator] = ()) -> RequestGraph:
        """``graphs[key]``, ``fn`` captured on ``example`` on first use.
        Every graph has its own memory pool: a replay writes no other
        graph's outputs."""
        if key not in graphs:
            with tracing.span("engine.capture"):
                tracing.count("graph.captures")
                graphs[key] = RequestGraph.capture(fn, example, generators)
            log.info("graph for %s: warm-up run %.2f s, capture %.2f s", key,
                     graphs[key].warmup_s, graphs[key].capture_s)
        return graphs[key]

    def request_graph(self, video: torch.Tensor) -> RequestGraph:
        """The program that serves ``video``'s shape (``_program_for``),
        captured on first use of that shape with the engine's generator
        registered."""
        program, _ = self._program_for(video.shape[0])
        return self._graph_of(self._graphs, tuple(video.shape),
                              lambda x: _pack(program(x)), video, (self.generator,))

    def feats_graph(self, feats: torch.Tensor) -> RequestGraph:
        """The feats request program for ``feats``' shape [1,T,E], captured
        on first use with the engine's generator registered, as the pixel
        program's graph (the counterpart of ``_aot_single_feats_exec``): a
        cold request and a warm one draw what the eager calls would."""
        program, _ = self._fused_feats_program()
        return self._graph_of(self._feats_graphs, tuple(feats.shape),
                              lambda x: _pack(program(x)), feats, (self.generator,))

    def _dispatch(self, program, group_list, x: torch.Tensor, graph,
                  span: str = "engine.replay") -> Dispatched:
        """Run ``program`` on ``x`` (on CUDA with ``aot_request_program``, a
        replay of ``graph(x)``; else op by op) and return without waiting for
        the device: on CUDA the packed ids' copy to a pinned host buffer is
        enqueued on the same stream right after the program, and an event
        recorded behind it (the counterpart of the JAX engine's
        ``copy_to_host_async``). The next dispatch may replay the same
        graph: stream order puts its writes after this copy. ``span`` names
        the program's span."""
        if self.device.type != "cuda":
            with tracing.span(span):
                flat = _pack(program(x))
            return Dispatched(flat, None, group_list, x.shape[0])
        with tracing.span(span):
            flat = graph(x).replay(x) if self._capture else _pack(program(x))
        with tracing.span("engine.readback"):
            host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            host.copy_(flat, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        return Dispatched(host, done, group_list, x.shape[0])

    def _dispatch_videos(self, video: torch.Tensor) -> Dispatched:
        """The program that serves ``video`` [V,T,3,S,S], dispatched."""
        if self.mesh is not None:
            return self._dispatch_mesh(video, video.shape[0], split=False)
        program, group_list = self._program_for(video.shape[0])
        return self._dispatch(program, group_list, video, self.request_graph)

    def _dispatch_mesh(self, video: torch.Tensor, videos: int, split: bool) -> Dispatched:
        """The program that serves ``videos`` videos, on this rank of the
        mesh, uncaptured. With ``split``, ``video`` holds this data rank's
        rows: the sampled groups' noise is drawn for the whole batch (the
        same draws on every rank, so the results equal the single-device
        engine's) and each rank decodes on its rows of it, then every
        group's ids are gathered over ``data``. Without, every rank runs
        the whole ``video``."""
        program, group_list = self._program_for(videos)
        noises = self.request_noise(videos)
        if split:
            noises = tuple(None if n is None else rows_of(n, self.mesh, dim=1) for n in noises)
        with tracing.span("engine.replay"), torch.inference_mode():
            ids = program.core(self.params, video, noises)
            if split:
                ids = tuple(coll.all_gather(x, self.mesh, coll.DATA_AXIS) for x in ids)
        with tracing.span("engine.readback"):
            host = _pack(ids).cpu()
        return Dispatched(host, None, group_list, videos)

    def _dispatch_feats(self, feats: torch.Tensor) -> Dispatched:
        """The feats request program on ``feats`` [1,T,E], dispatched (the
        overlapped cold path's second half)."""
        program, group_list = self._fused_feats_program()
        return self._dispatch(program, group_list, feats, self.feats_graph, span="engine.feats")

    def _collect_ids(self, handle: Dispatched) -> List[np.ndarray]:
        """Wait for a dispatch; ids [V*R_g, N_g] of every decode group."""
        if handle.done is not None:
            with tracing.span("engine.collect_wait"):
                handle.done.synchronize()
        flat = handle.ids.numpy()
        out, start = [], 0
        for dp, idxs, _, _ in handle.group_list:
            size = len(idxs) * handle.videos * dp.max_new_tokens
            out.append(flat[start:start + size].reshape(-1, dp.max_new_tokens))
            start += size
        return out

    def _collect_videos(self, handle: Dispatched) -> List[List[str]]:
        """texts[v][preset index] of a dispatch."""
        collected = self._collect_ids(handle)
        with tracing.span("engine.detokenize"):
            texts = [[""] * len(self._pairs()) for _ in range(handle.videos)]
            for (_, idxs, _, _), ids in zip(handle.group_list, collected):
                self._texts_of(ids, idxs, texts)
        return texts

    def request_ids(self, video: torch.Tensor) -> List[np.ndarray]:
        """The program that serves ``video`` on it: ids [V*R_g, N_g] of every
        decode group, on the host. On CUDA with ``aot_request_program`` one
        replay of its graph and one device-to-host copy; otherwise (on the
        CPU, or with it off) the program runs uncaptured."""
        return self._collect_ids(self._dispatch_videos(video))

    # ---- frames -> device, through the video cache ----------------------

    def _video_cache_key(self, frames_dir: str):
        """The cache key of a frame dir: the dir, a digest of every
        frame_*.jpg's (name, mtime, size) and the sampling parameters, so
        replacing any frame changes it. One scandir pass (the entries' stats
        come from the open directory). A missing path and a path that is not
        a directory raise FileNotFoundError, as an empty directory does."""
        entries = []
        try:
            with os.scandir(frames_dir) as it:
                for e in it:
                    if e.name.startswith("frame_") and e.name.endswith(".jpg"):
                        st = e.stat()
                        entries.append((e.name, st.st_mtime_ns, st.st_size))
        except (FileNotFoundError, NotADirectoryError):
            raise FileNotFoundError(f"No frame_*.jpg files found under {frames_dir}") from None
        if not entries:
            raise FileNotFoundError(f"No frame_*.jpg files found under {frames_dir}")
        entries.sort()
        digest = hashlib.sha256(repr(entries).encode()).hexdigest()
        return str(frames_dir), digest, self.config.num_frames, self.config.image_size

    def _video_cache_get(self, frames_dir: str):
        """(key, cached video or None); (None, None) with the cache off."""
        if self._video_cache_bytes <= 0:
            return None, None
        key = self._video_cache_key(frames_dir)
        with self._video_cache_lock:
            hit = self._video_cache.get(key)
            if hit is not None:
                self._video_cache.move_to_end(key)
        return key, hit

    def _video_cache_put(self, key, video: torch.Tensor) -> None:
        """Keep ``video`` under ``key``, evicting the least recently used
        videos past the byte budget (the newest always stays)."""
        if self._video_cache_bytes <= 0 or key is None:
            return
        evictions = 0
        with self._video_cache_lock:
            old = self._video_cache.pop(key, None)
            if old is not None:
                self._video_cache_total -= old.nbytes
            self._video_cache[key] = video
            self._video_cache_total += video.nbytes
            while self._video_cache_total > self._video_cache_bytes and len(self._video_cache) > 1:
                _, evicted = self._video_cache.popitem(last=False)
                self._video_cache_total -= evicted.nbytes
                evictions += 1
        if evictions:
            tracing.count("cache.evictions", evictions)

    def _lookup(self, frames_dirs: Sequence[str]) -> List[tuple]:
        """``_video_cache_get`` of each dir (threaded from 8 dirs on: the
        lookups are stat-bound), counted as cache hits and misses."""
        from concurrent.futures import ThreadPoolExecutor

        with tracing.span("engine.lookup", videos=len(frames_dirs)):
            if len(frames_dirs) >= 8 and self._video_cache_bytes > 0:
                with ThreadPoolExecutor(max_workers=8) as pool:
                    lookups = list(pool.map(self._video_cache_get, frames_dirs))
            else:
                lookups = [self._video_cache_get(d) for d in frames_dirs]
            if tracing.enabled():
                hits = sum(hit is not None for _, hit in lookups)
                tracing.count("cache.hits", hits)
                tracing.count("cache.misses",
                              sum(key is not None for key, _ in lookups) - hits)
        return lookups

    def load_video(self, frames_dir: str) -> torch.Tensor:
        """frames_dir -> uint8 [1,T,3,S,S] on the engine's device (the chunked
        upload, or none on a video-cache hit). Stride sampling and tail
        padding as the JAX engine; frames decode in the C++ loader, or PIL
        where the native library is unavailable."""
        return self._load_video_to_device(frames_dir)

    def _frame_picks(self, frames_dir: str) -> List[Path]:
        """The ``num_frames`` frames a request reads: stride sampling, the
        last one repeated where the dir has fewer."""
        files = frame_loader.list_frames(frames_dir)
        if not files:
            raise FileNotFoundError(f"No frame_*.jpg files found under {frames_dir}")
        picks = frame_loader.sample_frame_paths(files, self.config.num_frames)
        return picks + [picks[-1]] * (self.config.num_frames - len(picks))

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device. On CUDA the copy goes from
        pinned memory and is only enqueued on the current stream: the host
        goes on (with the next chunk's decode) while it flies."""
        host = torch.from_numpy(arr)
        if self.device.type != "cuda":
            return host
        with tracing.span("engine.upload", bytes=arr.nbytes):
            tracing.count("h2d.bytes", arr.nbytes)
            return host.pin_memory().to(self.device, non_blocking=True)

    def _load_chunk(self, part: Sequence[Path], chunk: int) -> Tuple[str, np.ndarray]:
        """One chunk of frames on the host: ``("yuv420", planes)`` [chunk,
        plane_len] under ``yuv420_wire`` where the native loader takes every
        frame (a short tail padded with its last frame, so the conversion
        has the chunk's shape), else ``("rgb", pixels)`` [len(part),3,S,S]
        uint8 from the native loader or PIL."""
        size = self.config.image_size
        with tracing.span("engine.frame_decode", frames=len(part)):
            if self.config.compile.yuv420_wire:
                packed = native_loader.load_frames_native_yuv420(part, size)
                if packed is not None:
                    tracing.count("frames.yuv420", len(part))
                    if len(part) < chunk:
                        packed = np.concatenate(
                            [packed, np.repeat(packed[-1:], chunk - len(part), axis=0)])
                    return "yuv420", packed
            pixels = native_loader.load_frames_native_u8(part, size)
            if pixels is None:
                tracing.count("frames.pil", len(part))
                pixels = np.stack([frame_loader.load_image_u8(p, size) for p in part])
            else:
                tracing.count("frames.native_rgb", len(part))
            return "rgb", pixels

    def _load_video_to_device(self, frames_dir: str, chunk: int = 4) -> torch.Tensor:
        """The pipelined upload (JAX engine's ``_load_video_to_device``): a
        chunk of frames decodes while the previous one is on the wire, 4:2:0
        chunks finish their decode on the device, and the chunks join there.
        A video-cache hit is returned as it is; a miss fills the cache."""
        key, cached = self._lookup([frames_dir])[0]
        if cached is not None:
            return cached
        with tracing.span("engine.load", videos=1):
            picks = self._frame_picks(frames_dir)
            parts = []
            for start in range(0, len(picks), chunk):
                part = picks[start:start + chunk]
                kind, arr = self._load_chunk(part, chunk)
                x = self._upload(arr)
                parts.append(self._yuv_fn(x)[:len(part)] if kind == "yuv420" else x)
        with tracing.span("engine.assemble"):
            video = torch.cat(parts)[None]
        self._video_cache_put(key, video)
        return video

    def _chunk_trunk(self, kind: str, n: int, x: torch.Tensor):
        """(uint8 RGB [n,3,S,S], per-frame features [n,E]) of an uploaded
        chunk ``x`` of ``kind`` (``_load_chunk``). On CUDA with
        ``aot_request_program`` one replay of the graph of (kind, rows of
        x, n), captured on first use; its outputs hold until its next
        replay."""
        def trunk(chunk: torch.Tensor):
            with torch.inference_mode():
                rgb = self._yuv_fn(chunk)[:n] if kind == "yuv420" else chunk
                return rgb, cm.encode_frames(self.params, rgb, self.model_cfg)

        with tracing.span("engine.trunk", frames=n):
            if self.device.type != "cuda" or not self._capture:
                return trunk(x)
            return self._graph_of(self._trunk_graphs, (kind, x.shape[0], n), trunk, x).replay(x)

    def _load_feats_overlapped(self, frames_dir: str,
                               chunk: int = _OVERLAP_CHUNK) -> Optional[torch.Tensor]:
        """The overlapped cold path's first half: per chunk of ``chunk``
        frames, the host decodes it, enqueues its upload and its trunk
        (``_chunk_trunk``) and goes on to the next chunk while the device
        works. Returns the per-frame features [1,T,E], or None where the
        path does not apply: a video-cache hit (the pixels are on the
        device) or a pooling other than ``cls``. The assembled pixels fill
        the video cache."""
        if self.model_cfg.vit.pool != "cls":
            return None
        key, cached = self._lookup([frames_dir])[0]
        if cached is not None:
            return None
        with tracing.span("engine.load", videos=1):
            picks = self._frame_picks(frames_dir)
            t, size = len(picks), self.config.image_size
            feats = torch.empty((1, t, self.model_cfg.vit.embed_dim),
                                dtype=self.model_cfg.vit.dtype, device=self.device)
            video = None if key is None else torch.empty(
                (1, t, 3, size, size), dtype=torch.uint8, device=self.device)
            for start in range(0, t, chunk):
                part = picks[start:start + chunk]
                kind, arr = self._load_chunk(part, chunk)
                rgb, f = self._chunk_trunk(kind, len(part), self._upload(arr))
                # copied out before the next replay of the same graph
                # overwrites them: stream order keeps the copies right
                feats[0, start:start + len(part)].copy_(f)
                if video is not None:
                    video[0, start:start + len(part)].copy_(rgb)
        self._video_cache_put(key, video)
        return feats

    def _load_videos(self, frames_dirs: Sequence[str]) -> torch.Tensor:
        """Frame dirs -> uint8 [V,T,3,S,S] on the device. One dir takes the
        chunked upload. Several: cache hits as they are, misses decoded in
        up to 8 worker threads (identical dirs once; 4:2:0 planes under
        ``yuv420_wire`` where the loader takes the whole video) and uploaded
        as each finishes. The cache lookups (stat-bound) are threaded too
        from 8 dirs on (``_lookup``)."""
        from concurrent.futures import ThreadPoolExecutor

        if len(frames_dirs) == 1:
            return self._load_video_to_device(frames_dirs[0])
        lookups = self._lookup(frames_dirs)
        slots = [hit for _, hit in lookups]
        misses: Dict[tuple, List[int]] = {}
        for i, (key, hit) in enumerate(lookups):
            if hit is None:
                misses.setdefault(key or ("uncached", i), []).append(i)
        if misses:
            c = self.config
            groups = list(misses.values())

            def decode(frames_dir: str, load) -> Tuple[str, np.ndarray]:
                # on a pool thread: the load's span is its parent
                with tracing.span("engine.frame_decode", parent=load, frames=c.num_frames):
                    return frame_loader.load_video_packed(
                        frames_dir, c.num_frames, c.image_size,
                        allow_yuv420=c.compile.yuv420_wire)

            with tracing.span("engine.load", videos=len(groups)) as load, ThreadPoolExecutor(
                    max_workers=min(len(groups), os.cpu_count() or 1, 8)) as pool:
                loaded = pool.map(lambda d: decode(d, load), [frames_dirs[g[0]] for g in groups])
                for idxs, (kind, arr) in zip(groups, loaded):
                    video = self._upload(arr)
                    if kind == "yuv420":
                        video = self._yuv_fn(video)[None]
                    self._video_cache_put(lookups[idxs[0]][0], video)
                    for i in idxs:
                        slots[i] = video
        with tracing.span("engine.assemble"):
            return torch.cat(slots)

    # ---- public API ------------------------------------------------------

    def infer_video(self, video: torch.Tensor) -> InferenceResult:
        """One uploaded uint8 video [1,T,3,S,S] -> InferenceResult, through
        the request program (a graph replay on CUDA) or, with
        ``aot_request_program`` off, eagerly."""
        if self._serves_on_program(video):
            texts = self._collect_videos(self._dispatch_videos(video))[0]
        else:
            with tracing.span("engine.replay"):
                texts = self.generate_presets(self.compute_prefix(video), self._pairs())
        return _result(texts)

    def infer(self, frames_dir: str) -> InferenceResult:
        """frames_dir -> InferenceResult, as the JAX engine serves it: a
        video-cache miss takes the overlapped cold path under
        ``overlap_single_upload`` (the chunk trunks, then the feats request
        program); a hit, or the path off, the chunked upload and
        ``infer_video``."""
        with self.memory.oom_guard():
            if self.config.compile.overlap_single_upload and self.mesh is None:
                feats = self._load_feats_overlapped(frames_dir)
                if feats is not None:
                    return _result(self._collect_videos(self._dispatch_feats(feats))[0])
            return self.infer_video(self._load_video_to_device(frames_dir))

    def infer_batch_dispatch(self, frames_dirs: Sequence[str]) -> Dispatched:
        """Load, upload and enqueue a batch; returns without waiting for the
        device. Pair with ``infer_batch_collect``: a caller can dispatch
        batch N+1 (its JPEG decode and upload included) before collecting
        batch N. Under a mesh each data rank loads its own videos (the
        batch must divide over ``data``) and the handle holds the whole
        batch's ids."""
        with tracing.span("engine.dispatch", videos=len(frames_dirs)), self.memory.oom_guard():
            if self.mesh is not None:
                mine = rows_of(np.asarray(list(frames_dirs), dtype=object), self.mesh)
                return self._dispatch_mesh(self._load_videos(list(mine)), len(frames_dirs),
                                           split=True)
            return self._dispatch_videos(self._load_videos(frames_dirs))

    def infer_batch_collect(self, handle: Dispatched) -> List[InferenceResult]:
        """Wait for a dispatched batch; one InferenceResult per video. Device
        errors (an OOM among them) surface here, hence the guard on this side
        too. The best pick of each video runs in its span, ``engine.collect``."""
        with tracing.span("engine.collect", videos=handle.videos):
            with self.memory.oom_guard():
                collected = self._collect_videos(handle)
            return [_result(texts) for texts in collected]

    def infer_batch(self, frames_dirs: Sequence[str]) -> List[InferenceResult]:
        """Several videos in one program: one encoder pass over all of them
        and decodes whose rows span videos x presets."""
        return self.infer_batch_collect(self.infer_batch_dispatch(frames_dirs))

    def warmup(self) -> float:
        """First-use costs (kernel build, allocator growth and, on CUDA, the
        graphs' captures) of a request on a zero video and, under
        ``overlap_single_upload``, of the overlapped cold path: each chunk
        shape's trunk on the RGB wire and, where the native loader builds,
        the 4:2:0 one, and the feats program. Returns its seconds. It draws
        from the generator as much as two requests (the pixel and the feats
        program), as the JAX engine's warm-up."""
        t0 = time.perf_counter()
        c = self.config
        s, t = c.image_size, c.num_frames
        self.infer_video(torch.zeros((1, t, 3, s, s), dtype=torch.uint8, device=self.device))
        if (c.compile.overlap_single_upload and self.mesh is None
                and self.model_cfg.vit.pool == "cls"):
            chunk = _OVERLAP_CHUNK
            kinds = ["rgb"]
            if c.compile.yuv420_wire and native_loader.native_available():
                kinds.append("yuv420")
            for n in sorted({min(chunk, t), t % chunk} - {0}):
                for kind in kinds:
                    shape = (chunk, packed_plane_len(s)) if kind == "yuv420" else (n, 3, s, s)
                    self._chunk_trunk(kind, n, torch.zeros(shape, dtype=torch.uint8,
                                                           device=self.device))
            feats = torch.zeros((1, t, self.model_cfg.vit.embed_dim),
                                dtype=self.model_cfg.vit.dtype, device=self.device)
            self._collect_videos(self._dispatch_feats(feats))
        return time.perf_counter() - t0


def _result(texts: Sequence[str]) -> InferenceResult:
    candidates = CaptionCandidates(s1=texts[0], s2=texts[1], s3=texts[2])
    best_key, best_text, _ = select_best(list(candidates.items()))
    return InferenceResult(candidates=candidates, best_key=best_key, best_text=best_text)


def _decode_group(decoder: dict, cfg: g2.GPT2Config, prefix: torch.Tensor, dp: DecodeParams,
                  ids: torch.Tensor, mask: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One policy group (prompt ids and mask [n_g, L]) for every video of
    prefix [V,P,H]: ids [V*n_g, N], video-major; a sampled group on
    ``noise`` where it is given, else drawing from ``generator``."""
    v = prefix.shape[0]
    return generate_prefixed(decoder, cfg, prefix.repeat_interleave(ids.shape[0], dim=0),
                             ids.repeat(v, 1), mask.repeat(v, 1), dp, generator, noise)


def _pack(ids: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """Every group's ids as one flat tensor: one copy to the host."""
    return torch.cat([x.reshape(-1) for x in ids])
