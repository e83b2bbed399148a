"""Inference engine: frames_dir -> three candidate captions -> best-of-3
(counterpart of video_caption_tpu/engine.py).

One request runs: frame load (the C++ libjpeg loader, or PIL where the
native library is unavailable) -> one upload of uint8 pixels -> ViT-B/16 ->
prefix norm -> mapper -> one grouped decode per distinct policy (presets
with the same policy decode as one left-padded batch) -> text cleaning ->
best-of-3. Every kernel of that path is a hand-written CUDA kernel on the
GPU (ops/), and its plain PyTorch version on the CPU. The compile switches
``use_pallas_decode_attention`` and ``use_pallas_decode_layer`` (off by
default, as in the JAX package) put the greedy/sampled decode steps through
the decode-attention or the whole-step decode-layer kernel;
``deferred_decode_cache_write`` (off by default) writes each decode step's
K/V once after the layer loop, with the beam-attention kernel in its
deferred mode.

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

Not ported yet: the overlapped chunk upload and its feats program, the
serialized request artifact and the 4:2:0 wire.
"""
from __future__ import annotations

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

from video_caption_tpu_torch.aot import RequestGraph
from video_caption_tpu_torch.config import InferenceConfig
from video_caption_tpu_torch.datatypes import CaptionCandidates, InferenceResult
from video_caption_tpu_torch.decode import unified
from video_caption_tpu_torch.decode.generate import DecodeParams, generate, generate_prefixed
from video_caption_tpu_torch.decode.presets import preset_to_kwargs
from video_caption_tpu_torch.decode.tokenizer import get_tokenizer
from video_caption_tpu_torch.postprocessing.candidate_ranker import select_best
from video_caption_tpu_torch.postprocessing.text_cleaner import clean_text
from video_caption_tpu_torch.models import caption_model as cm
from video_caption_tpu_torch.models import gpt2 as g2
from video_caption_tpu_torch.models import vit as vt
from video_caption_tpu_torch.models.convert import load_reference_state, merge_params

log = logging.getLogger(__name__)

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
                           deferred_cache_write=config.compile.deferred_decode_cache_write),
        prefix_len=config.prefix_len,
        ln_scale=config.ln_scale,
        in_weight=config.in_weight,
    )


def load_params(config: InferenceConfig, model_cfg: cm.CaptionModelConfig, seed: int,
                device) -> dict:
    """A reference-format ``.pt``/``.pth``/``.bin`` checkpoint over a random
    init (what it lacks keeps its init), or random parameters when
    ``config.ckpt`` does not exist. Any other existing path raises: the
    engine never serves random weights in place of a checkpoint it cannot
    read."""
    init = cm.init_caption_model(seed, model_cfg, device)
    ckpt = Path(config.ckpt)
    if ckpt.is_file() and ckpt.suffix in {".pt", ".pth", ".bin"}:
        state = torch.load(str(ckpt), map_location="cpu", weights_only=True)
        loaded = load_reference_state(state, model_cfg)
        log.info("loaded reference checkpoint %s (%d families)", ckpt, len(loaded))
        return merge_params(init, loaded)
    if ckpt.exists():
        raise RuntimeError(f"checkpoint {ckpt} is not a reference-format .pt file; the "
                           "port cannot read it and will not serve random parameters")
    log.warning("checkpoint %s not found; using randomly initialized parameters", ckpt)
    return init


def _cast_floating(tree, dtype: torch.dtype):
    return {k: _cast_floating(v, dtype) if isinstance(v, dict)
            else (v.to(dtype) if v.is_floating_point() else v) for k, v in tree.items()}




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
    """frames_dir -> InferenceResult on one device."""

    def __init__(self, config: InferenceConfig, params: Optional[dict] = None, seed: int = 0,
                 model_cfg: Optional[cm.CaptionModelConfig] = None, device="cuda"):
        if config.compile.quantize_decoder_int8:
            raise NotImplementedError("int8 decoder weights are not ported yet")
        if config.mesh.num_devices > 1:
            raise NotImplementedError("multi-device inference is not ported yet")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but no CUDA device is available")
        self.config = config
        self.model_cfg = model_cfg or model_config_from_inference(config)
        params = params if params is not None else load_params(
            config, self.model_cfg, seed, self.device)
        if self.model_cfg.vit.dtype == torch.bfloat16:
            # inference weights are stored bf16: every decode step reads all
            # GPT-2 weights, so f32 storage doubles the bytes of the loop
            params = _cast_floating(params, torch.bfloat16)
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
        # device-resident LRU of uploaded videos: a repeat request for an
        # unchanged frames dir skips JPEG decode and the upload
        self._video_cache: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
        self._video_cache_lock = threading.Lock()
        self._video_cache_total = 0
        self._video_cache_bytes = int(
            os.environ.get("VIDEO_CAPTION_VIDEO_CACHE_MB", "256")) * 1024 * 1024

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
        v = prefix.shape[0]
        with torch.inference_mode():
            return generate_prefixed(self.params["decoder"], self.model_cfg.gpt2,
                                     prefix.repeat_interleave(ids.shape[0], dim=0),
                                     ids.repeat(v, 1), mask.repeat(v, 1), dp,
                                     generator or self.generator)

    def _make_program(self, fused: bool):
        """(program, group_list): ``program(video)`` takes the uploaded uint8
        videos [V,T,3,S,S] to the token ids of every decode group, ``(ids of
        group 0 [V*R0, N0], ...)``, through one unified loop where
        ``_unified_eligible(group_list, fused)`` says so, else group by
        group. It makes no host synchronisation and no host-to-device copy,
        so a CUDA graph can capture it (counterpart of the JAX engine's
        ``_fused_infer_program``)."""
        group_list = self._decode_groups()
        use_unified = self._unified_eligible(group_list, fused_program=fused)
        params, model_cfg, generator = self.params, self.model_cfg, self.generator

        def program(video: torch.Tensor) -> Tuple[torch.Tensor, ...]:
            with torch.inference_mode():
                prefix = cm.video_to_prefix(params, video, model_cfg)       # [V,P,H]
                if use_unified:
                    return unified.generate_unified(
                        params["decoder"], model_cfg.gpt2, prefix,
                        [(ids, mask) for _, _, ids, mask in group_list],
                        [dp for dp, *_ in group_list], generator)
                return tuple(self.run_decode_group(prefix, dp, ids, mask)
                             for dp, _, ids, mask in group_list)

        return program, group_list

    def _fused_infer_program(self):
        """The request program (one video, or every batch under
        ``fuse_request_program``), built once."""
        if self._program is None:
            self._program = self._make_program(fused=True)
        return self._program

    def _batch_infer_program(self):
        """The batch program (the JAX engine's unfused dispatch: the groups
        in turn, or unified under ``unified_decode``), built once."""
        if self._batch_program is None:
            self._batch_program = self._make_program(fused=False)
        return self._batch_program

    def _program_for(self, video: torch.Tensor):
        cc = self.config.compile
        if cc.fuse_request_program or (video.shape[0] == 1 and cc.fuse_single_request):
            return self._fused_infer_program()
        return self._batch_infer_program()

    def _serves_on_program(self, video: torch.Tensor) -> bool:
        cc = self.config.compile
        return video.shape[0] == 1 and cc.aot_request_program and (
            cc.fuse_single_request or cc.fuse_request_program)

    def request_graph(self, video: torch.Tensor) -> RequestGraph:
        """The program that serves ``video``'s shape (``_program_for``),
        captured on first use of that shape with the engine's generator
        registered. Every graph has its own memory pool: a replay writes no
        other graph's outputs."""
        key = tuple(video.shape)
        if key not in self._graphs:
            program, _ = self._program_for(video)
            self._graphs[key] = RequestGraph.capture(
                lambda x: _pack(program(x)), video, (self.generator,))
            log.info("request graph for %s: warm-up run %.2f s, capture %.2f s", key,
                     self._graphs[key].warmup_s, self._graphs[key].capture_s)
        return self._graphs[key]

    def _dispatch_videos(self, video: torch.Tensor) -> Dispatched:
        """Run the program that serves ``video`` [V,T,3,S,S] (a replay of its
        graph on CUDA with ``aot_request_program``, else op by op) and return
        without waiting for the device: on CUDA the packed ids' copy to a
        pinned host buffer is enqueued on the same stream right after the
        program, and an event recorded behind it (the counterpart of the
        JAX engine's ``copy_to_host_async``). The next dispatch may replay
        the same graph: stream order puts its writes after this copy."""
        program, group_list = self._program_for(video)
        if self.device.type != "cuda":
            return Dispatched(_pack(program(video)), None, group_list, video.shape[0])
        if self.config.compile.aot_request_program:
            flat = self.request_graph(video).replay(video)
        else:
            flat = _pack(program(video))
        host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
        host.copy_(flat, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return Dispatched(host, done, group_list, video.shape[0])

    def _collect_ids(self, handle: Dispatched) -> List[np.ndarray]:
        """Wait for a dispatch; ids [V*R_g, N_g] of every decode group."""
        if handle.done is not None:
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
        texts = [[""] * len(self._pairs()) for _ in range(handle.videos)]
        for (_, idxs, _, _), ids in zip(handle.group_list, self._collect_ids(handle)):
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
        with self._video_cache_lock:
            old = self._video_cache.pop(key, None)
            if old is not None:
                self._video_cache_total -= old.nbytes
            self._video_cache[key] = video
            self._video_cache_total += video.nbytes
            while self._video_cache_total > self._video_cache_bytes and len(self._video_cache) > 1:
                _, evicted = self._video_cache.popitem(last=False)
                self._video_cache_total -= evicted.nbytes

    def load_video(self, frames_dir: str) -> torch.Tensor:
        """frames_dir -> uint8 [1,T,3,S,S] on the engine's device (one upload,
        or none on a video-cache hit). Stride sampling and tail padding as
        the JAX engine; frames decode in the C++ loader, or PIL where the
        native library is unavailable."""
        return self._load_videos([frames_dir])

    def _load_videos(self, frames_dirs: Sequence[str]) -> torch.Tensor:
        """Frame dirs -> uint8 [V,T,3,S,S] on the device: cache hits as they
        are, misses decoded in up to 8 worker threads (identical dirs once)
        and uploaded as each finishes. The cache lookups (stat-bound) are
        threaded too from 8 dirs on."""
        from concurrent.futures import ThreadPoolExecutor

        from video_caption_tpu_torch.preprocessing import frame_loader

        if len(frames_dirs) >= 8 and self._video_cache_bytes > 0:
            with ThreadPoolExecutor(max_workers=8) as pool:
                lookups = list(pool.map(self._video_cache_get, frames_dirs))
        else:
            lookups = [self._video_cache_get(d) for d in frames_dirs]
        slots = [hit for _, hit in lookups]
        misses: Dict[tuple, List[int]] = {}
        for i, (key, hit) in enumerate(lookups):
            if hit is None:
                misses.setdefault(key or ("uncached", i), []).append(i)
        if misses:
            c = self.config
            groups = list(misses.values())
            with ThreadPoolExecutor(max_workers=min(len(groups), os.cpu_count() or 1, 8)) as pool:
                loaded = pool.map(lambda d: frame_loader.load_video_packed(
                    d, c.num_frames, c.image_size, allow_yuv420=False),
                    [frames_dirs[g[0]] for g in groups])
                for idxs, (_, arr) in zip(groups, loaded):
                    video = torch.from_numpy(arr).to(self.device)
                    self._video_cache_put(lookups[idxs[0]][0], video)
                    for i in idxs:
                        slots[i] = video
        return slots[0] if len(slots) == 1 else torch.cat(slots)

    # ---- public API ------------------------------------------------------

    def infer_video(self, video: torch.Tensor) -> InferenceResult:
        """One uploaded uint8 video [1,T,3,S,S] -> InferenceResult, through
        the request program (a graph replay on CUDA) or, with
        ``aot_request_program`` off, eagerly."""
        if self._serves_on_program(video):
            texts = self._collect_videos(self._dispatch_videos(video))[0]
        else:
            texts = self.generate_presets(self.compute_prefix(video), self._pairs())
        return _result(texts)

    def infer(self, frames_dir: str) -> InferenceResult:
        return self.infer_video(self.load_video(frames_dir))

    def infer_batch_dispatch(self, frames_dirs: Sequence[str]) -> Dispatched:
        """Load, upload and enqueue a batch; returns without waiting for the
        device. Pair with ``infer_batch_collect``: a caller can dispatch
        batch N+1 (its JPEG decode and upload included) before collecting
        batch N."""
        return self._dispatch_videos(self._load_videos(frames_dirs))

    def infer_batch_collect(self, handle: Dispatched) -> List[InferenceResult]:
        """Wait for a dispatched batch; one InferenceResult per video."""
        return [_result(texts) for texts in self._collect_videos(handle)]

    def infer_batch(self, frames_dirs: Sequence[str]) -> List[InferenceResult]:
        """Several videos in one program: one encoder pass over all of them
        and decodes whose rows span videos x presets."""
        return self.infer_batch_collect(self.infer_batch_dispatch(frames_dirs))

    def warmup(self) -> float:
        """One request on a zero video (first-use costs: kernel build,
        allocator growth and, on CUDA, the request graph's capture); returns
        its seconds. It draws from the generator as much as any request."""
        t0 = time.perf_counter()
        s = self.config.image_size
        self.infer_video(torch.zeros((1, self.config.num_frames, 3, s, s),
                                     dtype=torch.uint8, device=self.device))
        return time.perf_counter() - t0


def _result(texts: Sequence[str]) -> InferenceResult:
    candidates = CaptionCandidates(s1=texts[0], s2=texts[1], s3=texts[2])
    best_key, best_text, _ = select_best(list(candidates.items()))
    return InferenceResult(candidates=candidates, best_key=best_key, best_text=best_text)


def _pack(ids: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """Every group's ids as one flat tensor: one copy to the host."""
    return torch.cat([x.reshape(-1) for x in ids])
