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
``compile.aot_request_program``, both on by default). On CUDA that
program is captured once per video shape into a CUDA graph
(``aot.RequestGraph``, the counterpart of ``_aot_single_exec``) and every
request replays it: one host call for the whole request instead of one
per kernel. A capture that fails raises. ``aot_request_program=False``
(``VIDEO_CAPTION_AOT_REQUEST=0``) serves the request eagerly, op by op; on
a CPU engine the program runs uncaptured.

Not ported yet: the device video LRU, the overlapped chunk upload and its
feats program, the serialized request artifact, the unified mixed-policy
decode (its tokens are identical to the grouped decode, which the program
runs), the 4:2:0 wire and ``infer_batch``.
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from video_caption_tpu_torch.aot import RequestGraph
from video_caption_tpu_torch.config import InferenceConfig
from video_caption_tpu_torch.datatypes import CaptionCandidates, InferenceResult
from video_caption_tpu_torch.decode.presets import preset_to_kwargs
from video_caption_tpu_torch.decode.tokenizer import get_tokenizer
from video_caption_tpu_torch.postprocessing.candidate_ranker import select_best
from video_caption_tpu_torch.postprocessing.text_cleaner import clean_text
from video_caption_tpu_torch.decode.generate import DecodeParams, generate_prefixed
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
        self._program = None
        self._graphs: Dict[Tuple[int, ...], RequestGraph] = {}

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

    def _fused_infer_program(self):
        """(program, group_list), built once: ``program(video)`` takes the
        uploaded uint8 video [V,T,3,S,S] to the token ids of every decode
        group, ``(ids of group 0 [V*R0, N0], ...)``; ``group_list`` holds
        each group's (policy, preset indices, prompt ids, prompt mask), the
        LEFT-padded prompts uploaded once as constant device tensors.

        The program makes no host synchronisation and no host-to-device
        copy, so a CUDA graph can capture it (counterpart of the JAX
        engine's ``_fused_infer_program``)."""
        if self._program is not None:
            return self._program
        pairs = self._pairs()
        group_list = []
        for dp, idxs in self._policy_groups(pairs).items():
            ids_arr, mask_arr = self._prompt_batch([pairs[i][1] or "" for i in idxs])
            group_list.append((dp, tuple(idxs), torch.from_numpy(ids_arr).to(self.device),
                               torch.from_numpy(mask_arr).to(self.device)))
        params, model_cfg, generator = self.params, self.model_cfg, self.generator

        def program(video: torch.Tensor) -> Tuple[torch.Tensor, ...]:
            with torch.inference_mode():
                prefix = cm.video_to_prefix(params, video, model_cfg)       # [V,P,H]
                v = prefix.shape[0]
                return tuple(generate_prefixed(
                    params["decoder"], model_cfg.gpt2, prefix.repeat_interleave(len(idxs), dim=0),
                    ids.repeat(v, 1), mask.repeat(v, 1), dp, generator)
                    for dp, idxs, ids, mask in group_list)

        self._program = (program, group_list)
        return self._program

    def _serves_on_program(self, video: torch.Tensor) -> bool:
        cc = self.config.compile
        return video.shape[0] == 1 and cc.aot_request_program and (
            cc.fuse_single_request or cc.fuse_request_program)

    def request_graph(self, video: torch.Tensor) -> RequestGraph:
        """The request program captured for ``video``'s shape (on first use
        of that shape; the engine's generator registered with it)."""
        key = tuple(video.shape)
        if key not in self._graphs:
            program, _ = self._fused_infer_program()
            self._graphs[key] = RequestGraph.capture(
                lambda x: _pack(program(x)), video, (self.generator,))
            log.info("request graph for %s: warm-up run %.2f s, capture %.2f s", key,
                     self._graphs[key].warmup_s, self._graphs[key].capture_s)
        return self._graphs[key]

    def request_ids(self, video: torch.Tensor) -> List[np.ndarray]:
        """The request program on one video: ids [R_g, N_g] of every decode
        group, on the host. On CUDA with ``aot_request_program`` one replay
        of the request graph and one device-to-host copy; otherwise (on the
        CPU, or with it off) the program runs uncaptured."""
        program, group_list = self._fused_infer_program()
        if self.device.type == "cuda" and self.config.compile.aot_request_program:
            flat = self.request_graph(video).replay(video)
        else:
            flat = _pack(program(video))
        flat = flat.cpu().numpy()
        out, start = [], 0
        for dp, idxs, _, _ in group_list:
            size = len(idxs) * video.shape[0] * dp.max_new_tokens
            out.append(flat[start:start + size].reshape(-1, dp.max_new_tokens))
            start += size
        return out

    def load_video(self, frames_dir: str) -> torch.Tensor:
        """frames_dir -> uint8 [1,T,3,S,S] on the engine's device (one upload).
        Stride sampling and tail padding as the JAX engine; frames decode in
        the C++ loader, or PIL where the native library is unavailable."""
        from video_caption_tpu_torch.native.loader import load_frames_native_u8
        from video_caption_tpu_torch.preprocessing.frame_loader import (
            list_frames, load_image_u8, sample_frame_paths,
        )

        files = list_frames(frames_dir)
        if not files:
            raise FileNotFoundError(f"No frame_*.jpg files found under {frames_dir}")
        picks = sample_frame_paths(files, self.config.num_frames)
        picks += [picks[-1]] * (self.config.num_frames - len(picks))
        size = self.config.image_size
        arr = load_frames_native_u8(picks, size)
        if arr is None:
            arr = np.stack([load_image_u8(p, size) for p in picks])
        return torch.from_numpy(arr).to(self.device)[None]

    def infer_video(self, video: torch.Tensor) -> InferenceResult:
        """One uploaded uint8 video [1,T,3,S,S] -> InferenceResult, through
        the request program (a graph replay on CUDA) or, with
        ``aot_request_program`` off, eagerly."""
        pairs = self._pairs()
        if self._serves_on_program(video):
            _, group_list = self._fused_infer_program()
            texts = [[""] * len(pairs)]
            for (_, idxs, _, _), ids in zip(group_list, self.request_ids(video)):
                self._texts_of(ids, idxs, texts)
            texts = texts[0]
        else:
            texts = self.generate_presets(self.compute_prefix(video), pairs)
        candidates = CaptionCandidates(s1=texts[0], s2=texts[1], s3=texts[2])
        best_key, best_text, _ = select_best(list(candidates.items()))
        return InferenceResult(candidates=candidates, best_key=best_key, best_text=best_text)

    def infer(self, frames_dir: str) -> InferenceResult:
        return self.infer_video(self.load_video(frames_dir))

    def warmup(self) -> None:
        """One request on a zero video (first-use costs: kernel build,
        allocator growth and, on CUDA, the request graph's capture). It
        draws from the generator as much as any request."""
        s = self.config.image_size
        self.infer_video(torch.zeros((1, self.config.num_frames, 3, s, s),
                                     dtype=torch.uint8, device=self.device))


def _pack(ids: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """Every group's ids as one flat tensor: one copy to the host."""
    return torch.cat([x.reshape(-1) for x in ids])
