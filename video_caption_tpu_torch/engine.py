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

Not ported yet: the device video LRU, the overlapped chunk upload, the
fused/AOT request programs, the unified mixed-policy decode (its tokens are
identical to the grouped decode), the 4:2:0 wire and ``infer_batch``.
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

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
        self.params = params
        self.tokenizer = get_tokenizer()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._prompt_ids: Dict[str, np.ndarray] = {}

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

    def _generate_group(self, prefix_rows: torch.Tensor, prompts, dp: DecodeParams) -> np.ndarray:
        """Decode R (prefix, prompt) rows under one policy as one LEFT-padded
        batch; prefix_rows is [R, P, H]."""
        ids_list = [self._tokenize_prompt(p or "") for p in prompts]
        max_len = max(len(ids) for ids in ids_list)
        ids_arr = np.full((len(prompts), max_len), self.tokenizer.pad_token_id, np.int64)
        mask_arr = np.zeros((len(prompts), max_len), np.int32)
        for row, ids in enumerate(ids_list):
            ids_arr[row, max_len - len(ids):] = ids
            mask_arr[row, max_len - len(ids):] = 1
        with torch.inference_mode():
            out = generate_prefixed(
                self.params["decoder"], self.model_cfg.gpt2, prefix_rows,
                torch.from_numpy(ids_arr).to(self.device),
                torch.from_numpy(mask_arr).to(self.device), dp, self.generator)
        return out.cpu().numpy()

    def generate_presets(self, prefix: torch.Tensor, preset_prompt_pairs):
        """Decode presets for V videos (prefix [V, P, H]); returns texts[v][i],
        or a flat list when V == 1. Rows with the same decode policy decode as
        one program, video-major: [(v0,i0), (v0,i1), (v1,i0), ...]."""
        v = prefix.shape[0]
        groups: Dict[DecodeParams, list] = {}
        for i, (preset, _) in enumerate(preset_prompt_pairs):
            groups.setdefault(self._decode_params(**preset_to_kwargs(preset)), []).append(i)
        texts = [[""] * len(preset_prompt_pairs) for _ in range(v)]
        for dp, idxs in groups.items():
            prompts = [preset_prompt_pairs[i][1] or "" for _ in range(v) for i in idxs]
            out_ids = self._generate_group(prefix.repeat_interleave(len(idxs), dim=0),
                                           prompts, dp)
            for row in range(out_ids.shape[0]):
                vid, slot = divmod(row, len(idxs))
                text = self.tokenizer.decode(out_ids[row], skip_special_tokens=True)
                texts[vid][idxs[slot]] = clean_text(text.strip())
        return texts[0] if v == 1 else texts

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
        """One uploaded uint8 video [1,T,3,S,S] -> InferenceResult."""
        c = self.config
        pairs = [(c.preset1, c.prompt1), (c.preset2, c.prompt2), (c.preset3, c.prompt3)]
        texts = self.generate_presets(self.compute_prefix(video), pairs)
        candidates = CaptionCandidates(s1=texts[0], s2=texts[1], s3=texts[2])
        best_key, best_text, _ = select_best(list(candidates.items()))
        return InferenceResult(candidates=candidates, best_key=best_key, best_text=best_text)

    def infer(self, frames_dir: str) -> InferenceResult:
        return self.infer_video(self.load_video(frames_dir))

    def warmup(self) -> None:
        """One request on a zero video (first-use costs: kernel build,
        allocator growth)."""
        s = self.config.image_size
        self.infer_video(torch.zeros((1, self.config.num_frames, 3, s, s),
                                     dtype=torch.uint8, device=self.device))
