"""The port's InferenceEngine (device="cpu") against the JAX engine on the same
weights and JPEG frame directories, and the port's independence from JAX."""
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from video_caption_tpu.config import default_inference_config
from video_caption_tpu.engine import InferenceEngine as JaxEngine
from video_caption_tpu_torch.engine import InferenceEngine
from video_caption_tpu_torch.models import caption_model as cm
from video_caption_tpu_torch.models import gpt2 as g2
from video_caption_tpu_torch.models import vit as vt
from video_caption_tpu_torch.models.convert import params_from_jax_numpy

REPO = Path(__file__).resolve().parents[1]
WORDS = ("a man woman dog cat is are the on in with red blue small big runs walks plays "
         "sits holds ball car street park table water food girl boy child playing riding "
         "eating talking").split()


class WordTok:
    """Tiny-vocab tokenizer whose decodes are word strings the cleaner keeps."""
    eos_token_id = bos_token_id = pad_token_id = 127
    vocab_size = 128

    def encode(self, text):
        return [b % 127 for b in text.encode()] or [1]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(WORDS[int(i) % len(WORDS)] for i in ids if int(i) != 127)


def port_cfg(jcfg, dtype=torch.float32):
    v, g = jcfg.vit, jcfg.gpt2
    return cm.CaptionModelConfig(
        vit=vt.ViTConfig(image_size=v.image_size, patch_size=v.patch_size,
                         embed_dim=v.embed_dim, depth=v.depth, num_heads=v.num_heads,
                         out_dim=v.out_dim, dtype=dtype),
        gpt2=g2.GPT2Config(vocab_size=g.vocab_size,
                           max_position_embeddings=g.max_position_embeddings,
                           n_embd=g.n_embd, n_layer=g.n_layer, n_head=g.n_head, dtype=dtype),
        prefix_len=jcfg.prefix_len, video_dim=jcfg.video_dim)


@pytest.fixture(scope="module")
def frames_dirs(tmp_path_factory):
    rng = np.random.RandomState(7)
    dirs = []
    for v, count in enumerate((3, 5)):
        d = tmp_path_factory.mktemp(f"vid{v}")
        for i in range(count):
            Image.fromarray(rng.randint(0, 255, (32, 32, 3), np.uint8)).save(d / f"frame_{i:05d}.jpg")
        dirs.append(str(d))
    return dirs


def _engines(tiny_cfg, tiny_params, **overrides):
    cfg = default_inference_config(ckpt="missing.pt", num_frames=2, image_size=32, **overrides)
    jax_engine = JaxEngine(cfg, params=tiny_params, model_cfg=tiny_cfg)
    pcfg = port_cfg(tiny_cfg)
    port = InferenceEngine(cfg, params=params_from_jax_numpy(
        jax.tree.map(np.asarray, tiny_params), pcfg, "cpu"), model_cfg=pcfg, device="cpu")
    jax_engine.tokenizer = port.tokenizer = WordTok()
    return jax_engine, port


def test_beam_presets_match_jax_engine(tiny_cfg, tiny_params, frames_dirs):
    jax_engine, port = _engines(tiny_cfg, tiny_params, preset1="precise", preset2="detailed",
                                preset3="precise", prompt3="Another prompt:")
    for d in frames_dirs:
        want = jax_engine.infer(d).to_api_dict()
        got = port.infer(d).to_api_dict()
        assert got == want
        assert got["S1"] != "Someone is in the scene."   # the comparison is not vacuous


def test_default_presets_match_jax_engine_on_beams(tiny_cfg, tiny_params, frames_dirs):
    jax_engine, port = _engines(tiny_cfg, tiny_params)
    want = jax_engine.infer(frames_dirs[0]).to_api_dict()
    got = port.infer(frames_dirs[0]).to_api_dict()
    assert (got["S1"], got["S2"]) == (want["S1"], want["S2"])
    assert isinstance(got["S3"], str) and got["S3"]
    assert got["BEST"]["key"] in ("S1", "S2", "S3")


def test_sampled_preset_is_seeded(tiny_cfg, tiny_params, frames_dirs):
    pcfg = port_cfg(tiny_cfg)
    cfg = default_inference_config(ckpt="missing.pt", num_frames=2, image_size=32,
                                   preset1="natural", preset2="natural", preset3="natural")
    params = params_from_jax_numpy(jax.tree.map(np.asarray, tiny_params), pcfg, "cpu")
    runs = []
    for _ in range(2):
        eng = InferenceEngine(cfg, params=params, model_cfg=pcfg, seed=3, device="cpu")
        eng.tokenizer = WordTok()
        runs.append(eng.infer(frames_dirs[1]).to_api_dict())
    assert runs[0] == runs[1]


def test_engine_rejects_unported_options(tiny_cfg, tiny_params):
    """A mesh engine needs the caller's process group of data * model ranks:
    without one it raises ValueError, as the JAX package's make_mesh does
    on a device count that does not match (int8, which this test once saw
    refused, runs: test_int8_engine_matches_jax_engine; the mesh engines:
    tests/test_torch_parallel.py)."""
    import dataclasses

    base = default_inference_config(ckpt="missing.pt", num_frames=2, image_size=32)
    mesh = dataclasses.replace(base, mesh=dataclasses.replace(base.mesh, data=2))
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        InferenceEngine(mesh, model_cfg=port_cfg(tiny_cfg), device="cpu")


def test_int8_engine_matches_jax_engine(tiny_cfg, tiny_params, frames_dirs):
    """``compile.quantize_decoder_int8``: both engines quantize the decoder
    blocks at construction; beam presets give the same results."""
    import dataclasses

    cfg = default_inference_config(ckpt="missing.pt", num_frames=2, image_size=32,
                                   preset1="precise", preset2="detailed", preset3="precise",
                                   prompt3="Another prompt:")
    cfg = dataclasses.replace(cfg, compile=dataclasses.replace(cfg.compile,
                                                               quantize_decoder_int8=True))
    jax_engine = JaxEngine(cfg, params=tiny_params, model_cfg=tiny_cfg)
    pcfg = port_cfg(tiny_cfg)
    port = InferenceEngine(cfg, params=params_from_jax_numpy(
        jax.tree.map(np.asarray, tiny_params), pcfg, "cpu"), model_cfg=pcfg, device="cpu")
    jax_engine.tokenizer = port.tokenizer = WordTok()
    blocks = port.params["decoder"]["blocks"]
    assert blocks["attn_w_q"].dtype == torch.int8 and blocks["attn_w_s"].dtype == torch.float32
    np.testing.assert_array_equal(blocks["out_w_q"].numpy(),
                                  np.asarray(jax_engine.params["decoder"]["blocks"]["out_w_q"]))
    for d in frames_dirs:
        got, want = port.infer(d).to_api_dict(), jax_engine.infer(d).to_api_dict()
        assert got == want
        assert got["S1"] != "Someone is in the scene."


def test_cuda_engine_without_gpu_raises(tiny_cfg):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = default_inference_config(ckpt="missing.pt", num_frames=2, image_size=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(cfg, model_cfg=port_cfg(tiny_cfg))


def test_missing_frames_dir_raises(tiny_cfg, tiny_params, tmp_path):
    _, port = _engines(tiny_cfg, tiny_params)
    with pytest.raises(FileNotFoundError):
        port.infer(str(tmp_path / "nowhere"))


def test_port_imports_no_jax():
    code = ("import sys, video_caption_tpu_torch.engine, video_caption_tpu_torch.cli.infer_once; "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_cli_flags_match_jax_cli():
    from video_caption_tpu.cli.infer_once import build_parser as jax_parser
    from video_caption_tpu_torch.cli.infer_once import build_parser

    def flags(p):
        return {a.dest: a.default for a in p._actions if a.dest != "help"}

    port_flags = flags(build_parser())
    assert port_flags.pop("device") == "cuda"
    assert port_flags == flags(jax_parser())
