"""The port's cold request as the JAX package runs it by default, on the CPU at
the conftest's tiny geometry in f32: the overlapped chunk upload
(``_load_feats_overlapped``: frames decode in chunks of 8 and each chunk's
ViT trunk runs while the next decodes), the feats request program, the 4:2:0
wire and the pixel path it falls back to on a video-cache hit.

Graphs exist only on CUDA (chip_smoke.py captures the trunk and feats graphs
there); here every program runs uncaptured. Beam and greedy candidates
compare exactly with the JAX engine's; the sampled one draws from another
generator and is held as tests/test_torch_engine.py holds it."""
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_aot import WordTok, port_cfg, port_params  # noqa: F401
from video_caption_tpu import engine as jengine
from video_caption_tpu.config import default_inference_config as jax_default_config
from video_caption_tpu.models import caption_model as jcm
from video_caption_tpu.models import vit as jvt
from video_caption_tpu_torch import engine as pengine
from video_caption_tpu_torch.config import default_inference_config
from video_caption_tpu_torch.engine import InferenceEngine
from video_caption_tpu_torch.models import caption_model as cm
from video_caption_tpu_torch.models import vit as vt
from video_caption_tpu_torch.native import loader
from video_caption_tpu_torch.preprocessing import yuv420

FRAMES = 10          # a chunk of 8 and a tail of 2 (and 4 + 4 + 2 on the chunk-4 upload)
GREEDY = dict(num_beams=1, max_new_tokens=24, temperature=1.0, top_p=1.0,
              no_repeat_ngram_size=3, repetition_penalty=1.1)
PRESETS = dict(preset1="precise", preset2="detailed", preset3="greedy")


def _frames(root, name, count, seed, subsampling=None):
    """``count`` 32x32 JPEGs at q75 and q95: PIL writes them 4:2:0 unless
    ``subsampling`` says otherwise."""
    d = root / name
    d.mkdir()
    rng = np.random.RandomState(seed)
    for i in range(count):
        kw = {} if subsampling is None else {"subsampling": subsampling}
        Image.fromarray(rng.randint(0, 255, (32, 32, 3), np.uint8)).save(
            d / f"frame_{i:05d}.jpg", quality=(75, 95)[i % 2], **kw)
    return str(d)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The engines here run thousands of tiny ops: with every core's
    intra-op thread taking part, they slow down many times over while
    other test processes load the machine. One thread for this module,
    restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("overlap")
    return [_frames(root, "v0", 12, 0), _frames(root, "v1", 7, 1),
            _frames(root, "v444", 12, 2, subsampling=0)]


@pytest.fixture()
def greedy_preset(monkeypatch):
    """A ``greedy`` preset (num_beams 1, temperature 1) in both packages: no
    named preset decodes greedily."""
    for module in (jengine, pengine):
        real = module.preset_to_kwargs
        monkeypatch.setattr(module, "preset_to_kwargs",
                            lambda name, real=real: dict(GREEDY) if name == "greedy"
                            else real(name))


def _port(tiny_cfg, params, seed=0, presets=PRESETS, **compile_kw):
    cfg = default_inference_config(ckpt="missing.pt", num_frames=FRAMES, image_size=32,
                                   **presets)
    cfg = dataclasses.replace(cfg, compile=dataclasses.replace(cfg.compile, **compile_kw))
    eng = InferenceEngine(cfg, params=params, model_cfg=port_cfg(tiny_cfg), seed=seed,
                          device="cpu")
    eng.tokenizer = WordTok()
    return eng


def _spy(monkeypatch, eng, name):
    calls = []
    real = getattr(eng, name)
    monkeypatch.setattr(eng, name, lambda *a: (calls.append(a), real(*a))[1])
    return calls


# ---- the per-chunk encode --------------------------------------------------

def test_encode_frames_over_uneven_chunks_matches_vit_encode(tiny_cfg, tiny_params,
                                                             port_params):  # noqa: F811
    """vit_finish of the trunk run in chunks of 3 and 5 equals vit_encode of
    the whole video (2e-6), and each chunk's features equal JAX's (2e-6)."""
    cfg = port_cfg(tiny_cfg).vit
    video = np.random.RandomState(1).randint(0, 255, (2, 4, 3, 32, 32)).astype(np.uint8)
    enc = port_params["encoder"]
    frames = torch.from_numpy(video).reshape(8, 3, 32, 32)
    chunks = [vt.vit_encode_frames(enc, frames[:3], cfg),
              vt.vit_encode_frames(enc, frames[3:], cfg)]
    got = vt.vit_finish(enc, torch.cat(chunks).reshape(2, 4, -1), cfg)
    want = vt.vit_encode(enc, torch.from_numpy(video), cfg)
    torch.testing.assert_close(got, want, rtol=2e-6, atol=2e-6)
    jframes = jnp.asarray(video.reshape(8, 3, 32, 32))
    for chunk, rows in zip(chunks, (slice(0, 3), slice(3, 8))):
        jchunk = jvt.vit_encode_frames(tiny_params["encoder"], jframes[rows], tiny_cfg.vit)
        np.testing.assert_allclose(chunk.numpy(), np.asarray(jchunk), rtol=2e-6, atol=2e-6)


def test_frames_to_prefix_matches_video_to_prefix(tiny_cfg, tiny_params, port_params):  # noqa: F811
    """frames_to_prefix(encode_frames(video)) equals video_to_prefix(video)
    and JAX's frames_to_prefix (2e-6)."""
    cfg = port_cfg(tiny_cfg)
    video = np.random.RandomState(2).randint(0, 255, (1, 4, 3, 32, 32)).astype(np.uint8)
    feats = cm.encode_frames(port_params, torch.from_numpy(video[0]), cfg)[None]
    got = cm.frames_to_prefix(port_params, feats, cfg)
    torch.testing.assert_close(got, cm.video_to_prefix(port_params, torch.from_numpy(video), cfg),
                               rtol=2e-6, atol=2e-6)
    jfeats = jcm.encode_frames(tiny_params, jnp.asarray(video[0]), tiny_cfg)[None]
    want = jcm.frames_to_prefix(tiny_params, jfeats, tiny_cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6, atol=2e-6)


# ---- the engine against the JAX engine ---------------------------------------

def test_cold_and_warm_requests_match_the_jax_engine(tiny_cfg, tiny_params,
                                                     port_params,  # noqa: F811
                                                     dirs, greedy_preset, monkeypatch):
    """Both engines at their defaults (overlap and wire on): the same
    ``to_api_dict()`` cold (the feats program) and warm (the pixel program),
    for 4:2:0 frames, a tail-padded video and 4:4:4 frames (RGB wire)."""
    jcfg = jax_default_config(ckpt="missing.pt", num_frames=FRAMES, image_size=32, **PRESETS)
    assert jcfg.compile.overlap_single_upload and jcfg.compile.yuv420_wire
    jax_engine = jengine.InferenceEngine(jcfg, params=tiny_params, model_cfg=tiny_cfg)
    jax_engine.tokenizer = WordTok()
    port = _port(tiny_cfg, port_params)
    feats = _spy(monkeypatch, port, "_dispatch_feats")
    for d in dirs:
        for _ in ("cold", "warm"):
            got, want = port.infer(d).to_api_dict(), jax_engine.infer(d).to_api_dict()
            assert got == want
        assert got["S1"] != "Someone is in the scene."      # not vacuous
    assert len(feats) == len(dirs)                           # one cold request a dir


def test_default_presets_match_the_jax_engine_on_beams(tiny_cfg, tiny_params,
                                                        port_params, dirs):  # noqa: F811
    """The core presets (two beam groups and a sampled one): beams equal
    cold and warm; the sampled caption a non-empty string."""
    jcfg = jax_default_config(ckpt="missing.pt", num_frames=FRAMES, image_size=32)
    jax_engine = jengine.InferenceEngine(jcfg, params=tiny_params, model_cfg=tiny_cfg)
    jax_engine.tokenizer = WordTok()
    port = _port(tiny_cfg, port_params, presets={})
    for _ in ("cold", "warm"):
        got, want = port.infer(dirs[0]).to_api_dict(), jax_engine.infer(dirs[0]).to_api_dict()
        assert (got["S1"], got["S2"]) == (want["S1"], want["S2"])
        assert isinstance(got["S3"], str) and got["S3"]


# ---- the engine against itself -----------------------------------------------

@pytest.mark.parametrize("cache_mb", ["256", "0"])
def test_overlap_and_wire_on_and_off_give_identical_results(tiny_cfg,
                                                            port_params,  # noqa: F811
                                                            dirs,
                                                            monkeypatch, cache_mb):
    """Four engines from one seed, overlap and wire each on and off, over a
    cold and a warm round (the sampled caption included) of the 4:2:0
    videos: identical results. With the cache off every request is cold
    (one round)."""
    monkeypatch.setenv("VIDEO_CAPTION_VIDEO_CACHE_MB", cache_mb)
    engines = [_port(tiny_cfg, port_params, seed=5, presets={}, overlap_single_upload=o,
                     yuv420_wire=w) for o in (True, False) for w in (True, False)]
    for _ in range(2 if cache_mb != "0" else 1):
        for d in dirs[:2]:
            results = [eng.infer(d).to_api_dict() for eng in engines]
            assert all(r == results[0] for r in results[1:]), results
    assert [len(eng._video_cache) for eng in engines] == [2 * (cache_mb != "0")] * 4


def test_cold_request_takes_the_feats_program_and_fills_the_cache(tiny_cfg,
                                                                  port_params,  # noqa: F811
                                                                  dirs,
                                                                  monkeypatch):
    """A miss: the trunk of each chunk (8 and the tail of 2, on the 4:2:0
    wire) and one feats dispatch of [1,T,E]; the cache then holds the
    video's pixels, equal to the chunked upload's, and a repeat request
    takes the pixel program."""
    eng = _port(tiny_cfg, port_params)
    trunks = _spy(monkeypatch, eng, "_chunk_trunk")
    feats = _spy(monkeypatch, eng, "_dispatch_feats")
    pixels = _spy(monkeypatch, eng, "_dispatch_videos")
    eng.infer(dirs[0])
    assert [(kind, n, tuple(x.shape)) for kind, n, x in trunks] == [
        ("yuv420", 8, (8, yuv420.packed_plane_len(32))),
        ("yuv420", 2, (8, yuv420.packed_plane_len(32)))]
    assert (loader.last_backend, loader.last_error) == ("native-yuv420", None)
    assert [tuple(f.shape) for (f,) in feats] == [(1, FRAMES, eng.model_cfg.vit.embed_dim)]
    assert not pixels
    (cached,) = eng._video_cache.values()
    off = _port(tiny_cfg, port_params, overlap_single_upload=False, yuv420_wire=False)
    torch.testing.assert_close(cached, off.load_video(dirs[0]), rtol=0, atol=0)
    eng.infer(dirs[0])
    assert len(feats) == 1 and len(pixels) == 1 and len(trunks) == 2


def test_rgb_frames_take_the_rgb_wire(tiny_cfg, port_params, dirs, monkeypatch):  # noqa: F811
    """4:4:4 frames: the loader refuses the planes and says why, and the
    chunks travel as RGB."""
    eng = _port(tiny_cfg, port_params)
    trunks = _spy(monkeypatch, eng, "_chunk_trunk")
    assert loader.load_frames_native_yuv420(sorted(Path(dirs[2]).glob("*.jpg"))[:1], 32) is None
    assert loader.last_backend == "rgb-fallback" and loader.last_error.startswith("unsupported")
    eng.infer(dirs[2])
    assert [(kind, n, tuple(x.shape)) for kind, n, x in trunks] == [
        ("rgb", 8, (8, 3, 32, 32)), ("rgb", 2, (2, 3, 32, 32))]


def test_without_the_native_loader_every_frame_travels_as_rgb(tiny_cfg,
                                                               port_params,  # noqa: F811
                                                               dirs,
                                                             monkeypatch):
    """The card's machine has no libjpeg headers: the loader returns None,
    the frames decode through PIL, and the result is the wire's."""
    want = _port(tiny_cfg, port_params, seed=2).infer(dirs[0]).to_api_dict()
    for name in ("load_frames_native_yuv420", "load_frames_native_u8"):
        monkeypatch.setattr(loader, name, lambda *a, **k: None)
    eng = _port(tiny_cfg, port_params, seed=2)
    trunks = _spy(monkeypatch, eng, "_chunk_trunk")
    assert eng.infer(dirs[0]).to_api_dict() == want
    assert [kind for kind, _, _ in trunks] == ["rgb", "rgb"]


def test_gap_pooling_takes_the_pixel_path(tiny_cfg, port_params, dirs, monkeypatch):  # noqa: F811
    """The per-frame trunk serves only ``cls`` pooling, as in the JAX engine."""
    eng = _port(tiny_cfg, port_params)
    eng.model_cfg = dataclasses.replace(eng.model_cfg, vit=dataclasses.replace(
        eng.model_cfg.vit, pool="gap"))
    assert eng._load_feats_overlapped(dirs[1]) is None
    feats = _spy(monkeypatch, eng, "_dispatch_feats")
    eng.infer(dirs[1])
    assert not feats


def test_batches_take_the_4_2_0_wire(tiny_cfg, port_params, dirs, monkeypatch):  # noqa: F811
    """``infer_batch`` of several dirs ships 4:2:0 videos as planes and
    converts them on the device (the JAX engine's ``"yuv420"`` kind); one
    dir takes the chunked upload. Results equal the RGB wire's."""
    on = _port(tiny_cfg, port_params, seed=3, presets={})
    off = _port(tiny_cfg, port_params, seed=3, presets={}, yuv420_wire=False)
    converted = []
    real = on._yuv_fn
    on._yuv_fn = lambda planes: (converted.append(tuple(planes.shape)), real(planes))[1]
    for batch in (dirs, dirs[:1]):
        got = [r.to_api_dict() for r in on.infer_batch(batch)]
        assert got == [r.to_api_dict() for r in off.infer_batch(batch)]
    plane = yuv420.packed_plane_len(32)
    # v0 and v1 as whole videos; then v0 from the cache
    assert converted == [(FRAMES, plane), (FRAMES, plane)]
    on._video_cache.clear()
    on.infer_batch(dirs[:1])
    assert converted[2:] == [(4, plane)] * 3          # chunks of 4, the tail padded


def test_warmup_runs_the_overlapped_path(tiny_cfg, port_params, monkeypatch):  # noqa: F811
    """warm-up: a pixel request, each chunk shape's trunk on both wires and
    the feats program; it draws from the generator twice."""
    eng = _port(tiny_cfg, port_params)
    trunks = _spy(monkeypatch, eng, "_chunk_trunk")
    feats = _spy(monkeypatch, eng, "_dispatch_feats")
    pixels = _spy(monkeypatch, eng, "_dispatch_videos")
    eng.warmup()
    plane = yuv420.packed_plane_len(32)
    assert [(kind, n, tuple(x.shape)) for kind, n, x in trunks] == [
        ("rgb", 2, (2, 3, 32, 32)), ("yuv420", 2, (8, plane)),
        ("rgb", 8, (8, 3, 32, 32)), ("yuv420", 8, (8, plane))]
    assert len(feats) == len(pixels) == 1
