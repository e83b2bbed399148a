"""The port's retrieval entry points (retrieval/ and cli/caption_video.py)
against the JAX package's on the same weights, on the CPU at the conftest's
tiny geometry in f32. The default encoders (the configured checkpoint's, or
seeded random weights at ViT-B/16) are swapped for the tiny model on both
sides by patching ``load_params`` and ``model_config_from_inference`` where
the modules import them; the video-to-frames step (ffmpeg or cv2) by
patching ``extract_frames_from_video``."""
import dataclasses
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from test_torch_aot import WordTok, port_cfg, port_params  # noqa: F401
from video_caption_tpu import engine as jengine
from video_caption_tpu.cli import caption_video as jcaption_video
from video_caption_tpu.retrieval import eval_retrieval as jeval
from video_caption_tpu.retrieval import features as jfeatures
from video_caption_tpu.retrieval import index as jindex
from video_caption_tpu.retrieval import query_video as jquery
from video_caption_tpu_torch import engine as pengine
from video_caption_tpu_torch.cli import caption_video
from video_caption_tpu_torch.retrieval import eval_retrieval, features, index, query_video

REPO = Path(__file__).resolve().parents[1]
VIDEOS, FRAMES = 6, 4


@pytest.fixture(scope="module")
def ann_path(tmp_path_factory):
    """Six videos of 3-6 frames, two captions each."""
    root = tmp_path_factory.mktemp("retrieval")
    rng = np.random.RandomState(0)
    records = []
    for vid in range(VIDEOS):
        d = root / f"v{vid}"
        d.mkdir()
        for i in range(3 + vid % 4):
            Image.fromarray(rng.randint(0, 255, (32, 32, 3), np.uint8)).save(
                d / f"frame_{i:05d}.jpg")
        records.append({"video_id": f"v{vid}", "split": "test",
                        "captions": [f"caption a {vid}", f"caption b {vid}"],
                        "frames_dir": str(d)})
    ann = root / "annotations.json"
    ann.write_text(json.dumps(records))
    return str(ann)


@pytest.fixture()
def tiny_defaults(monkeypatch, tiny_cfg, tiny_params, port_params):  # noqa: F811
    """The default encoders of both packages are the tiny model."""
    monkeypatch.setattr(jengine, "model_config_from_inference", lambda cfg: tiny_cfg)
    monkeypatch.setattr(jengine, "load_params", lambda cfg, mc, seed=0: tiny_params)
    monkeypatch.setattr(pengine, "model_config_from_inference", lambda cfg: port_cfg(tiny_cfg))
    monkeypatch.setattr(pengine, "load_params", lambda cfg, mc, seed, device: port_params)


def _both_features(ann_path, tmp_path, **kw):
    kw = dict(num_frames=FRAMES, image_size=32, **kw)
    got = features.extract_features(ann_path, str(tmp_path / "port"), device="cpu", **kw)
    want = jfeatures.extract_features(ann_path, str(tmp_path / "jax"), **kw)
    return got, want


@pytest.mark.parametrize("batch_size,limit", [(4, 0), (8, 0), (3, 4)])
def test_extract_features_matches_the_jax_package(ann_path, tmp_path, tiny_defaults,
                                                  batch_size, limit):
    """The same ids and files; features within 1e-5 (f32, the ViT's and
    adapter's products in another order)."""
    (feats, ids), (jfeats, jids) = _both_features(ann_path, tmp_path, batch_size=batch_size,
                                                  limit=limit)
    assert ids == jids and len(ids) == (limit or VIDEOS)
    assert feats.shape == jfeats.shape == (len(ids), 16)
    np.testing.assert_allclose(feats, jfeats, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(feats, axis=1), 1.0, rtol=1e-5)
    assert json.loads((tmp_path / "port" / "ids.json").read_text()) == ids
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "features.npy"), feats)
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "v1.npy"), feats[1])


def test_index_and_evaluation_match_the_jax_package(ann_path, tmp_path, tiny_defaults):
    """Index search: the same neighbours in the same order (scores within
    1e-5); evaluate_retrieval: the same metrics, over the features and over
    noisy queries that miss some videos."""
    (feats, ids), (jfeats, _) = _both_features(ann_path, tmp_path, batch_size=4)
    idx = index.build_index(feats, ids, str(tmp_path / "idx"),
                            captions={v: f"caption a {v}" for v in ids})
    jidx = jindex.build_index(jfeats, ids, str(tmp_path / "jidx"))
    assert idx.backend == jidx.backend and idx.ntotal == jidx.ntotal == VIDEOS
    rng = np.random.RandomState(3)
    for queries, jqueries in ((feats, jfeats), (feats + 0.6 * rng.randn(*feats.shape),) * 2):
        scores, picks = idx.search(queries, 4)
        jscores, jpicks = jidx.search(jqueries, 4)
        np.testing.assert_array_equal(picks, jpicks)
        np.testing.assert_allclose(scores, jscores, rtol=1e-5, atol=1e-5)
        metrics = eval_retrieval.evaluate_retrieval(queries, ids, idx, ids)
        assert metrics == jeval.evaluate_retrieval(jqueries, ids, jidx, ids)
    assert metrics["num_queries"] == VIDEOS
    loaded, meta = index.load_index(str(tmp_path / "idx"))
    assert meta[2] == {"video_id": "v2", "caption": "caption a v2"}
    np.testing.assert_array_equal(loaded.search(feats, 2)[1], idx.search(feats, 2)[1])


def test_eval_retrieval_cli_matches_the_jax_cli(ann_path, tmp_path, tiny_defaults, capsys):
    features.extract_features(ann_path, str(tmp_path / "f"), num_frames=FRAMES, image_size=32,
                              device="cpu")
    assert eval_retrieval.main(["--features_dir", str(tmp_path / "f"),
                                "--out", str(tmp_path / "m.json")]) == 0
    got = capsys.readouterr().out
    assert jeval.main(["--features_dir", str(tmp_path / "f")]) == 0
    assert got == capsys.readouterr().out
    assert json.loads(got) == json.loads((tmp_path / "m.json").read_text())
    assert json.loads(got)["recall@1"] == 1.0          # each video finds itself


def _copy_frames(src):
    """An ``extract_frames_from_video`` that copies a frames dir's JPEGs."""
    def extract(video_path, out_dir, fps=2):
        for f in sorted(Path(src).glob("frame_*.jpg")):
            shutil.copy(f, Path(out_dir) / f.name)
        return len(list(Path(out_dir).glob("frame_*.jpg")))
    return extract


def test_query_video_matches_the_jax_package(ann_path, tmp_path, tiny_defaults, monkeypatch):
    """A query video (the frames of v3): the same neighbours, v3 first,
    scores within 1e-5."""
    feats, ids = features.extract_features(ann_path, str(tmp_path / "f"), num_frames=FRAMES,
                                           image_size=32, device="cpu")
    index.build_index(feats, ids, str(tmp_path / "idx"),
                      captions={v: f"caption a {v}" for v in ids})
    src = json.loads(Path(ann_path).read_text())[3]["frames_dir"]
    for module in (query_video, jquery):
        monkeypatch.setattr(module, "extract_frames_from_video", _copy_frames(src))
    got = query_video.query_video("clip.mp4", str(tmp_path / "idx"), top_k=3,
                                  num_frames=FRAMES, image_size=32, device="cpu")
    want = jquery.query_video("clip.mp4", str(tmp_path / "idx"), top_k=3,
                              num_frames=FRAMES, image_size=32)
    assert [(r["rank"], r["video_id"], r["caption"]) for r in got] == \
        [(r["rank"], r["video_id"], r["caption"]) for r in want]
    np.testing.assert_allclose([r["score"] for r in got], [r["score"] for r in want],
                               rtol=1e-5, atol=1e-5)
    assert got[0]["video_id"] == "v3" and got[0]["caption"] == "caption a v3"


def test_extract_frames_without_ffmpeg_or_cv2_raises(tmp_path, monkeypatch):
    """Neither tool: the cv2 import fails, as in the JAX package."""
    if shutil.which("ffmpeg"):
        pytest.skip("ffmpeg is installed here")
    monkeypatch.setitem(sys.modules, "cv2", None)
    for module in (query_video, jquery):
        with pytest.raises(ImportError):
            module.extract_frames_from_video("clip.mp4", str(tmp_path / "out"))


def test_caption_video_cli_matches_the_jax_cli(ann_path, tiny_cfg, tiny_params,  # noqa: F811
                                               port_params, monkeypatch, capsys):
    """``caption_video`` on the frames of v4 through both packages' engines
    (the tiny model at 32x32, the core presets): the same beam captions; the
    sampled one a non-empty string."""
    src = json.loads(Path(ann_path).read_text())[4]["frames_dir"]
    for module in (query_video, jquery):
        monkeypatch.setattr(module, "extract_frames_from_video", _copy_frames(src))
    port_engine, jax_engine = pengine.InferenceEngine, jengine.InferenceEngine

    def port(cfg, device="cuda"):
        assert device == "cpu"
        eng = port_engine(dataclasses.replace(cfg, image_size=32), params=port_params,
                          model_cfg=port_cfg(tiny_cfg), device=device)
        eng.tokenizer = WordTok()
        return eng

    def jax_(cfg):
        eng = jax_engine(dataclasses.replace(cfg, image_size=32), params=tiny_params,
                         model_cfg=tiny_cfg)
        eng.tokenizer = WordTok()
        return eng

    monkeypatch.setattr(pengine, "InferenceEngine", port)
    monkeypatch.setattr(jengine, "InferenceEngine", jax_)
    args = ["--video", "clip.mp4", "--num_frames", str(FRAMES), "--emit_json"]
    assert caption_video.main(args + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert jcaption_video.main(args) == 0
    want = json.loads(capsys.readouterr().out)
    assert (got["S1"], got["S2"]) == (want["S1"], want["S2"])
    assert got["S1"] != "Someone is in the scene." and isinstance(got["S3"], str) and got["S3"]
    assert caption_video.main(["--video", "clip.mp4", "--num_frames", str(FRAMES),
                               "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("BEST[")


def test_index_copy_is_the_jax_packages_file():
    """retrieval/index.py imports nothing of either package: the copy is the
    original, byte for byte."""
    assert (REPO / "video_caption_tpu_torch/retrieval/index.py").read_bytes() == \
        (REPO / "video_caption_tpu/retrieval/index.py").read_bytes()
