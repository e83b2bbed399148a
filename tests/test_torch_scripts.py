"""The port's data scripts (scripts/), tools/human_eval.py, ops/temporal_pool.py
and utils/ against the JAX package's modules on the CPU: small videos and
frame directories written here with cv2 and PIL go through both packages,
and their output files agree byte for byte (row for row where a file
records a path); the parser smoke of the port's new entry points."""
import csv
import json
import re
import shutil
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import video_caption_tpu.utils as jutils
import video_caption_tpu_torch.utils as utils
from video_caption_tpu.ops.temporal_pool import temporal_mean_pool as jax_pool
from video_caption_tpu.scripts import check_coverage as jcoverage
from video_caption_tpu.scripts import extract_frames as jextract
from video_caption_tpu.scripts import msvd_fetch_youtube as jfetch
from video_caption_tpu.scripts import plot_results as jplot
from video_caption_tpu.scripts import prepare_msrvtt as jmsrvtt
from video_caption_tpu.scripts import prepare_msvd as jmsvd
from video_caption_tpu.tools import human_eval as jhuman
from video_caption_tpu_torch.ops import temporal_mean_pool
from video_caption_tpu_torch.scripts import (check_coverage, extract_frames, msvd_fetch_youtube,
                                             plot_results, prepare_msrvtt, prepare_msvd)
from video_caption_tpu_torch.tools import batch_infer, human_eval


def _write_video(path, frames, seed, size=(48, 40), fps=8):
    rng = np.random.RandomState(seed)
    fourcc = "MJPG" if path.suffix == ".avi" else "mp4v"
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), fps, size)
    for i in range(frames):
        img = np.zeros((size[1], size[0], 3), np.uint8) + np.uint8(i * 9)
        img[:, :, i % 3] = rng.randint(0, 255, (size[1], size[0]), np.uint8)
        writer.write(img)
    writer.release()
    return path


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    root = tmp_path_factory.mktemp("videos")
    for name, frames, seed in (("vidA", 12, 1), ("vidB", 7, 2), ("vidC", 16, 3)):
        _write_video(root / f"{name}.avi", frames, seed)
    (root / "notes.txt").write_text("not a video")
    return root


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def _prepared(root):
    """({relative path: bytes} of the frames under ``root``, {relative path:
    the records} of its annotation files, each frames_dir relative to
    ``root``)."""
    tree = _tree(root)
    anns = {}
    for k in tree:
        if k.endswith("annotations.json"):
            anns[k] = json.loads(tree[k])
            for r in anns[k]:
                r["frames_dir"] = str(Path(r["frames_dir"]).relative_to(root))
    return {k: v for k, v in tree.items() if k.endswith(".jpg")}, anns


def test_extract_frames_matches(videos, tmp_path):
    out = {}
    for mod, name in ((jextract, "jax"), (extract_frames, "port")):
        res = mod.extract_all(str(videos), str(tmp_path / name), fps=2, workers=2)
        out[name] = (sorted(res), _tree(tmp_path / name))
        # a second pass skips every video that has frames (only_missing)
        assert sorted(mod.extract_all(str(videos), str(tmp_path / name), fps=2)) == \
            [(v, -1) for v in ("vidA", "vidB", "vidC")]
    assert out["port"] == out["jax"]
    assert all(n > 0 for _, n in out["port"][0]) and len(out["port"][1]) > 3
    assert extract_frames.main(["--videos_dir", str(videos), "--out_root",
                                str(tmp_path / "cli")]) == 0
    assert _tree(tmp_path / "cli") == out["jax"][1]


def test_prepare_msvd_matches(videos, tmp_path):
    ann = tmp_path / "annotations.txt"
    ann.write_text("vidA a man is riding a horse\nvidA a man rides\n\nvidB a dog runs\n"
                   "vidC two cats play\nvidD no video for this one\nvidC\n")
    assert prepare_msvd.parse_annotations_txt(str(ann)) == jmsvd.parse_annotations_txt(str(ann))
    for total, num in ((0, 4), (1, 4), (5, 1), (3, 8), (100, 7), (16, 4)):
        assert prepare_msvd.uniform_bin_indices(total, num) == jmsvd.uniform_bin_indices(total, num)
    ids = [f"v{i}" for i in range(23)]
    assert prepare_msvd.default_split(ids) == jmsvd.default_split(ids)
    assert prepare_msvd.default_split(ids[:3]) == jmsvd.default_split(ids[:3])
    out = {}
    for mod, name in ((jmsvd, "jax"), (prepare_msvd, "port")):
        counts = mod.prepare(str(videos), str(ann), str(tmp_path / name), num_frames=4,
                             image_size=32)
        out[name] = (counts, *_prepared(tmp_path / name))
    assert out["port"] == out["jax"]
    assert sum(out["port"][0].values()) == 3 and len(out["port"][1]) == 12


def test_prepare_msvd_hf_variant_matches(tmp_path):
    """The HF-datasets loop with an injected loader and reader (no dataset
    library, no video decoder): the same frames and records."""
    rng = np.random.RandomState(9)
    clips = {f"clip{i}": [Image.fromarray(rng.randint(0, 255, (20, 24, 3), np.uint8))
                          for _ in range(3 + i)] for i in range(3)}
    examples = {"train": [{"video_id": "clip0", "video": {"path": "clip0"}, "sentences": ["A Dog."]},
                          {"video_id": "clip1", "video": "clip1", "captions": [" Two cats ", ""]},
                          {"id": "clip2", "video_path": "clip2", "sentence": "x"},
                          {"video_id": "nocap", "video": "clip0"},
                          {"video_id": "bad", "nothing": 1, "sentences": ["y"]}],
                "test": [{"video_id": "clip2", "video": "clip2", "texts": ["Z"]}]}

    def reader(path, num):
        frames = clips[path]
        return [frames[i] for i in prepare_msvd.uniform_bin_indices(len(frames), num)]

    out = {}
    for mod, name in ((jmsvd, "jax"), (prepare_msvd, "port")):
        counts = mod.prepare_hf("x", str(tmp_path / name), num_frames=2, image_size=16,
                                reader=reader, loader=lambda _: examples)
        out[name] = (counts, *_prepared(tmp_path / name))
    assert out["port"] == out["jax"] and out["port"][0] == {"train": 3, "test": 1}


def test_prepare_msrvtt_matches(videos, tmp_path):
    info = tmp_path / "videodatainfo.json"
    info.write_text(json.dumps({
        "videos": [{"video_id": "vidA", "split": "train", "category": 3},
                   {"video_id": "vidB", "split": "validate"},
                   {"video_id": "vidC", "split": "test"}, {"video_id": "gone", "split": "train"}],
        "sentences": [{"video_id": "vidA", "caption": "a man rides"},
                      {"video_id": "vidC", "caption": "cats play"},
                      {"video_id": "vidA", "caption": "a horse runs"}]}))
    assert prepare_msrvtt.parse_videodatainfo(str(info)) == jmsrvtt.parse_videodatainfo(str(info))
    out = {}
    for mod, name in ((jmsrvtt, "jax"), (prepare_msrvtt, "port")):
        counts = mod.prepare(str(info), str(videos), str(tmp_path / name), num_frames=3,
                             image_size=32)
        out[name] = (counts, *_prepared(tmp_path / name))
    assert out["port"] == out["jax"] and out["port"][0] == {"train": 1, "val": 1, "test": 1}


def _frames(d, n, seed, name="frame_{:05d}.jpg"):
    d.mkdir(parents=True)
    rng = np.random.RandomState(seed)
    for i in range(n):
        Image.fromarray(rng.randint(0, 255, (8, 8, 3), np.uint8)).save(d / name.format(i))


def test_check_coverage_and_repair_match(tmp_path):
    frames = tmp_path / "frames"
    _frames(frames / "vid_one", 2, 1)
    _frames(frames / "vid_two", 3, 2)
    _frames(frames / "vid_three", 1, 3)
    (frames / "vid_empty").mkdir()
    records = [{"video_id": "vid_one", "frames_dir": str(frames / "vid_one")},
               {"video_id": "vid_two", "frames_dir": str(tmp_path / "moved" / "vid_two")},
               {"video_id": "vid_thre", "frames_dir": ""},
               {"video_id": "vid_empty", "frames_dir": str(frames / "vid_empty")},
               {"video_id": "nothing_like_it"}]
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps(records))
    got = check_coverage.check_coverage(str(ann))
    assert got == jcoverage.check_coverage(str(ann))
    assert got == (0.2, ["vid_two", "vid_thre", "vid_empty", "nothing_like_it"])
    for fuzzy in (True, False):
        stats = [mod.repair_annotations(str(ann), str(frames), str(tmp_path / f"{name}.json"),
                                        fuzzy=fuzzy)
                 for mod, name in ((jcoverage, "jax"), (check_coverage, "port"))]
        assert stats[0] == stats[1]
        assert (tmp_path / "jax.json").read_bytes() == (tmp_path / "port.json").read_bytes()
    assert stats[1] == {"kept": 2, "patched": 1, "dropped": 3}
    for mod, name in ((jcoverage, "jax"), (check_coverage, "port")):
        assert mod.main(["--ann_path", str(ann), "--repair_frames_root", str(frames),
                         "--out", str(tmp_path / f"{name}_cli.json")]) == 0
    assert (tmp_path / "port_cli.json").read_bytes() == (tmp_path / "jax_cli.json").read_bytes()
    for mod, name in ((jcoverage, "jax"), (check_coverage, "port")):
        _frames(tmp_path / name / "odd", 3, 4, name="img{:03d}.jpg")
        assert mod.alias_frame_names(str(tmp_path / name / "odd")) == 3
        assert mod.alias_frame_names(str(tmp_path / name / "odd")) == 0
    assert _tree(tmp_path / "jax" / "odd") == _tree(tmp_path / "port" / "odd")


def test_plot_results_write_the_same_pngs(tmp_path):
    run = tmp_path / "run"
    run.mkdir()
    (run / "events.csv").write_text("step,loss\n" + "".join(f"{i},{3 - i * 0.1}\n"
                                                            for i in range(10)))
    (run / "val.csv").write_text("step,val_loss\n5,2.7\n10,2.4\n")
    summary = {s: {"mean": m} for s, m in (("Preprocess_Latency", 1.5), ("ViT_Latency", 4.0),
                                           ("Cross_Modal_Alignment", 0.3),
                                           ("GPT2_Latency", 9.0))}
    (tmp_path / "summary.json").write_text(json.dumps(summary))
    pngs = {}
    for mod, name in ((jplot, "jax"), (plot_results, "port")):
        d = tmp_path / name
        d.mkdir()
        paths = [mod.plot_loss(str(run), str(d / "loss.png")),
                 mod.plot_bleu_compare({"corpus_bleu_a": 0.3, "corpus_bleu_b": 0.1,
                                        "num_samples": 4}, str(d / "bleu.png")),
                 mod.plot_benchmark_stages(str(tmp_path / "summary.json"), str(d / "st.png"))]
        assert paths == [str(d / "loss.png"), str(d / "bleu.png"), str(d / "st.png")]
        assert mod.main(["--run_dir", str(run)]) == 0
        pngs[name] = {**_tree(d), "run_loss": (run / "loss.png").read_bytes()}
    assert pngs["port"] == pngs["jax"]
    assert all(v.startswith(b"\x89PNG") for v in pngs["port"].values())


def test_human_eval_matches(tmp_path, monkeypatch):
    captions = ["A man rides.", "", "Two dogs are playing in the snow near a red car today.",
                "A woman is slicing a tomato in a kitchen with a knife and a board now "
                "while talking.", "A cat sits.", "People dance on a stage."]
    rows = [{"video_id": f"v{i}", "S1": c, "S2": c, "S3": c, "best_key": "S1", "best_text": c,
             "latency_s": 0.1 * i, "ref_caption": "ref"} for i, c in enumerate(captions)]
    results = tmp_path / "rows.csv"
    with results.open("w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=batch_infer.COLUMNS)
        writer.writeheader()
        writer.writerows(rows)
    for c in captions + ["x " * 200]:
        assert human_eval.bucket_of(c) == jhuman.bucket_of(c)
    for n, seed in ((30, 0), (2, 5), (4, 1)):
        assert human_eval.sample_questionnaire(rows, n, seed) == \
            jhuman.sample_questionnaire(rows, n, seed)
    ratings = tmp_path / "ratings.csv"
    ratings.write_text("video_id,caption,Fluency,Relevance,Specificity,Overall\n"
                       "v0,a,5,4,3,\nv2,b,2,x,5,1\nv3,c,5,5,5,5\n")
    monkeypatch.chdir(tmp_path)
    out = {}
    for mod, name in ((jhuman, "jax"), (human_eval, "port")):
        assert mod.main(["--results_csv", str(results), "--out", f"{name}/q.csv",
                         "--plot_ratings", str(ratings)]) == 0
        chart = tmp_path / "outputs" / "human_eval_ratings.png"
        out[name] = ((tmp_path / name / "q.csv").read_bytes(), chart.read_bytes(),
                     (tmp_path / mod.plot_ratings(str(ratings), f"{name}/r.png")).read_bytes())
        chart.unlink()
    assert out["port"] == out["jax"]
    with (tmp_path / "port" / "q.csv").open() as fh:
        questionnaire = list(csv.DictReader(fh))
    assert len(questionnaire) == 5 and len({r["video_id"] for r in questionnaire}) == 5


def test_msvd_fetch_youtube_local_stages(tmp_path, monkeypatch):
    """parse_clip_id, clip_video (ffmpeg where there is one: both packages
    cut the same clip; else both report its absence) and make_frames through
    the port's retrieval.query_video; the fetch needs the network and is
    not run."""
    for vid in ("abc_DEF-12_5_10", "x_1_2", "nope", "a_b_c", "_1_2", "id__3_4"):
        assert msvd_fetch_youtube.parse_clip_id(vid) == jfetch.parse_clip_id(vid)
    assert msvd_fetch_youtube.parse_clip_id("abc_DEF-12_5_10") == ("abc_DEF-12", 5, 10)
    full = _write_video(tmp_path / "full.avi", 24, 5)
    clips = [mod.clip_video(full, 0, 1, tmp_path / name / "clip.avi")
             for mod, name in ((jfetch, "jax"), (msvd_fetch_youtube, "port"))]
    assert clips[0] == clips[1] == (shutil.which("ffmpeg") is not None)
    if clips[1]:
        assert (tmp_path / "jax" / "clip.avi").read_bytes() == \
            (tmp_path / "port" / "clip.avi").read_bytes()
    counts = [mod.make_frames(full, tmp_path / f"frames_{name}", fps=4)
              for mod, name in ((jfetch, "jax"), (msvd_fetch_youtube, "port"))]
    assert counts[0] == counts[1] > 0
    assert _tree(tmp_path / "frames_jax") == _tree(tmp_path / "frames_port")
    # ids that do not parse are skipped before any fetch is tried
    monkeypatch.setattr(msvd_fetch_youtube, "fetch_full_video",
                        lambda *a: pytest.fail("fetch tried"))
    assert msvd_fetch_youtube.main(["--video_ids", "nope", "also-not"]) == 0


def test_temporal_mean_pool_matches_jax():
    x = np.random.RandomState(0).randn(3, 5, 7).astype(np.float32)
    got = temporal_mean_pool(torch.from_numpy(x))
    assert got.shape == (3, 7) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_pool(jnp.asarray(x))), atol=1e-6,
                               rtol=0)
    for shape in ((3, 5), (2, 3, 4, 5)):
        with pytest.raises(ValueError, match=r"expected \[B,T,D\]"):
            temporal_mean_pool(torch.zeros(shape))
        with pytest.raises(ValueError, match=r"expected \[B,T,D\]"):
            jax_pool(jnp.zeros(shape))


def test_utils_exports_the_jax_names_less_the_compile_cache():
    def public(mod):
        return {n for n in vars(mod) if not n.startswith("_")} - {"annotations"}

    assert public(utils) == public(jutils) - {"enable_compilation_cache"}
    assert utils.RuntimeNotReady.__module__ == "video_caption_tpu_torch.env"
    import importlib.util

    if importlib.util.find_spec("httpx") is not None:
        utils.assert_frontend_runtime_ready()
    else:
        with pytest.raises(utils.RuntimeNotReady, match="httpx"):
            utils.assert_frontend_runtime_ready()


CLIS = ["tools.hybrid_infer", "tools.caption_fallback", "tools.human_eval",
        "scripts.extract_frames", "scripts.prepare_msvd", "scripts.prepare_msrvtt",
        "scripts.check_coverage", "scripts.plot_results", "scripts.msvd_fetch_youtube"]


@pytest.mark.parametrize("name", CLIS)
def test_new_cli_parses_the_jax_flags(name, capsys):
    """Each new entry point imports, prints its help, and takes every flag
    of its JAX counterpart (the tools that run a model add ``--device``)."""
    import importlib

    flags = {}
    for package in ("video_caption_tpu", "video_caption_tpu_torch"):
        mod = importlib.import_module(f"{package}.{name}")
        with pytest.raises(SystemExit) as exit_:
            mod.main(["--help"])
        assert exit_.value.code == 0
        flags[package] = set(re.findall(r"--[\w-]+", capsys.readouterr().out))
    extra = {"--device"} if name in ("tools.hybrid_infer", "tools.caption_fallback") else set()
    assert flags["video_caption_tpu_torch"] == flags["video_caption_tpu"] | extra
