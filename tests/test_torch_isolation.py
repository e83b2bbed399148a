"""The port imports nothing of the JAX package and no JAX (nor pydantic or
fastapi, which the card's machine lacks), and its own copies
of the reference's JAX-free modules (config, datatypes, tokenizer, presets,
post-processing, frame loading, the training data loader, the benchmark's
report writers) behave as the originals do."""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from video_caption_tpu import config as jconfig
from video_caption_tpu import datatypes as jdatatypes
from video_caption_tpu.data import data_loader as jdata
from video_caption_tpu.decode import presets as jpresets
from video_caption_tpu.decode import tokenizer as jtokenizer
from video_caption_tpu.postprocessing import candidate_ranker as jranker
from video_caption_tpu.postprocessing import text_cleaner as jcleaner
from video_caption_tpu.preprocessing import frame_loader as jframes
from video_caption_tpu_torch import config, datatypes
from video_caption_tpu_torch.data import data_loader
from video_caption_tpu_torch.decode import presets, tokenizer
from video_caption_tpu_torch.postprocessing import candidate_ranker, text_cleaner
from video_caption_tpu_torch.preprocessing import frame_loader

REPO = Path(__file__).resolve().parents[1]
GOLDEN = json.loads((Path(__file__).parent / "golden_clean_text.json").read_text())
STRINGS = ["A man is riding a horse.", "  two dogs\tplay in the snow  ", "Ünïcödé — ok? 123",
           ""]


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import video_caption_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "for name in ('training.loop', 'training.mapper_trainer', 'training.optim',\n"
        "             'training.checkpoint', 'models.align', 'models.toy', 'ops.fused_pool',\n"
        "             'data.data_loader', 'cli.train_caption_mapper', 'cli.train_full',\n"
        "             'cli.train', 'cli.train_decoder_only', 'cli.profile_training',\n"
        "             'decode.unified', 'server.schemas', 'server.settings',\n"
        "             'server.stdlib_server', 'server.services.batching_queue',\n"
        "             'server.services.inference_service', 'server.services.model_registry',\n"
        "             'server.services.task_manager', 'cli.serve', 'env', 'memory',\n"
        "             'bench.report', 'bench.benchmark', 'bench.profile', 'bench.probes',\n"
        "             'bench.roofline', 'bench.serving_load', 'bench.accuracy_alignment',\n"
        "             'bench.driver', 'cli.check_env'):\n"
        "    assert p.__name__ + '.' + name in names, name\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
        "'video_caption_tpu', 'pydantic', 'fastapi', 'uvicorn', 'starlette'))\n"
        "assert not bad, bad\n"
        "assert len(names) > 20, names\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=300)


def test_report_copy_is_the_jax_packages_file():
    """bench/report.py imports nothing of either package: the copy is the
    original, byte for byte."""
    assert (REPO / "video_caption_tpu_torch/bench/report.py").read_bytes() == \
        (REPO / "video_caption_tpu/bench/report.py").read_bytes()


def test_config_copy_has_the_same_fields_and_defaults():
    for port_cls, jax_cls in ((config.InferenceConfig, jconfig.InferenceConfig),
                              (config.CompileConfig, jconfig.CompileConfig),
                              (config.MemoryConfig, jconfig.MemoryConfig),
                              (config.MeshConfig, jconfig.MeshConfig)):
        assert dataclasses.asdict(port_cls()) == dataclasses.asdict(jax_cls())
    assert dataclasses.asdict(config.serving_inference_config(num_frames=16)) == \
        dataclasses.asdict(jconfig.serving_inference_config(num_frames=16))
    assert config.default_inference_config().cache_key() == \
        jconfig.default_inference_config().cache_key()


def test_config_copy_reads_the_same_environment(monkeypatch):
    monkeypatch.setenv("VIDEO_CAPTION_PALLAS_DECODE", "1")
    monkeypatch.setenv("VIDEO_CAPTION_PALLAS_DECODE_LAYER", "true")
    assert config._env_bool("VIDEO_CAPTION_PALLAS_DECODE", False) is True
    assert config._env_bool("VIDEO_CAPTION_PALLAS_DECODE_LAYER", False) == \
        jconfig._env_bool("VIDEO_CAPTION_PALLAS_DECODE_LAYER", False)


@pytest.mark.parametrize("raw,expected", GOLDEN)
def test_clean_text_copy_matches_golden(raw, expected):
    assert text_cleaner.clean_text(raw) == expected == jcleaner.clean_text(raw)


def test_ranker_copy_matches():
    cands = [("S1", "a man is riding a horse"), ("S2", "A dog."), ("S3", "")]
    assert candidate_ranker.select_best(cands) == jranker.select_best(cands)
    for _, text in cands:
        assert candidate_ranker.score_sentence(text) == jranker.score_sentence(text)


@pytest.mark.parametrize("text", STRINGS)
def test_tokenizer_copy_matches(text):
    port, ref = tokenizer.get_tokenizer(), jtokenizer.get_tokenizer()
    assert type(port).__name__ == type(ref).__name__
    ids = port.encode(text)
    assert ids == ref.encode(text)
    assert port.decode(ids, skip_special_tokens=True) == ref.decode(ids, skip_special_tokens=True)
    assert (port.eos_token_id, port.pad_token_id, port.bos_token_id) == \
        (ref.eos_token_id, ref.pad_token_id, ref.bos_token_id)


@pytest.mark.parametrize("name", jpresets.preset_names() + ("unknown", ""))
def test_preset_copy_matches(name):
    assert presets.preset_to_kwargs(name) == jpresets.preset_to_kwargs(name)


def test_datatypes_copy_matches():
    kw = dict(s1="A man.", s2="A dog runs.", s3="")
    port = datatypes.InferenceResult(candidates=datatypes.CaptionCandidates(**kw),
                                     best_key="S2", best_text="A dog runs.")
    ref = jdatatypes.InferenceResult(candidates=jdatatypes.CaptionCandidates(**kw),
                                     best_key="S2", best_text="A dog runs.")
    assert port.to_api_dict() == ref.to_api_dict()


def test_frame_loader_copy_matches(tmp_path):
    rng = np.random.RandomState(4)
    for i in range(5):
        Image.fromarray(rng.randint(0, 255, (40, 48, 3), np.uint8)).save(
            tmp_path / f"frame_{i:05d}.jpg")
    files = frame_loader.list_frames(tmp_path)
    assert files == jframes.list_frames(tmp_path)
    assert frame_loader.sample_frame_paths(files, 3) == jframes.sample_frame_paths(files, 3)
    np.testing.assert_array_equal(frame_loader.load_image_u8(files[0], 32),
                                  jframes.load_image_u8(files[0], 32))


def _frame_dirs(root, videos, frames, seed):
    rng = np.random.RandomState(seed)
    records = []
    for v in range(videos):
        d = root / f"video{v}"
        d.mkdir()
        for i in range(frames + v):          # frame counts below and above num_frame
            Image.fromarray(rng.randint(0, 255, (40, 48, 3), np.uint8)).save(
                d / f"frame_{i:05d}.jpg")
        records.append({"video_id": f"v{v}", "frames_dir": str(d),
                        "captions": [f"a man is riding horse {v}", "two dogs play in the snow"]})
    records.append({"video_id": "empty", "frames_dir": str(root / "missing"), "captions": ["x"]})
    return records


@pytest.mark.parametrize("uint8_pixels,prefetch", [(False, 0), (True, 2)])
def test_data_loader_copy_yields_the_same_batches(tmp_path, uint8_pixels, prefetch):
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps(_frame_dirs(tmp_path, 3, 3, seed=5)))
    kw = dict(batch_size=2, max_len=12, num_frame=4, image_size=32, uint8_pixels=uint8_pixels,
              num_workers=prefetch)
    port = list(data_loader.build_dataloader(str(ann), tokenizer.get_tokenizer(), **kw))
    ref = list(jdata.build_dataloader(str(ann), jtokenizer.get_tokenizer(), **kw))
    assert len(port) == len(ref) == 3
    for a, b in zip(port, ref):
        assert a.keys() == b.keys() and a["video_id"] == b["video_id"]
        for key in ("video", "caption_ids", "attention_mask"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


def test_data_loader_prefetch_ends_with_its_iterator(tmp_path):
    """A consumer that stops early leaves no prefetch thread reading frames,
    and a frame that cannot be read raises in the consumer."""
    import threading

    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps(_frame_dirs(tmp_path, 3, 3, seed=5)))
    loader = data_loader.build_dataloader(str(ann), tokenizer.get_tokenizer(), batch_size=1,
                                          max_len=12, num_frame=4, image_size=32,
                                          shuffle=False, num_workers=1)
    before = threading.active_count()
    for _ in loader:
        assert threading.active_count() == before + 1
        break
    assert threading.active_count() == before
    (tmp_path / "video1" / "frame_00000.jpg").write_bytes(b"not a jpeg")
    with pytest.raises(Exception, match="cannot identify image file"):
        list(loader)
    assert threading.active_count() == before
