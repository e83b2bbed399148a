"""The port's quality entry points (video_caption_tpu_torch/eval) against the
JAX package's, on the CPU: BLEU scores equal to the JAX module's (sacrebleu
and NLTK there, plain Python here) on fixed strings; eval_compare's
hypotheses identical to the JAX module's at its shared policy (5 beams, 32
tokens) on the same carried-over weights; the same results.csv and
summary.txt; the ablation grid's rows equal on its deterministic points."""
import csv
import json

import numpy as np
import pytest
from PIL import Image

from test_torch_aot import WordTok, port_cfg, port_params  # noqa: F401
from video_caption_tpu.config import default_inference_config as jax_default_config
from video_caption_tpu.engine import InferenceEngine as JaxEngine
from video_caption_tpu.eval import ablate_decode as jablate
from video_caption_tpu.eval import bleu as jbleu
from video_caption_tpu.eval import eval_compare as jcompare
from video_caption_tpu_torch.config import default_inference_config
from video_caption_tpu_torch.engine import InferenceEngine
from video_caption_tpu_torch.eval import ablate_decode, bleu, eval_compare

HYPS = ["a man is riding a horse.", "two dogs play in the snow", "", "A cat, on a sofa!",
        "the 3.5 kg box - 1-2 &amp; more", "people are dancing dancing dancing on a stage"]
REFS = [["a man rides a horse", "a man is riding a brown horse."],
        ["dogs are playing in the snow"],
        ["a child plays the guitar", "a kid is playing guitar", "someone plays music"],
        ["a cat is sleeping on a sofa", "A cat sleeps on a couch."],
        ["a 3.5 kg box & more", "the box weighs 3.5 kg"],
        ["people are dancing on a stage"]]


@pytest.mark.parametrize("fn", ["corpus_bleu", "nltk_bleu4"])
@pytest.mark.parametrize("rows", [slice(None), slice(0, 1), slice(2, 3), slice(3, 6)])
def test_corpus_scores_equal_the_jax_module(fn, rows):
    got = getattr(bleu, fn)(HYPS[rows], REFS[rows])
    assert got == getattr(jbleu, fn)(HYPS[rows], REFS[rows])
    assert isinstance(got, float)


@pytest.mark.parametrize("i", range(len(HYPS)))
def test_sentence_bleu1_equals_the_jax_module(i):
    assert bleu.sentence_bleu1(HYPS[i], REFS[i]) == jbleu.sentence_bleu1(HYPS[i], REFS[i])


def test_evaluate_pairs_and_regrouping_equal_the_jax_module():
    results = [{"hyp": h, "refs": r} for h, r in zip(HYPS, REFS)]
    assert bleu.evaluate_pairs(results) == jbleu.evaluate_pairs(results)
    assert bleu.regroup_references(REFS) == jbleu.regroup_references(REFS)
    assert bleu.tokenize_13a("A cat, on a sofa!") == ["A", "cat", ",", "on", "a", "sofa", "!"]


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """Three annotated videos of 3 frames and one record with no frames."""
    root = tmp_path_factory.mktemp("eval")
    rng = np.random.RandomState(12)
    records = []
    for v in range(3):
        d = root / f"video{v}"
        d.mkdir()
        for i in range(3):
            Image.fromarray(rng.randint(0, 255, (32, 32, 3), np.uint8)).save(
                d / f"frame_{i:05d}.jpg")
        records.append({"video_id": f"video{v}", "frames_dir": str(d),
                        "captions": REFS[v] if v != 1 else None, "caption": "dogs play"})
    records.insert(1, {"video_id": "empty", "frames_dir": str(root / "missing")})
    ann = root / "ann.json"
    ann.write_text(json.dumps(records))
    return ann


@pytest.fixture(scope="module")
def engines(tiny_cfg, tiny_params, port_params):  # noqa: F811
    """The JAX engine and the port's on the same weights, 2 frames."""
    jax_engine = JaxEngine(jax_default_config(ckpt="missing.pt", num_frames=2, image_size=32),
                           params=tiny_params, model_cfg=tiny_cfg)
    port = InferenceEngine(default_inference_config(ckpt="missing.pt", num_frames=2,
                                                    image_size=32),
                           params=port_params, model_cfg=port_cfg(tiny_cfg), device="cpu")
    jax_engine.tokenizer = port.tokenizer = WordTok()
    return jax_engine, port


def test_caption_split_equals_the_jax_module_at_five_beams(split, engines):
    jax_engine, port = engines
    want = jcompare.caption_split(str(split), "", num_frames=2, engine=jax_engine,
                                  image_size=32)
    got = eval_compare.caption_split(str(split), "", num_frames=2, engine=port, image_size=32)
    assert eval_compare.SHARED_DECODE == jcompare.SHARED_DECODE
    assert eval_compare.SHARED_DECODE["num_beams"] == 5
    assert len(got) == 3 and got == want
    assert all(r["hyp"] for r in got)


def test_compare_writes_the_jax_modules_files(split, engines, tmp_path, monkeypatch):
    """Both modules' compare over the same two sides (the JAX module's
    engines come in through its own caption_split): byte-identical
    results.csv and summary.txt."""
    jax_engine, port = engines
    real = jcompare.caption_split
    monkeypatch.setattr(jcompare, "caption_split",
                        lambda *a, **k: real(*a, **{**k, "engine": jax_engine}))
    want = jcompare.compare(str(split), "", "", str(tmp_path / "jax"), num_frames=2,
                            image_size=32)
    got = eval_compare.compare(str(split), "", "", str(tmp_path / "port"), num_frames=2,
                               image_size=32, engines=(port, port))
    assert got == want
    for name in ("results.csv", "summary.txt"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    with (tmp_path / "port" / "results.csv").open() as fh:
        assert next(csv.reader(fh)) == ["video_id", "hyp_a", "hyp_b", "bleu1_a", "bleu1_b",
                                        "ref0"]


def test_ablation_rows_equal_the_jax_module(split, engines, tmp_path, monkeypatch):
    """The grid's greedy and beam points (beams 1, 3, 5 at temperature 1):
    the same sorted rows and CSV as the JAX module over the same weights;
    a sampled point runs too."""
    jax_engine, port = engines
    import video_caption_tpu.engine as jengine

    monkeypatch.setattr(jengine, "InferenceEngine", lambda *a, **k: jax_engine)
    grid = {"num_beams": (1, 3, 5), "temperature": (1.0,), "top_p": (0.9,),
            "no_repeat_ngram_size": (2, 3)}
    want = jablate.ablate(str(split), str(tmp_path / "jax.csv"), limit=3, num_frames=2,
                          grid=grid, image_size=32)
    got = ablate_decode.ablate(str(split), str(tmp_path / "port.csv"), limit=3, num_frames=2,
                               grid=grid, image_size=32, engine=port)
    assert got == want and len(got) == 6
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    sampled = ablate_decode.ablate(str(split), str(tmp_path / "s.csv"), limit=2, num_frames=2,
                                   grid=dict(grid, num_beams=(1,), temperature=(0.8,),
                                             no_repeat_ngram_size=(3,)),
                                   image_size=32, engine=port)
    assert len(sampled) == 1 and 0.0 <= sampled[0]["corpus_bleu"] <= 100.0
    assert set(ablate_decode.DEFAULT_GRID) == set(jablate.DEFAULT_GRID)
