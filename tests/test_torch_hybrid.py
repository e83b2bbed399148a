"""Quality-gated hybrid inference (tools/hybrid_infer.py) and its fallback
captioners (tools/caption_fallback.py): the port against the JAX package on
the CPU, at the conftest's tiny geometry in f32 with beam-only presets (the
sampled preset's streams cannot match across the packages, PARITY.md §6).
``hybrid_caption`` of both packages gives the identical dict when the
engine's best passes the gate, when the fallback is taken and when the
fallback raises; a tiny random BLIP saved locally captions a directory as
the JAX module's loader does."""
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_engine import WordTok, _engines
from video_caption_tpu.tools import caption_fallback as jfallback
from video_caption_tpu.tools import hybrid_infer as jhybrid
from video_caption_tpu_torch.tools import caption_fallback, hybrid_infer

BEAM_PRESETS = dict(preset1="precise", preset2="detailed", preset3="precise",
                    prompt3="Another prompt:")
GOOD = "A man is riding a horse in the park."


class JunkTok(WordTok):
    """WordTok whose decodes carry a word the gate takes for boilerplate
    (the engine's cleaner keeps it)."""

    def decode(self, ids, skip_special_tokens=True):
        return "youtube " + super().decode(ids, skip_special_tokens)


class Stub:
    """A fallback captioner that counts its calls and answers ``text``, or
    raises ``error``."""
    name = "stub-captioner"

    def __init__(self, text=GOOD, error=None):
        self.text, self.error, self.calls = text, error, []

    def __call__(self, frames_dir):
        self.calls.append(frames_dir)
        if self.error is not None:
            raise self.error
        return self.text


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("hybrid")
    rng = np.random.RandomState(17)
    for i in range(4):
        Image.fromarray(rng.randint(0, 255, (40, 48, 3), np.uint8)).save(d / f"frame_{i:05d}.jpg")
    return str(d)


@pytest.fixture(scope="module")
def engines(tiny_cfg, tiny_params):
    return _engines(tiny_cfg, tiny_params, **BEAM_PRESETS)


@pytest.mark.parametrize("case", ["gate_passes", "fallback_taken", "fallback_raises"])
def test_hybrid_caption_gives_the_jax_packages_dict(engines, frames_dir, case):
    jax_engine, port = engines
    tok = WordTok() if case == "gate_passes" else JunkTok()
    jax_engine.tokenizer = port.tokenizer = tok
    error = RuntimeError("no weights here") if case == "fallback_raises" else None
    stubs = Stub(error=error), Stub(error=error)
    want = jhybrid.hybrid_caption(frames_dir, engine=jax_engine, fallback=stubs[0])
    got = hybrid_infer.hybrid_caption(frames_dir, engine=port, fallback=stubs[1])
    assert got == want
    assert len(stubs[0].calls) == len(stubs[1].calls) == (case != "gate_passes")
    best_bad, _ = hybrid_infer.is_bad_caption(got["BEST"]["text"])
    if case == "gate_passes":
        assert got["USED"] == {"source": "ours", "detail": got["BEST"]["key"],
                               "fallback_reason": ""} and not best_bad
    elif case == "fallback_taken":
        assert got["USED"] == {"source": "fallback", "detail": Stub.name,
                               "fallback_reason": "boilerplate"}
        assert got["BEST"]["text"] == GOOD
    else:
        assert got["USED"]["source"] == "ours" and best_bad
        assert got["USED"]["fallback_reason"] == "fallback_failed:no weights here"
    assert all(got[k] for k in ("S1", "S2", "S3"))


def test_hybrid_without_a_fallback_keeps_our_result(engines, frames_dir):
    jax_engine, port = engines
    jax_engine.tokenizer = port.tokenizer = JunkTok()
    got = hybrid_infer.hybrid_caption(frames_dir, engine=port)
    assert got == jhybrid.hybrid_caption(frames_dir, engine=jax_engine)
    assert got["USED"] == {"source": "ours", "detail": got["BEST"]["key"], "fallback_reason": ""}


@pytest.mark.parametrize("text", ["", "   ", "short", "see www.example.com now", "Click here now",
                                  "A 1 2 3 4 5 6 7 8", "a dog dog dog runs", "Whooooooa there",
                                  "A man is riding a horse.", "Ünïcödé words in a row"])
def test_gate_and_selection_match(text):
    assert hybrid_infer.is_bad_caption(text) == jhybrid.is_bad_caption(text)
    result = {"S1": GOOD, "S2": text, "S3": "youtube clip"}
    assert hybrid_infer.pick_best_from_ours(result) == jhybrid.pick_best_from_ours(result)


def test_selection_helpers_match():
    cands = ["a man rides a horse", "A man rides a horse.", "two dogs play in the snow today",
             "visit www.x.com", "copyright 2020 someone", "the the cat sits", "", "ok"]
    assert caption_fallback.pick_best(cands) == jfallback.pick_best(cands)
    assert caption_fallback.select_best_pt(cands) == jfallback.select_best_pt(cands)
    assert caption_fallback.select_best_pt(["www.x.com"]) == "Someone is in the scene."
    for c in cands:
        assert caption_fallback.clean_text_vote(c) == jfallback.clean_text_vote(c)
        assert caption_fallback.clean_caption_pt(c) == jfallback.clean_caption_pt(c)
        assert caption_fallback.score_sentence_pt(c) == jfallback.score_sentence_pt(c)


def test_frame_sampling_and_batch_match(tmp_path):
    rng = np.random.RandomState(3)
    for v, n in enumerate((1, 5, 12)):
        d = tmp_path / "frames" / f"vid{v}"
        d.mkdir(parents=True)
        for i in range(n):
            Image.fromarray(rng.randint(0, 255, (8, 8, 3), np.uint8)).save(d / f"frame_{i:05d}.jpg")
    (tmp_path / "frames" / "empty").mkdir()
    dirs = sorted((tmp_path / "frames").glob("vid*"))
    for d in dirs:
        assert caption_fallback._sample_three(d) == jfallback._sample_three(d)
        assert caption_fallback._sample_stride(d, 4) == jfallback._sample_stride(d, 4)
    assert caption_fallback.find_video_dirs(tmp_path / "frames") == dirs
    with pytest.raises(FileNotFoundError):
        caption_fallback._sample_three(tmp_path / "frames" / "empty")

    def captioner(frames_dir):
        return {"vid0": "", "vid1": "a dog runs"}.get(frames_dir.rsplit("/", 1)[-1],
                                                       "two dogs play in the snow in a park")

    outs = []
    for mod, name in ((jfallback, "jax"), (caption_fallback, "port")):
        rows = mod.run_batch(str(tmp_path / "frames"), str(tmp_path / name / "out.json"),
                             num_videos=5, emit_csv=True, captioner=captioner)
        outs.append((rows, (tmp_path / name / "out.json").read_bytes(),
                     (tmp_path / name / "out.csv").read_bytes()))
    assert outs[0] == outs[1]
    assert len(outs[1][0]) == 2


def test_fallbacks_keep_loading_at_call_time(monkeypatch, frames_dir, engines):
    """Building a fallback loads nothing; without transformers the first
    call raises, and hybrid_caption records it as the JAX package does."""
    import sys

    monkeypatch.setitem(sys.modules, "transformers", None)
    for make in (caption_fallback.make_blip_fallback, caption_fallback.make_vit_gpt2_fallback):
        fb = make("no/such-model", device="cpu")
        assert fb.name == "no/such-model"
        with pytest.raises(ImportError):
            fb(frames_dir)
    jax_engine, port = engines
    jax_engine.tokenizer = port.tokenizer = JunkTok()
    got = hybrid_infer.hybrid_caption(frames_dir, port,
                                      caption_fallback.make_blip_fallback(device="cpu"))
    assert got == jhybrid.hybrid_caption(frames_dir, jax_engine, jfallback.make_blip_fallback())
    assert got["USED"]["fallback_reason"].startswith("fallback_failed:")


def _tiny_blip(path):
    """A random BLIP of a few thousand weights and a local vocab for its
    tokenizer, saved to ``path`` (nothing is downloaded)."""
    from transformers import (BertTokenizer, BlipConfig, BlipForConditionalGeneration,
                              BlipImageProcessor, BlipProcessor)

    words = "a man woman dog cat is are the on in with red blue runs walks plays street".split()
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "[DEC]"] + words
    path.mkdir()
    (path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    tok = BertTokenizer(str(path / "vocab.txt"), bos_token="[DEC]")
    torch.manual_seed(0)
    cfg = BlipConfig(
        text_config=dict(vocab_size=len(vocab), hidden_size=32, intermediate_size=64,
                         num_hidden_layers=2, num_attention_heads=2, max_position_embeddings=64,
                         bos_token_id=5, pad_token_id=0, sep_token_id=3, eos_token_id=3),
        vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                           num_attention_heads=2, image_size=32, patch_size=16),
        projection_dim=32)
    BlipForConditionalGeneration(cfg).eval().save_pretrained(path)
    BlipProcessor(BlipImageProcessor(size={"height": 32, "width": 32}), tok).save_pretrained(path)


def test_blip_fallback_from_a_local_model_matches_jax(tmp_path, frames_dir, engines, monkeypatch):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    monkeypatch.setenv("USE_TF", "0")
    pytest.importorskip("transformers")
    _tiny_blip(tmp_path / "blip")
    model = str(tmp_path / "blip")
    # the default generation, and one without repeated words (a caption
    # the gate passes)
    for gen in (None, dict(num_beams=3, max_new_tokens=12, no_repeat_ngram_size=1)):
        port_fb = caption_fallback.make_blip_fallback(model, gen, device="cpu")
        jax_fb = jfallback.make_blip_fallback(model, gen)
        got, want = port_fb(frames_dir), jax_fb(frames_dir)
        assert got == want and got
        assert caption_fallback.caption_from_frames_dir(frames_dir, model=model, gen_kwargs=gen,
                                                        device="cpu") == want
    assert not hybrid_infer.is_bad_caption(got)[0]
    # through hybrid_caption: candidates that fail the gate take the BLIP caption
    jax_engine, port = engines
    jax_engine.tokenizer = port.tokenizer = JunkTok()
    res = hybrid_infer.hybrid_caption(frames_dir, engine=port, fallback=port_fb)
    assert res == jhybrid.hybrid_caption(frames_dir, engine=jax_engine, fallback=jax_fb)
    assert res["USED"] == {"source": "fallback", "detail": model, "fallback_reason": "boilerplate"}
    assert res["BEST"]["text"] == got
