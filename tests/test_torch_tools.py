"""The port's tools (tools/) and the checkpoint repairs against the JAX
package, in f32 on the CPU at tiny geometry: the best-of scoring, the
batch tool's retry and CLIs, the stage-by-stage debugger and checkpoint
census, checkpoint directories (restore, metadata, refusal of another
geometry) and the engine's OOM guard. Weights cross as reference-format
``.pt`` files or through ``params_from_jax_numpy``."""
import csv
import dataclasses
import json
import logging
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from video_caption_tpu import config as jconfig
from video_caption_tpu import engine as jengine
from video_caption_tpu.models import caption_model as jcm
from video_caption_tpu.models.convert import save_torch_checkpoint as j_save_torch_checkpoint
from video_caption_tpu.tools import batch_bestof as jbestof
from video_caption_tpu.tools import debug_chain as jdebug
from video_caption_tpu.tools import quality_loop as jql
from video_caption_tpu.training import checkpoint as jckpt
from video_caption_tpu_torch import config as pconfig
from video_caption_tpu_torch import engine as pengine
from video_caption_tpu_torch.config import default_inference_config
from video_caption_tpu_torch.engine import InferenceEngine, load_params
from video_caption_tpu_torch.models import align as al
from video_caption_tpu_torch.models import vit as vt
from video_caption_tpu_torch.models.convert import params_from_jax_numpy
from video_caption_tpu_torch.tools import batch_bestof, batch_infer, debug_chain
from video_caption_tpu_torch.training import optim as topt
from video_caption_tpu_torch.training.checkpoint import (load_metadata, restore_params,
                                                         save_checkpoint)

from tests.test_torch_quality_loop import FRAMES, SIZE, TinyTok, _np, _port_cfg

CHAIN_TOL = 1e-5       # run_chain's emb, prefix and logits against JAX's
SENTENCES = ["A man is riding a horse in the street.", "this is a dog", "", "Subscribe to my "
             "channel", "two people are cooking food in a kitchen while a child plays with a "
             "ball near the table", "the video shows a cat", "It is the end!"]


@pytest.fixture(scope="module")
def anns(tmp_path_factory):
    return jql.make_synthetic_dataset(
        str(tmp_path_factory.mktemp("tools_data")), num_frames=FRAMES, image_size=SIZE,
        colors=2, shapes=1, motions=1, sizes=1, train_per_class=1, val_per_class=1)


@pytest.fixture(scope="module")
def tiny_pt(tiny_cfg, tiny_params, tmp_path_factory):
    """The tiny model as a reference-format .pt written by the JAX package."""
    path = tmp_path_factory.mktemp("tiny_pt") / "tiny.pt"
    j_save_torch_checkpoint(str(path), tiny_params, tiny_cfg, step=4, epoch=1, best_val=0.5)
    return str(path)


@pytest.fixture
def tiny_geometry(tiny_cfg, monkeypatch):
    """Both packages' default configuration at the tiny model's frames and
    size, and their engines' model configuration the tiny one: the tools
    build their configurations themselves."""
    for module in (pconfig, jconfig):
        default = module.default_inference_config
        monkeypatch.setattr(module, "default_inference_config",
                            lambda default=default, **kw: default(
                                **{"num_frames": FRAMES, "image_size": SIZE, **kw}))
    monkeypatch.setattr(pengine, "model_config_from_inference", lambda config: _port_cfg(tiny_cfg))
    monkeypatch.setattr(jengine, "model_config_from_inference", lambda config: tiny_cfg)
    monkeypatch.setattr(pengine, "get_tokenizer", TinyTok)
    return _port_cfg(tiny_cfg)


# ---- batch_bestof -----------------------------------------------------------

def test_bestof_scoring_matches_jax():
    for s in SENTENCES:
        assert batch_bestof.score_sentence(s) == jbestof.score_sentence(s), s
    assert batch_bestof.pick_best(SENTENCES) == jbestof.pick_best(SENTENCES)
    assert batch_bestof.pick_best([]) == jbestof.pick_best([]) == ""
    rows = [{"video_id": f"v{i}", "S1": a, "S2": b, "S3": c}
            for i, (a, b, c) in enumerate(zip(SENTENCES, SENTENCES[1:], SENTENCES[2:]))]
    assert batch_bestof.bestof_from_rows(rows) == jbestof.bestof_from_rows(rows)


# ---- batch_infer ----------------------------------------------------------

def _cpu_engine(tiny_cfg, tiny_params, **overrides):
    pcfg = _port_cfg(tiny_cfg)
    cfg = default_inference_config(ckpt="missing.pt", num_frames=FRAMES, image_size=SIZE,
                                   **overrides)
    eng = InferenceEngine(cfg, params=params_from_jax_numpy(_np(tiny_params), pcfg, "cpu"),
                          model_cfg=pcfg, device="cpu")
    eng.tokenizer = TinyTok()
    return eng


def test_batch_infer_retries_empty_results_on_the_engines_device(tiny_cfg, tiny_params, anns,
                                                                 tmp_path, monkeypatch):
    """A video whose three captions clean to "" is captioned again by an
    engine with the safe_sample / safe_sample / natural presets, built on
    the first engine's device (here the CPU: the engine's default device is
    the card) with its parameters, geometry and tokenizer."""
    eng = _cpu_engine(tiny_cfg, tiny_params)
    collect = eng.infer_batch_collect

    def empty(handle):
        return [dataclasses.replace(r, candidates=dataclasses.replace(r.candidates, s1="", s2="",
                                                                      s3=""))
                for r in collect(handle)]

    monkeypatch.setattr(eng, "infer_batch_collect", empty)
    built = []
    init = InferenceEngine.__init__

    def spy(self, config, *args, **kwargs):
        built.append((config, kwargs))
        init(self, config, *args, **kwargs)

    monkeypatch.setattr(InferenceEngine, "__init__", spy)
    rows = batch_infer.batch_infer(anns["val"], str(tmp_path / "out.csv"), engine=eng)
    assert len(rows) == 2 and all(r["S1"] and r["S2"] and r["S3"] for r in rows)
    (config, kwargs), = built
    assert (config.preset1, config.preset2, config.preset3) == ("safe_sample", "safe_sample",
                                                                "natural")
    assert (config.num_frames, config.image_size) == (FRAMES, SIZE)
    assert kwargs["device"] == torch.device("cpu") and kwargs["params"] is eng.params
    with (tmp_path / "out.csv").open() as fh:
        assert list(csv.DictReader(fh))[0].keys() == set(batch_infer.COLUMNS)


def test_batch_bestof_cli_captions_a_trainer_directory_on_the_cpu(tiny_geometry, tiny_cfg,
                                                                  tiny_params, anns, tmp_path):
    """batch_bestof's CLI with ``--device cpu`` over a directory the port's
    trainer checkpointing writes: the raw batch_infer rows, one best-of row
    per video, each the best of its row's candidates."""
    pcfg = tiny_geometry
    ckpt = tmp_path / "ckpt"
    save_checkpoint(str(ckpt), params_from_jax_numpy(_np(tiny_params), pcfg, "cpu"), step=2,
                    cfg=pcfg)
    out = tmp_path / "bestof.csv"
    assert batch_bestof.main(["--ann_path", anns["val"], "--out", str(out), "--ckpt", str(ckpt),
                              "--num_frames", str(FRAMES), "--device", "cpu"]) == 0
    with out.with_suffix(".raw.csv").open() as fh:
        raw = list(csv.DictReader(fh))
    with out.open() as fh:
        best = list(csv.DictReader(fh))
    assert [r["video_id"] for r in raw] == [r["video_id"] for r in best] and len(best) == 2
    for r, b in zip(raw, best):
        assert b["caption"] == jbestof.pick_best([r["S1"], r["S2"], r["S3"]])


# ---- debug_chain ------------------------------------------------------------

def test_run_chain_matches_jax(tiny_geometry, tiny_cfg, anns, tmp_path, monkeypatch, capsys):
    """One video through every stage in both packages on the same
    checkpoint: the encoder output, the prefix and the first logits within
    1e-5, and the same top-5 first tokens printed. The chain starts the
    decode at GPT-2's EOS id 50256, so the model has GPT-2's vocabulary."""
    jcfg = dataclasses.replace(tiny_cfg, gpt2=dataclasses.replace(tiny_cfg.gpt2,
                                                                  vocab_size=50257))
    monkeypatch.setattr(pengine, "model_config_from_inference", lambda config: _port_cfg(jcfg))
    monkeypatch.setattr(jengine, "model_config_from_inference", lambda config: jcfg)
    ckpt = str(tmp_path / "chain.pt")
    j_save_torch_checkpoint(ckpt, jcm.init_caption_model(jax.random.PRNGKey(2), jcfg), jcfg)
    frames_dir = json.loads(Path(anns["val"]).read_text())[0]["frames_dir"]
    got = debug_chain.run_chain(frames_dir, ckpt, device="cpu")
    port_out = capsys.readouterr().out
    want = jdebug.run_chain(frames_dir, ckpt)
    jax_out = capsys.readouterr().out
    for key in ("emb", "prefix", "logits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=CHAIN_TOL,
                                   rtol=CHAIN_TOL, err_msg=key)
    top = [line for line in port_out.splitlines() if "top-5" in line]
    assert top == [line for line in jax_out.splitlines() if "top-5" in line] and top


def test_inspect_ckpt_prints_the_census_of_jax(tiny_pt, tmp_path, capsys):
    debug_chain.inspect_ckpt(tiny_pt)
    port_out = capsys.readouterr().out
    jdebug.inspect_ckpt(tiny_pt)
    assert port_out == capsys.readouterr().out
    assert "[ok] family decoder.mapper" in port_out
    # legacy vit.* keys are counted as encoder.backbone.*
    state = torch.load(tiny_pt, weights_only=True)["model_state"]
    legacy = tmp_path / "legacy.pt"
    torch.save({("vit." + k[len("encoder.backbone."):] if k.startswith("encoder.backbone.")
                 else k): v for k, v in state.items()}, legacy)
    debug_chain.inspect_ckpt(str(legacy))
    assert capsys.readouterr().out.replace(str(legacy), tiny_pt) == port_out


# ---- checkpoint directories ----------------------------------------------------

def test_load_metadata_matches_jax(tiny_cfg, tiny_params, tmp_path):
    meta = dict(step=7, epoch=1, best_val=0.25, args={"lr": 3e-4, "max_steps": 9})
    jckpt.save_checkpoint(str(tmp_path / "jax"), tiny_params, **meta)
    pcfg = _port_cfg(tiny_cfg)
    save_checkpoint(str(tmp_path / "port"), params_from_jax_numpy(_np(tiny_params), pcfg, "cpu"),
                    cfg=pcfg, **meta)
    for d in ("jax", "port"):
        assert load_metadata(str(tmp_path / d)) == jckpt.load_metadata(str(tmp_path / d)) == meta
    assert load_metadata(str(tmp_path / "absent")) == jckpt.load_metadata(
        str(tmp_path / "absent")) == {}


def test_restore_params_reads_both_payloads(tiny_cfg, tiny_params, tmp_path):
    """A caption-model directory (reference-format payload) and an align
    directory (``{"params"}``) restore to the trees they were written from;
    an absent directory restores to None."""
    pcfg = _port_cfg(tiny_cfg)
    params = params_from_jax_numpy(_np(tiny_params), pcfg, "cpu")
    acfg = al.AlignConfig(vit=vt.ViTConfig(image_size=SIZE, patch_size=16, embed_dim=64, depth=2,
                                           num_heads=4, out_dim=16, pool="gap"),
                          vocab_size=128, max_text_len=16, text_dim=32, embed_dim=16)
    aparams = al.init_align_params(torch.Generator().manual_seed(1), acfg, "cpu")
    save_checkpoint(str(tmp_path / "caption"), params, cfg=pcfg)
    save_checkpoint(str(tmp_path / "align"), aparams, opt_state={"count": 3})
    for name, tree in (("caption", params), ("align", aparams)):
        like = topt.map_tree(lambda p, t: torch.zeros_like(t), tree)
        restored = dict(topt.leaves(restore_params(str(tmp_path / name), like)))
        assert restored.keys() == dict(topt.leaves(tree)).keys()
        for path, t in topt.leaves(tree):
            assert torch.equal(restored[path], t), path
    assert restore_params(str(tmp_path / "absent"), params) is None


def _other_geometry(tiny_cfg, kind):
    if kind == "deeper":
        return dataclasses.replace(tiny_cfg, gpt2=dataclasses.replace(tiny_cfg.gpt2, n_layer=3))
    return dataclasses.replace(tiny_cfg, vit=dataclasses.replace(tiny_cfg.vit, embed_dim=128))


@pytest.mark.parametrize("kind", ["deeper", "wider", "empty"])
def test_directory_of_another_model_raises_in_both(tiny_cfg, tmp_path, caplog, kind):
    """A checkpoint directory that does not restore into the model (another
    GPT-2 depth, another ViT width, no payload) raises in both packages'
    load_params: neither serves random weights in its place."""
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    if kind == "empty":
        jdir.mkdir()
        pdir.mkdir()
    else:
        other = _other_geometry(tiny_cfg, kind)
        jparams = jcm.init_caption_model(jax.random.PRNGKey(1), other)
        jckpt.save_checkpoint(str(jdir), jparams)
        save_checkpoint(str(pdir), params_from_jax_numpy(_np(jparams), _port_cfg(other), "cpu"),
                        cfg=_port_cfg(other))
    with pytest.raises(RuntimeError, match="could not be restored"):
        jengine.load_params(jconfig.InferenceConfig(ckpt=str(jdir)), tiny_cfg)
    caplog.clear()
    with caplog.at_level(logging.ERROR), pytest.raises(RuntimeError, match="could not be restored"):
        load_params(pconfig.InferenceConfig(ckpt=str(pdir)), _port_cfg(tiny_cfg), seed=0,
                    device="cpu")
    want = {"deeper": "shape-mismatched leaves", "wider": "shape-mismatched leaves",
            "empty": "has no model.pt"}[kind]
    assert want in caplog.text


def test_align_directory_does_not_restore_into_the_caption_model(tiny_cfg, tmp_path, caplog):
    aparams = al.init_align_params(torch.Generator().manual_seed(1), al.AlignConfig(
        vit=vt.ViTConfig(image_size=SIZE, patch_size=16, embed_dim=64, depth=2, num_heads=4,
                         out_dim=16), vocab_size=128, text_dim=32, embed_dim=16), "cpu")
    save_checkpoint(str(tmp_path / "align"), aparams)
    with caplog.at_level(logging.ERROR), pytest.raises(RuntimeError, match="could not be restored"):
        load_params(pconfig.InferenceConfig(ckpt=str(tmp_path / "align")), _port_cfg(tiny_cfg),
                    seed=0, device="cpu")
    assert "tree structure does not match" in caplog.text


# ---- the engine's OOM guard ------------------------------------------------

@pytest.mark.parametrize("entry,stage", [("infer", "_load_feats_overlapped"),
                                         ("infer_batch_dispatch", "_load_videos"),
                                         ("infer_batch_collect", "_collect_videos")])
def test_oom_inside_a_request_is_logged_and_reraised(tiny_cfg, tiny_params, anns, caplog,
                                                     monkeypatch, entry, stage):
    eng = _cpu_engine(tiny_cfg, tiny_params)
    frames_dir = json.loads(Path(anns["val"]).read_text())[0]["frames_dir"]
    handle = eng.infer_batch_dispatch([frames_dir]) if entry == "infer_batch_collect" else None

    def oom(*args, **kwargs):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")

    monkeypatch.setattr(eng, stage, oom)
    arg = {"infer": frames_dir, "infer_batch_dispatch": [frames_dir],
           "infer_batch_collect": handle}[entry]
    with caplog.at_level(logging.ERROR), pytest.raises(torch.cuda.OutOfMemoryError):
        getattr(eng, entry)(arg)
    assert "device OOM; in_use=None reserved=None limit=None" in caplog.text
