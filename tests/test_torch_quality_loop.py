"""The port's quality loop (tools/quality_loop.py) against the JAX package's,
in f32 on the CPU at tiny geometry: the synthetic dataset byte for byte,
the stage-3 LM tune, the align step and its retrieval, and the slice as a
whole (stage 3, the mapper trainer writing its checkpoint directory, an
engine over that directory, batch_infer, batch_bestof) in both packages
from the same initial weights. Inputs come from numpy with a seed; weights
cross with ``params_from_jax_numpy`` / ``align_params_from_jax_numpy``."""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from video_caption_tpu.config import MeshConfig as JMeshConfig
from video_caption_tpu.config import default_inference_config as j_default_config
from video_caption_tpu.data import build_dataloader as j_build_dataloader
from video_caption_tpu.engine import InferenceEngine as JaxEngine
from video_caption_tpu.engine import load_params as j_load_params
from video_caption_tpu.models import align as jal
from video_caption_tpu.models import vit as jvt
from video_caption_tpu.parallel import make_mesh
from video_caption_tpu.tools import batch_bestof as jbestof
from video_caption_tpu.tools import batch_infer as jbatch
from video_caption_tpu.tools import quality_loop as jql
from video_caption_tpu.training import mapper_trainer as jmt
from video_caption_tpu_torch import engine as port_engine
from video_caption_tpu_torch.config import default_inference_config
from video_caption_tpu_torch.engine import InferenceEngine, load_params
from video_caption_tpu_torch.models import align as al
from video_caption_tpu_torch.models import caption_model as cm
from video_caption_tpu_torch.models import gpt2 as g2
from video_caption_tpu_torch.models import vit as vt
from video_caption_tpu_torch.models.convert import (align_params_from_jax_numpy,
                                                    params_from_jax_numpy)
from video_caption_tpu_torch.tools import batch_bestof, batch_infer, export_checkpoint
from video_caption_tpu_torch.tools import quality_loop as ql
from video_caption_tpu_torch.training import optim as topt

FRAMES, SIZE = 2, 32
STAGE3 = dict(max_steps=3, batch_size=4, max_len=12)
MAPPER_STEPS, MAPPER_BS = 2, 2
# deterministic presets: the sampled ones cannot match across the packages'
# random streams (PARITY.md §6; tests/test_logits_processors_hf.py holds
# their warper math)
BEAM_PRESETS = dict(preset1="precise", preset2="detailed", preset3="precise",
                    prompt3="Another prompt:")
LOSS_RTOL = 1e-4       # a loss of the port against JAX's, relative
# a stage-3 weight's update against JAX's: relative to the element's own
# update (Adam's m/sqrt(v) of a gradient that changes sign over the steps
# is a near-cancellation; 0.9% measured on one fc_w element of 32768), and
# absolute as a share of the leaf's largest update (the key biases, whose
# gradient is zero to rounding, step by ~4e-7 either way against ~9e-4)
UPDATE_RTOL, UPDATE_ATOL = 1e-2, 1e-3
ALIGN = dict(vocab_size=128, max_text_len=16, text_dim=32, text_layers=2, text_heads=4,
             embed_dim=16)


class TinyTok:
    """Ids below the tiny GPT-2's vocab of 128; decodes to words the text
    cleaner keeps, so the captions are not empty."""
    eos_token_id = bos_token_id = pad_token_id = 127
    vocab_size = 128
    WORDS = "a the red green square ball moves is moving left right up down small big".split()

    def encode(self, text):
        return [b % 127 for b in text.encode()] or [1]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(self.WORDS[int(i) % len(self.WORDS)] for i in ids if int(i) != 127)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_cfg(jcfg):
    v, g = jcfg.vit, jcfg.gpt2
    return cm.CaptionModelConfig(
        vit=vt.ViTConfig(image_size=v.image_size, patch_size=v.patch_size,
                         embed_dim=v.embed_dim, depth=v.depth, num_heads=v.num_heads,
                         out_dim=v.out_dim, dtype=torch.float32),
        gpt2=g2.GPT2Config(vocab_size=g.vocab_size,
                           max_position_embeddings=g.max_position_embeddings,
                           n_embd=g.n_embd, n_layer=g.n_layer, n_head=g.n_head,
                           dtype=torch.float32),
        prefix_len=jcfg.prefix_len, video_dim=jcfg.video_dim)


@pytest.fixture(scope="module")
def anns(tmp_path_factory):
    """2 classes, 2 train and 1 val video each, 2 frames of 32 px."""
    return ql.make_synthetic_dataset(
        str(tmp_path_factory.mktemp("qloop_data")), num_frames=FRAMES, image_size=SIZE,
        colors=2, shapes=1, motions=1, sizes=1, train_per_class=2, val_per_class=1)


def _captions(ann):
    return sorted({c for r in json.loads(Path(ann).read_text()) for c in r["captions"]})


# ---- the dataset -----------------------------------------------------------

@pytest.mark.parametrize("factors", [dict(colors=2, sizes=1), dict(colors=1, sizes=2)])
def test_synthetic_dataset_has_the_jax_modules_bytes(tmp_path, factors):
    """The same seed renders the same JPEGs and annotations in both
    packages (the renderer is the JAX module's code; the annotations differ
    only in the root of their frame paths)."""
    args = dict(num_frames=FRAMES, image_size=SIZE, shapes=1, motions=1, train_per_class=1,
                val_per_class=1, **factors)
    got = ql.make_synthetic_dataset(str(tmp_path / "port"), **args)
    want = jql.make_synthetic_dataset(str(tmp_path / "jax"), **args)
    port_files = sorted(p.relative_to(tmp_path / "port")
                        for p in (tmp_path / "port").rglob("*") if p.is_file())
    jax_files = sorted(p.relative_to(tmp_path / "jax")
                       for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert port_files == jax_files and len(port_files) == 2 * 2 * FRAMES + 2
    for rel in port_files:
        if rel.name == "annotations.json":
            continue
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()
    for split in ("train", "val"):
        text = Path(got[split]).read_text().replace(str(tmp_path / "port"), "ROOT")
        assert text == Path(want[split]).read_text().replace(str(tmp_path / "jax"), "ROOT")
    records = json.loads(Path(got["val"]).read_text())
    assert {len(r["captions"]) for r in records} == {2}


# ---- the slice as a whole: stage 3, mapper, engine, batch_infer, bestof -------

@pytest.fixture(scope="module")
def jax_slice(anns, tiny_cfg, tiny_params, tmp_path_factory):
    """The JAX module's stage 3 and mapper stage (its ``main``, steps cut,
    on one device) on the tiny model."""
    out = tmp_path_factory.mktemp("jax_slice")
    tok = TinyTok()
    dec, first, last = jql.train_stage3_lm(tiny_params["decoder"], tiny_cfg.gpt2,
                                           _captions(anns["train"]), tok, **STAGE3)
    params = {**tiny_params, "decoder": dec}
    ckpt = str(out / "ckpt_mapper")
    trainer = jmt.MapperTrainer(
        tiny_cfg, params,
        jmt.TrainArgs(lr=3e-4, lr_gpt2=1e-5, unfreeze_last_gpt2=2, epochs=1000,
                      max_steps=MAPPER_STEPS, val_every=100, out_dir=str(out / "runs_mapper"),
                      ckpt_path=ckpt),
        mesh=make_mesh(JMeshConfig(data=1, model=1), jax.devices()[:1]))
    loader = j_build_dataloader(anns["train"], tok, batch_size=MAPPER_BS, max_len=24,
                                num_frame=FRAMES, image_size=SIZE, num_workers=1,
                                uint8_pixels=True)
    val_loader = j_build_dataloader(anns["val"], tok, batch_size=MAPPER_BS, max_len=24,
                                    num_frame=FRAMES, image_size=SIZE, shuffle=False)

    def strip(b):
        return {k: v for k, v in b.items() if k != "video_id"}

    def cycle():
        while True:
            for b in loader:
                yield strip(b)

    stats = trainer.fit(cycle(), [strip(b) for b in val_loader])
    return {"dec": _np(dec), "first": first, "last": last, "ckpt": ckpt, "stats": stats,
            "out": out}


@pytest.fixture(scope="module")
def port_slice(anns, tiny_cfg, tiny_params, tmp_path_factory):
    """The port's stage 3 and mapper stage from the same initial weights."""
    out = tmp_path_factory.mktemp("port_slice")
    cfg = _port_cfg(tiny_cfg)
    params = params_from_jax_numpy(_np(tiny_params), cfg, "cpu")
    start = topt.map_tree(lambda p, t: t.clone(), params)
    dec, first, last = ql.train_stage3_lm(params["decoder"], cfg.gpt2, _captions(anns["train"]),
                                          TinyTok(), **STAGE3)
    ckpt, stats = ql.train_mapper(cfg, {**params, "decoder": dec}, anns["train"], anns["val"],
                                  TinyTok(), out, MAPPER_STEPS, MAPPER_BS, 2, FRAMES, SIZE)
    return {"cfg": cfg, "start": start, "params": params, "dec": dec, "first": first,
            "last": last, "ckpt": ckpt, "stats": stats, "out": out}


def test_stage3_lm_tracks_jax(jax_slice, port_slice):
    """Three steps of clipped adamw from the same weights and batch picks:
    the first and last losses within 1e-4 relative; each element's update
    (trained minus initial weight) within UPDATE_RTOL of JAX's update of it
    plus UPDATE_ATOL of the largest update in its leaf (a skipped update
    misses by all of it, a reversed one by twice); and the caller's tree
    untouched."""
    assert port_slice["first"] != port_slice["last"]
    np.testing.assert_allclose([port_slice["first"], port_slice["last"]],
                               [jax_slice["first"], jax_slice["last"]], rtol=LOSS_RTOL)
    want = dict(topt.leaves(jax_slice["dec"]))
    start = dict(topt.leaves(port_slice["start"]["decoder"]))
    for path, t in topt.leaves(port_slice["dec"]):
        w0 = start[path].numpy().astype(np.float64)
        ref = want[path] - w0
        scale = np.abs(ref).max()
        assert scale > 0, path
        np.testing.assert_allclose(t.numpy() - w0, ref, rtol=UPDATE_RTOL,
                                   atol=UPDATE_ATOL * scale, err_msg=path)
    for path, t in topt.leaves(port_slice["params"]):
        assert torch.equal(t, dict(topt.leaves(port_slice["start"]))[path]), path


def test_mapper_directory_serves_the_rows_of_jax(jax_slice, port_slice, anns, tiny_cfg,
                                                 tmp_path):
    """An engine over each package's trainer directory, then batch_infer at
    batch 2 (dispatch N+1 before collect N) and batch_bestof: the same
    S1/S2/S3, best key and best-of caption for every val video."""
    assert port_slice["stats"]["steps"] == jax_slice["stats"]["steps"] == MAPPER_STEPS
    np.testing.assert_allclose(port_slice["stats"]["best_val"], jax_slice["stats"]["best_val"],
                               rtol=LOSS_RTOL)
    cfg = default_inference_config(num_frames=FRAMES, image_size=SIZE, **BEAM_PRESETS)
    port = InferenceEngine(dataclasses.replace(cfg, ckpt=port_slice["ckpt"]),
                           model_cfg=port_slice["cfg"], device="cpu")
    jeng = JaxEngine(j_default_config(num_frames=FRAMES, image_size=SIZE,
                                      ckpt=jax_slice["ckpt"], **BEAM_PRESETS),
                     model_cfg=tiny_cfg)
    port.tokenizer = jeng.tokenizer = TinyTok()
    rows = batch_infer.batch_infer(anns["val"], str(tmp_path / "port.csv"), batch_size=2,
                                   engine=port)
    jrows = jbatch.batch_infer(anns["val"], str(tmp_path / "jax.csv"), batch_size=2,
                               engine=jeng)
    keys = ("video_id", "S1", "S2", "S3", "best_key", "best_text", "ref_caption")
    assert len(rows) == 2 and all(r["S1"] for r in rows)
    assert [{k: r[k] for k in keys} for r in rows] == [{k: r[k] for k in keys} for r in jrows]
    assert batch_bestof.bestof_from_rows(rows) == jbestof.bestof_from_rows(jrows)
    header = (tmp_path / "port.csv").read_text().splitlines()[0]
    assert header == (tmp_path / "jax.csv").read_text().splitlines()[0]


def test_directory_and_its_export_give_identical_params(port_slice, tiny_cfg, tmp_path,
                                                        monkeypatch):
    """The engine's load over the trainer's directory equals its load over
    export_checkpoint's .pt of it, which keeps the directory's metadata,
    and that .pt loads into the JAX package's load_params with identical
    arrays."""
    cfg = port_slice["cfg"]
    monkeypatch.setattr(port_engine, "model_config_from_inference", lambda config: cfg)
    out = tmp_path / "exported.pt"
    assert export_checkpoint.main(["--ckpt", port_slice["ckpt"], "--out", str(out)]) == 0
    base = default_inference_config(num_frames=FRAMES, image_size=SIZE)
    from_dir = load_params(dataclasses.replace(base, ckpt=port_slice["ckpt"]), cfg, seed=5,
                           device="cpu")
    from_pt = load_params(dataclasses.replace(base, ckpt=str(out)), cfg, seed=6, device="cpu")
    assert [p for p, _ in topt.leaves(from_dir)] == [p for p, _ in topt.leaves(from_pt)]
    pt = dict(topt.leaves(from_pt))
    for path, t in topt.leaves(from_dir):
        assert torch.equal(t, pt[path]), path
    raw = torch.load(out, weights_only=True)
    assert raw["step"] == MAPPER_STEPS and raw["best_val"] == port_slice["stats"]["best_val"]
    assert raw["args"]["max_steps"] == MAPPER_STEPS
    jloaded = dict(topt.leaves(_np(j_load_params(
        j_default_config(ckpt=str(out), num_frames=FRAMES, image_size=SIZE), tiny_cfg, seed=7))))
    for path, t in topt.leaves(from_dir):
        np.testing.assert_array_equal(jloaded[path], t.numpy(), err_msg=path)
    # the mapper moved in training: the directory holds the trained weights
    assert not torch.equal(from_dir["mapper"]["w"], port_slice["start"]["mapper"]["w"])


# ---- the align stage and its retrieval ---------------------------------------

TINY_GAP = dict(image_size=SIZE, patch_size=16, embed_dim=64, depth=2, num_heads=4, out_dim=16,
                pool="gap", remat=True)


def _align_cfgs():
    jcfg = jal.AlignConfig(vit=jvt.ViTConfig(dtype=jnp.float32, **TINY_GAP),
                           temporal_mode="diff", **ALIGN)
    cfg = al.AlignConfig(vit=vt.ViTConfig(dtype=torch.float32, **TINY_GAP),
                         temporal_mode="diff", **ALIGN)
    return jcfg, cfg


def test_align_steps_track_jax(anns):
    """Three Adam steps of the symmetric InfoNCE at a tiny gap/f32/remat ViT
    (``temporal_mode="diff"``), the batch every record: the port's step
    against the JAX module's step (its loss and optimizer, under one
    jax.jit) at the tiny config, since its ``train_align`` builds a
    full-width ViT. Losses within 1e-4 relative."""
    lr = 1e-3
    jcfg, cfg = _align_cfgs()
    records = json.loads(Path(anns["train"]).read_text())
    videos = ql._videos(records, FRAMES, SIZE)
    ids, mask = ql._texts(TinyTok(), [r["captions"][0] for r in records])
    jp = jal.init_align_params(jax.random.PRNGKey(3), jcfg)
    n = len(records)
    optimizer = optax.adam(lr)

    @jax.jit
    def step(p, s, key, videos_a, ids_a, mask_a):
        pick = jax.random.choice(key, n, (n,), replace=False)

        def loss_fn(q):
            v = jal.encode_video(q, videos_a[pick], jcfg)
            t = jal.encode_text(q, ids_a[pick], mask_a[pick], jcfg)
            logits = (v @ t.T) / 0.07
            labels = jnp.arange(n)
            lv = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
            lt = optax.softmax_cross_entropy_with_integer_labels(logits.T, labels)
            return (lv.mean() + lt.mean()) / 2

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, s = optimizer.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    jlosses, q, s, key = [], jp, optimizer.init(jp), jax.random.PRNGKey(7)
    for _ in range(3):
        key, sub = jax.random.split(key)
        q, s, loss = step(q, s, sub, jnp.asarray(videos), jnp.asarray(ids.astype(np.int32)),
                          jnp.asarray(mask))
        jlosses.append(float(loss))
    tp = align_params_from_jax_numpy(_np(jp), "cpu")
    trained, losses = ql.align_steps(cfg, tp, torch.from_numpy(videos), torch.from_numpy(ids),
                                     torch.from_numpy(mask), 3, lr, batch_size=96)
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    assert not torch.equal(trained["video_proj"]["w"], tp["video_proj"]["w"])


@pytest.mark.parametrize("one_per_class,all_captions", [(False, False), (True, True)])
def test_align_retrieval_matches_jax(anns, one_per_class, all_captions):
    """eval_align_retrieval on the same weights: the video and text features
    within 1e-5, recall@1/5, MRR and the query count equal."""
    jcfg, cfg = _align_cfgs()
    jp = jal.init_align_params(jax.random.PRNGKey(4), jcfg)
    tp = align_params_from_jax_numpy(_np(jp), "cpu")
    tok = TinyTok()
    got = ql.eval_align_retrieval(cfg, tp, anns["val"], FRAMES, SIZE, tok,
                                  one_per_class=one_per_class, all_captions=all_captions)
    want = jql.eval_align_retrieval(jcfg, jp, anns["val"], FRAMES, SIZE, tok,
                                    one_per_class=one_per_class, all_captions=all_captions)
    assert got == want
    assert got["num_queries"] == 2 * (2 if all_captions else 1)
    records = json.loads(Path(anns["val"]).read_text())
    videos = ql._videos(records, FRAMES, SIZE)
    ids, mask = ql._texts(tok, [c for r in records for c in r["captions"]])
    with torch.no_grad():
        v = al.encode_video(tp, torch.from_numpy(videos), cfg)
        t = al.encode_text(tp, torch.from_numpy(ids), torch.from_numpy(mask), cfg)
    np.testing.assert_allclose(v.numpy(), np.asarray(jal.encode_video(jp, videos, jcfg)),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        t.numpy(), np.asarray(jal.encode_text(jp, ids.astype(np.int32), mask, jcfg)),
        atol=1e-5, rtol=1e-5)
