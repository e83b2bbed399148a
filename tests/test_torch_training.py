"""The port's training slice against the JAX package, in f32 on the CPU at
tiny geometry: the three differentiable kernels (fused_pool,
encoder_attention, prefix_projector) and their backward passes, the gap ViT,
the teacher-forcing loss, the alignment and toy models, the optimizer
chains, three steps of each trainer, the trainers' checkpoints and CLIs. Inputs come from numpy
with a seed; the JAX side runs its Pallas kernels in interpret mode (or its
XLA path where its own gates send them there)."""
import csv
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from video_caption_tpu.config import InferenceConfig as JInferenceConfig
from video_caption_tpu.config import MeshConfig as JMeshConfig
from video_caption_tpu.engine import load_params as j_load_params
from video_caption_tpu.models import align as jal
from video_caption_tpu.models import caption_model as jcm
from video_caption_tpu.models import gpt2 as jg2
from video_caption_tpu.models import toy as jtoy
from video_caption_tpu.models import vit as jvt
from video_caption_tpu.ops.pallas import encoder_attention as jea
from video_caption_tpu.ops.pallas import fused_pool as jfp
from video_caption_tpu.ops.pallas import prefix_projector as jpp
from video_caption_tpu.parallel import make_mesh
from video_caption_tpu.training import loop as jloop
from video_caption_tpu.training import mapper_trainer as jmt
from video_caption_tpu.training import optim as jopt
from video_caption_tpu_torch.cli import train as train_dry
from video_caption_tpu_torch.cli import train_decoder_only, train_full
from video_caption_tpu_torch.config import InferenceConfig, MeshConfig
from video_caption_tpu_torch.decode.tokenizer import get_tokenizer
from video_caption_tpu_torch.engine import load_params
from video_caption_tpu_torch.models import align as al
from video_caption_tpu_torch.models import caption_model as cm
from video_caption_tpu_torch.models import gpt2 as g2
from video_caption_tpu_torch.models import toy
from video_caption_tpu_torch.models import vit as vt
from video_caption_tpu_torch.models.convert import (align_params_from_jax_numpy,
                                                    params_from_jax_numpy)
from video_caption_tpu_torch.ops import encoder_attention as ea
from video_caption_tpu_torch.ops import fused_pool as fp
from video_caption_tpu_torch.ops import prefix_projector as pp
from video_caption_tpu_torch.training import optim as topt
from video_caption_tpu_torch.training.checkpoint import save_checkpoint
from video_caption_tpu_torch.training.loop import LoopConfig, run_training, value_and_grad
from video_caption_tpu_torch.training.mapper_trainer import MapperTrainer, TrainArgs

ENCODER_TOL = 2e-4      # the JAX package's encoder differential bound (PARITY.md §1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _vit(jvit, dtype=torch.float32, **kw):
    """The port's ViTConfig with the geometry of a JAX one."""
    return vt.ViTConfig(image_size=jvit.image_size, patch_size=jvit.patch_size,
                        embed_dim=jvit.embed_dim, depth=jvit.depth, num_heads=jvit.num_heads,
                        pool=jvit.pool, out_dim=jvit.out_dim, dtype=dtype,
                        remat=jvit.remat, **kw)


def _caption_cfg(jcfg):
    g = jcfg.gpt2
    return cm.CaptionModelConfig(
        vit=_vit(jcfg.vit),
        gpt2=g2.GPT2Config(vocab_size=g.vocab_size, max_position_embeddings=g.max_position_embeddings,
                           n_embd=g.n_embd, n_layer=g.n_layer, n_head=g.n_head,
                           dtype=torch.float32),
        prefix_len=jcfg.prefix_len, video_dim=jcfg.video_dim, proj_hidden=jcfg.proj_hidden,
        freeze_encoder=jcfg.freeze_encoder)


# a ViT with H = 128, so the JAX package's fused_pool gate (H % 128) takes
# the kernel; head dim 32
GAP_VIT = jvt.ViTConfig(image_size=32, patch_size=16, embed_dim=128, depth=2, num_heads=4,
                        pool="gap", out_dim=16, dtype=jnp.float32)


def _video(b=2, t=3, seed=0, size=32):
    return np.random.RandomState(seed).randn(b, t, 3, size, size).astype(np.float32)


# ---- kernels and their backward passes ------------------------------------

@pytest.mark.parametrize("mode", ["cls", "gap"])
def test_fused_pool_and_its_backward_match_jax(mode):
    b, t, s, h = 2, 3, 5, 128
    rng = np.random.RandomState(1)
    tokens = rng.randn(b * t, s, h).astype(np.float32)
    g = rng.randn(b, h).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jfp.fused_pool_temporal(jnp.asarray(tokens), b, t, mode)
        assert want is not None, jfp.last_error
        out, vjp = jax.vjp(lambda x: jfp._pool_with_vjp(x, b, t, mode), jnp.asarray(tokens))
        (want_grad,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(fp.fused_pool_ref(torch.from_numpy(tokens), b, t, mode).numpy(),
                               np.asarray(want), atol=1e-5, rtol=1e-5)
    x = torch.from_numpy(tokens).requires_grad_()
    got = fp.fused_pool_temporal(x, b, t, mode)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=1e-5, rtol=1e-5)
    (got_grad,) = torch.autograd.grad(got, x, torch.from_numpy(g))
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad), atol=1e-5, rtol=1e-5)


def test_fused_pool_rejects_what_it_does_not_take():
    x = torch.zeros(6, 5, 8)
    with pytest.raises(ValueError):
        fp.fused_pool_temporal(x, 2, 2, "gap")        # 6 rows are not 2 x 2 frames
    with pytest.raises(ValueError):
        fp.fused_pool_temporal(x, 2, 3, "max")
    with pytest.raises(ValueError, match="CUDA"):
        fp.fused_pool_temporal(torch.zeros(6, 5, 8, device="meta"), 2, 3, "gap")


def test_encoder_attention_bwd_matches_jax_custom_vjp():
    n, nh, s, hd = 2, 4, 13, 64
    rng = np.random.RandomState(2)
    qkv = rng.randn(n, s, 3 * nh * hd).astype(np.float32)
    g = rng.randn(n, s, nh * hd).astype(np.float32)
    (want,) = jea._attention_bwd(nh, 1, jnp.asarray(qkv), jnp.asarray(g))
    got = ea.encoder_attention_bwd(torch.from_numpy(qkv), torch.from_numpy(g), nh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def _vit_grads_both(jcfg, video, remat=False):
    """(JAX (value, grads), port (value, grads)) of sum(vit_encode ** 2)
    over the encoder parameters, the JAX kernels in interpret mode (an
    interpreted kernel cannot sit inside jax.checkpoint: with remat the JAX
    attention takes its XLA path)."""
    jcfg = dataclasses.replace(jcfg, use_pallas_attention=not remat, use_pallas_pool=True,
                               remat=remat)
    jp = jvt.init_vit_params(jax.random.PRNGKey(3), jcfg)

    def jloss(p):
        return jnp.sum(jvt.vit_encode(p, jnp.asarray(video), jcfg) ** 2)

    # one jitted program: differentiated eagerly, an interpreted kernel's
    # callbacks and the eager backward's dispatch wait on each other
    with pltpu.force_tpu_interpret_mode():
        jval, jgrads = jax.jit(jax.value_and_grad(jloss))(jp)
    cfg = _vit(jcfg)
    tp = params_from_jax_numpy(_np(jp), None, "cpu")
    val, grads = value_and_grad(
        lambda p, v: (vt.vit_encode(p, v, cfg) ** 2).sum(), tp, torch.from_numpy(video))
    return (np.asarray(jval), _np(jgrads)), (val.numpy(), grads)


def _assert_grads(grads, jgrads, tol):
    flat = dict(topt.leaves(jgrads))
    assert set(grads) == set(flat)
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), flat[path], atol=tol, rtol=tol, err_msg=path)


@pytest.mark.parametrize("pool", ["cls", "gap"])
def test_encoder_attention_bwd_through_vit_matches_jax(tiny_cfg, pool):
    """The gradients of the whole encoder with the attention kernel, as
    tests/test_pallas_ops.py differentiates the JAX encoder with it."""
    jcfg = dataclasses.replace(tiny_cfg.vit, pool=pool)
    (jval, jgrads), (val, grads) = _vit_grads_both(jcfg, _video())
    np.testing.assert_allclose(val, jval, rtol=1e-5)
    _assert_grads(grads, jgrads, ENCODER_TOL)


def test_prefix_project_bwd_matches_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(3, 128).astype(np.float32)
    w = (rng.randn(128, 256) * 0.02).astype(np.float32)
    g = rng.randn(3, 256).astype(np.float32)
    want = jpp._project_bwd((jnp.asarray(x), jnp.asarray(w)), jnp.asarray(g))
    got = pp.prefix_project_bwd(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(g),
                                torch.float32)
    for a, e in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), atol=1e-5, rtol=1e-5)
    # the autograd.Function routes its backward there
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    bt = torch.zeros(256, requires_grad=True)
    grads = torch.autograd.grad(pp.prefix_project(xt, wt, bt), (xt, wt, bt), torch.from_numpy(g))
    for a, e in zip(grads, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("remat", [False, True])
def test_gap_vit_encode_value_and_grads_match_jax(remat):
    video = _video(seed=5)
    (jval, jgrads), (val, grads) = _vit_grads_both(GAP_VIT, video, remat=remat)
    np.testing.assert_allclose(val, jval, rtol=ENCODER_TOL)
    _assert_grads(grads, jgrads, ENCODER_TOL)


def test_remat_reruns_the_attention_forward():
    """With remat the backward recomputes each block, the attention kernel's
    forward included (on the card that is a second launch per layer)."""
    cfg = dataclasses.replace(_vit(GAP_VIT), remat=True)
    params = vt.init_vit_params(torch.Generator().manual_seed(0), cfg, "cpu")
    calls = []
    forward = ea.encoder_attention_ref      # the op's CPU kernel

    def counting(qkv, num_heads):
        calls.append(qkv.shape)
        return forward(qkv, num_heads)

    ea.encoder_attention_ref = counting
    try:
        value_and_grad(lambda p, v: vt.vit_encode(p, v, cfg).sum(), params,
                       torch.from_numpy(_video(seed=6)))
    finally:
        ea.encoder_attention_ref = forward
    assert len(calls) == 2 * cfg.depth


# ---- teacher-forcing loss ------------------------------------------------

def _caption_batch(b=2, length=6, seed=7, vocab=128):
    rng = np.random.RandomState(seed)
    mask = np.ones((b, length), np.int32)
    mask[0, length - 2:] = 0                     # a padded caption
    return {"video": _video(b, 2, seed),
            "caption_ids": rng.randint(1, vocab - 1, (b, length)).astype(np.int32),
            "attention_mask": mask}


def test_gpt2_logits_nocache_matches_jax(tiny_cfg, tiny_params):
    cfg = _caption_cfg(tiny_cfg)
    tp = params_from_jax_numpy(_np(tiny_params), cfg, "cpu")
    rng = np.random.RandomState(8)
    embeds = (rng.randn(2, 7, 64) * 0.1).astype(np.float32)
    mask = np.array([[1] * 7, [1] * 5 + [0] * 2], np.int32)
    pos = np.maximum(np.cumsum(mask, 1) - 1, 0).astype(np.int32)
    want = jg2.gpt2_logits_nocache(tiny_params["decoder"], jnp.asarray(embeds), jnp.asarray(pos),
                                   jnp.asarray(mask), tiny_cfg.gpt2)
    got = g2.gpt2_logits_nocache(tp["decoder"], torch.from_numpy(embeds),
                                 torch.from_numpy(pos).long(), torch.from_numpy(mask), cfg.gpt2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("freeze", [False, True])
def test_compute_loss_value_and_mapper_grad_match_jax(tiny_cfg, tiny_params, freeze):
    jcfg = dataclasses.replace(tiny_cfg, freeze_encoder=freeze)
    cfg = _caption_cfg(jcfg)
    tp = params_from_jax_numpy(_np(tiny_params), cfg, "cpu")
    batch = _caption_batch()
    jb = [jnp.asarray(batch[k]) for k in ("video", "caption_ids", "attention_mask")]
    jval, jgrads = jax.value_and_grad(lambda p: jcm.compute_loss(p, *jb, jcfg))(tiny_params)
    val, grads = value_and_grad(
        lambda p, b: cm.compute_loss(p, b["video"], b["caption_ids"], b["attention_mask"], cfg),
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-5)
    for leaf in ("w", "b"):
        np.testing.assert_allclose(grads[f"/mapper/{leaf}"].numpy(),
                                   np.asarray(jgrads["mapper"][leaf]), rtol=1e-5, atol=1e-6)
    # the frozen encoder is not reached; the decoder's gradients are
    assert (grads["/encoder/cls_token"] is None) == freeze
    np.testing.assert_allclose(grads["/decoder/wte"].numpy(),
                               np.asarray(jgrads["decoder"]["wte"]), rtol=1e-5, atol=1e-6)


# ---- the alignment model -------------------------------------------------

ALIGN = dict(vocab_size=128, max_text_len=16, text_dim=32, text_layers=2, text_heads=4,
             embed_dim=16)


@pytest.mark.parametrize("temporal_mode", ["mean", "diff"])
def test_align_model_matches_jax(temporal_mode):
    jcfg = jal.AlignConfig(vit=dataclasses.replace(GAP_VIT, use_pallas_pool=True,
                                                   use_pallas_attention=True),
                           temporal_mode=temporal_mode, **ALIGN)
    jp = jal.init_align_params(jax.random.PRNGKey(9), jcfg)
    cfg = al.AlignConfig(vit=_vit(GAP_VIT), temporal_mode=temporal_mode, **ALIGN)
    tp = align_params_from_jax_numpy(_np(jp), "cpu")
    batch = _caption_batch(seed=10)
    with pltpu.force_tpu_interpret_mode():
        jv = jal.encode_video(jp, jnp.asarray(batch["video"]), jcfg)
    jt = jal.encode_text(jp, jnp.asarray(batch["caption_ids"]),
                         jnp.asarray(batch["attention_mask"]), jcfg)
    target = np.array([1, -1], np.float32)
    jloss = jal.cosine_embedding_loss(jv, jt, jnp.asarray(target), margin=0.1)
    v = al.encode_video(tp, torch.from_numpy(batch["video"]), cfg)
    t = al.encode_text(tp, torch.from_numpy(batch["caption_ids"]),
                       torch.from_numpy(batch["attention_mask"]), cfg)
    loss = al.cosine_embedding_loss(v, t, torch.from_numpy(target), margin=0.1)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5, rtol=1e-5)
    assert tp["video_proj"]["w"].shape[0] == 16 * (2 if temporal_mode == "diff" else 1)
    init = al.init_align_params(torch.Generator().manual_seed(0), cfg, "cpu")
    assert jax.tree.structure(jax.tree.map(lambda x: 0, _np(jp))) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, {k: v for k, v in init.items()}))


# ---- the optimizer chain -------------------------------------------------

def test_tree_adam_matches_optax_chains(tiny_params, tiny_cfg):
    """build_optimizer (clip, adam, masked decay, per-depth rates) and adamw
    against optax on the same gradients, with the clip both taken and not."""
    rng = np.random.RandomState(11)
    cfg = _caption_cfg(tiny_cfg)
    for scale in (10.0, 1e-4):
        grads = [jax.tree.map(lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32) * scale),
                              tiny_params) for _ in range(3)]
        jtree = jopt.mapper_lr_tree(tiny_params, 1e-2, 1e-3, 1, tiny_cfg.gpt2.n_layer)
        tp = params_from_jax_numpy(_np(tiny_params), cfg, "cpu")
        chains = (
            (jopt.build_optimizer(jtree, 0.01),
             topt.build_optimizer(topt.mapper_lr_tree(tp, 1e-2, 1e-3, 1, 2), 0.01)),
            (optax.adamw(1e-2), topt.adamw(tp, 1e-2)),
        )
        for jopt_, port_opt in chains:
            jp, state = tiny_params, jopt_.init(tiny_params)
            tp = params_from_jax_numpy(_np(tiny_params), cfg, "cpu")
            for g in grads:
                updates, state = jopt_.update(g, state, jp)
                jp = optax.apply_updates(jp, updates)
                port_opt.step(tp, {p: torch.from_numpy(np.array(x))
                                   for p, x in topt.leaves(g)})
            for path, want in topt.leaves(_np(jp)):
                got = dict(topt.leaves(tp))[path].numpy()
                np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6, err_msg=path)


def test_warmup_cosine_schedule_matches_optax():
    for args in ((0.0, 1e-3, 3, 10), (1e-4, 1e-3, 0, 5, 1e-5)):
        want = optax.warmup_cosine_decay_schedule(*args)
        got = topt.warmup_cosine_decay(*args)
        for count in range(12):
            np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, atol=1e-12)
    with pytest.raises(ValueError):
        topt.warmup_cosine_decay(0.0, 1e-3, 5, 5)


def test_mapper_trainer_refuses_more_than_one_device(tiny_cfg, tiny_params, tmp_path):
    """Without a process group of data * model ranks, a mesh of two devices
    is refused (ValueError, as the JAX package's make_mesh refuses a device
    count that does not match); ``fsdp`` on one device shards nothing, as
    the JAX trainer's on a 1x1 mesh. The mesh paths themselves:
    tests/test_torch_parallel.py."""
    cfg = _caption_cfg(tiny_cfg)
    tp = params_from_jax_numpy(_np(tiny_params), cfg, "cpu")
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        MapperTrainer(cfg, tp, TrainArgs(out_dir=str(tmp_path)), mesh=MeshConfig(data=2))
    fsdp = MapperTrainer(cfg, tp, TrainArgs(out_dir=str(tmp_path)), fsdp=True)
    assert all(axis is None for _, spec in topt.leaves(fsdp.specs) for axis in spec)


# ---- three steps of each trainer against JAX ------------------------------

def _events(path):
    with path.open() as fh:
        return [float(r["loss"]) for r in csv.DictReader(fh)]


@pytest.mark.parametrize("unfreeze", [0, 1])
def test_mapper_trainer_three_steps_track_jax(tiny_cfg, tiny_params, tmp_path, unfreeze):
    args = dict(unfreeze_last_gpt2=unfreeze, lr_gpt2=1e-3, max_steps=3)
    jtr = jmt.MapperTrainer(
        tiny_cfg, tiny_params,
        jmt.TrainArgs(out_dir=str(tmp_path / "jax"), ckpt_path=str(tmp_path / "jck"), **args),
        mesh=make_mesh(JMeshConfig(data=1, model=1), jax.devices()[:1]))
    cfg = _caption_cfg(tiny_cfg)
    init = params_from_jax_numpy(_np(tiny_params), cfg, "cpu")
    tr = MapperTrainer(cfg, init, TrainArgs(out_dir=str(tmp_path / "port"),
                                            ckpt_path=str(tmp_path / "pck"), **args))
    batches = [_caption_batch(seed=s) for s in (12, 13, 14)]
    jlosses = [jtr.run_step(b) for b in batches]
    losses = [tr.run_step(b) for b in batches]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert _events(tmp_path / "port" / "events.csv") == losses
    jparams = dict(topt.leaves(_np(jtr.params)))
    moved = []
    for path, t in topt.leaves(tr.params):
        before = dict(topt.leaves(init))[path]
        if torch.equal(t, before):
            # frozen: bit-equal to the start, as JAX's
            np.testing.assert_array_equal(jparams[path], before.numpy(), err_msg=path)
        else:
            moved.append(path)
            np.testing.assert_allclose(t.numpy(), jparams[path], atol=1e-5, rtol=1e-5,
                                       err_msg=path)
    assert "/mapper/w" in moved and "/mapper/b" in moved
    assert not any(p.startswith("/encoder") or p.startswith("/decoder/w") for p in moved)
    assert any(p.startswith("/decoder/blocks") for p in moved) == bool(unfreeze)
    # the first GPT-2 block stays frozen either way
    np.testing.assert_array_equal(tr.params["decoder"]["blocks"]["attn_w"][0].numpy(),
                                  init["decoder"]["blocks"]["attn_w"][0].numpy())


def test_align_gap_run_training_three_steps_track_jax(tmp_path):
    """adamw at 1e-5, not train_full's 1e-4: Adam's first update is
    g / (|g| + 1e-8), so a gradient that is ~0 in exact arithmetic (here one
    text fc1 bias, ~1e-9) steps by about +-lr with a sign set by summation
    order. At 1e-4 the two packages' losses part by 5e-5 after three steps
    from that alone (the gradients of every leaf agree within 1e-6 of their
    largest value); the loss drift scales with lr, and a parameter can stand
    up to ~1.5 lr apart."""
    lr = 1e-5
    # remat: the JAX attention takes its XLA path (see _vit_grads_both)
    jcfg = jal.AlignConfig(vit=dataclasses.replace(GAP_VIT, use_pallas_pool=True, remat=True),
                           **ALIGN)
    jp = jal.init_align_params(jax.random.PRNGKey(15), jcfg)
    cfg = al.AlignConfig(vit=_vit(jcfg.vit), **ALIGN)
    tp = align_params_from_jax_numpy(_np(jp), "cpu")
    batches = [_caption_batch(seed=s) for s in (16, 17, 18)]

    def jloss_fn(p, batch):
        v = jal.encode_video(p, batch["video"], jcfg)
        t = jal.encode_text(p, batch["caption_ids"], batch["attention_mask"], jcfg)
        return jal.cosine_embedding_loss(v, t, jnp.ones(v.shape[0]))

    with pltpu.force_tpu_interpret_mode():
        jres = jloop.run_training(jp, jloss_fn, optax.adamw(lr), batches,
                                  cfg=jloop.LoopConfig(max_steps=3, out_dir=str(tmp_path / "jax")))
    res = run_training(tp, train_full.align_loss(cfg), topt.adamw(tp, lr), batches,
                       cfg=LoopConfig(max_steps=3, out_dir=str(tmp_path / "port")))
    assert res["steps"] == jres["steps"] == 3
    np.testing.assert_allclose(_events(tmp_path / "port" / "events.csv"),
                               _events(tmp_path / "jax" / "events.csv"), rtol=1e-5)
    jparams = dict(topt.leaves(_np(jres["params"])))
    for path, t in topt.leaves(res["params"]):
        np.testing.assert_allclose(t.numpy(), jparams[path], atol=3 * lr, rtol=1e-5, err_msg=path)


def test_decoder_lm_three_steps_track_jax(tiny_cfg, tiny_params, tmp_path):
    """The stage-3 LM tune: train_decoder_only's loss and clipped adamw over
    a warmup-cosine schedule, three steps against the JAX CLI's (its loss and
    optimizer, as cli/train_decoder_only.py builds them)."""
    lr, warmup = 1e-5, 1                   # step 1 at rate 0, as the JAX CLI's
    batches = []
    for seed in (23, 24, 25):
        b = _caption_batch(seed=seed)
        batches.append({"caption_ids": b["caption_ids"], "attention_mask": b["attention_mask"]})
    gcfg = tiny_cfg.gpt2

    def jloss_fn(p, batch):
        ids, mask = batch["caption_ids"], batch["attention_mask"]
        positions = jnp.maximum(jnp.cumsum(mask, axis=1) - 1, 0).astype(jnp.int32)
        logits = jg2.gpt2_logits_nocache(p, p["wte"][ids], positions, mask, gcfg)
        return jg2.lm_loss(logits, jnp.where(mask > 0, ids, -100))

    schedule = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, 1000)
    jp = jax.tree.map(jnp.array, tiny_params["decoder"])
    jres = jloop.run_training(jp, jloss_fn, optax.chain(optax.clip_by_global_norm(1.0),
                                                        optax.adamw(schedule)), batches,
                              cfg=jloop.LoopConfig(max_steps=3, out_dir=str(tmp_path / "jax")))
    cfg = _caption_cfg(tiny_cfg)
    tp = params_from_jax_numpy(_np(tiny_params), cfg, "cpu")["decoder"]
    res = run_training(tp, train_decoder_only.lm_loss_fn(cfg.gpt2),
                       topt.adamw(tp, topt.warmup_cosine_decay(0.0, lr, warmup, 1000),
                                  clip_norm=1.0),
                       batches, cfg=LoopConfig(max_steps=3, out_dir=str(tmp_path / "port")))
    losses = _events(tmp_path / "port" / "events.csv")
    np.testing.assert_allclose(losses, _events(tmp_path / "jax" / "events.csv"), rtol=1e-5)
    assert losses[0] != losses[1]
    jparams = dict(topt.leaves(_np(jres["params"])))
    for path, t in topt.leaves(res["params"]):
        np.testing.assert_allclose(t.numpy(), jparams[path], atol=3 * lr, rtol=1e-5, err_msg=path)


# ---- checkpoints and CLIs -------------------------------------------------

def test_port_checkpoint_loads_through_both_engines(tiny_cfg, tiny_params, tmp_path):
    cfg = _caption_cfg(tiny_cfg)
    tp = params_from_jax_numpy(_np(tiny_params), cfg, "cpu")
    tp["mapper"]["w"] = tp["mapper"]["w"] + 0.5          # "trained" weights
    model = save_checkpoint(str(tmp_path / "ck"), tp, step=3, epoch=1, best_val=2.5,
                            args={"lr": 3e-4}, cfg=cfg)
    assert model == tmp_path / "ck" / "model.pt"
    assert (tmp_path / "ck" / "train_meta.json").is_file()
    jloaded = j_load_params(JInferenceConfig(ckpt=str(model)), tiny_cfg, seed=1)
    np.testing.assert_array_equal(np.asarray(jloaded["mapper"]["w"]), tp["mapper"]["w"].numpy())
    np.testing.assert_array_equal(np.asarray(jloaded["encoder"]["blocks"]["qkv_w"]),
                                  tp["encoder"]["blocks"]["qkv_w"].numpy())
    np.testing.assert_array_equal(np.asarray(jloaded["decoder"]["wte"]),
                                  tp["decoder"]["wte"].numpy())
    loaded = load_params(InferenceConfig(ckpt=str(model)), cfg, seed=1, device="cpu")
    for path, t in topt.leaves(tp):
        assert torch.equal(dict(topt.leaves(loaded))[path], t), path


@pytest.mark.parametrize("model", ["simple_vc", "tiny_captioner", "simple_align"])
def test_toy_models_match_jax(model):
    cfg = jtoy.ToyConfig(vocab_size=64, hidden=16, max_len=5)
    tcfg = toy.ToyConfig(vocab_size=64, hidden=16, max_len=5)
    batch = _caption_batch(length=5, vocab=64, seed=20)
    video, ids, mask = batch["video"], batch["caption_ids"], batch["attention_mask"]
    key = jax.random.PRNGKey(21)
    if model == "simple_vc":
        jp = jtoy.init_simple_vc(key, cfg)
        want = jtoy.simple_vc_logits(jp, jnp.asarray(video), cfg)
        got = toy.simple_vc_logits(params_from_jax_numpy(_np(jp), None, "cpu"),
                                   torch.from_numpy(video), tcfg)
    elif model == "tiny_captioner":
        jp = jtoy.init_tiny_captioner(key, cfg)
        want = jtoy.tiny_captioner_logits(jp, jnp.asarray(video), jnp.asarray(ids), cfg)
        got = toy.tiny_captioner_logits(params_from_jax_numpy(_np(jp), None, "cpu"),
                                        torch.from_numpy(video), torch.from_numpy(ids), tcfg)
    else:
        jp = jtoy.init_simple_align(key, cfg, d=32)
        want = jtoy.simple_align_loss(jp, jnp.asarray(video), jnp.asarray(ids), jnp.asarray(mask))
        got = toy.simple_align_loss(params_from_jax_numpy(_np(jp), None, "cpu"),
                                    torch.from_numpy(video), torch.from_numpy(ids),
                                    torch.from_numpy(mask))
        init = toy.init_simple_align(torch.Generator().manual_seed(0), tcfg, "cpu", d=32)
        assert jax.tree.structure(jax.tree.map(lambda x: 0, _np(jp))) == \
            jax.tree.structure(jax.tree.map(lambda x: 0, init))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def _annotations(tmp_path, seed):
    from PIL import Image

    rng = np.random.RandomState(seed)
    records = []
    for v in range(3):
        d = tmp_path / f"video{v}"
        d.mkdir()
        for i in range(3):
            Image.fromarray(rng.randint(0, 255, (40, 48, 3), np.uint8)).save(d / f"frame_{i:05d}.jpg")
        records.append({"video_id": f"v{v}", "frames_dir": str(d),
                        "captions": ["a man is riding a horse", "two dogs play"]})
    ann = tmp_path / "ann.json"
    import json

    ann.write_text(json.dumps(records))
    return ann


def test_train_full_simple_cli_runs_on_the_cpu(tmp_path):
    ann = _annotations(tmp_path, 19)
    assert train_full.main(["--ann_path", str(ann), "--val_ann_path", str(ann), "--model", "simple",
                            "--num_frame", "2", "--image_size", "32", "--max_len", "8",
                            "--max_steps", "3", "--out_dir", str(tmp_path / "run"),
                            "--ckpt_path", str(tmp_path / "ck"), "--device", "cpu"]) == 0
    losses = _events(tmp_path / "run" / "events.csv")
    assert len(losses) == 3 and all(np.isfinite(losses))
    payload = torch.load(tmp_path / "ck" / "model.pt", weights_only=True)
    assert {"params", "opt_state", "step", "best_val"} <= set(payload)


def test_train_dry_run_cli_runs_on_the_cpu(tmp_path):
    ann = _annotations(tmp_path, 22)
    assert train_dry.main(["--ann_path", str(ann), "--num_frame", "2", "--image_size", "32",
                           "--max_len", "8", "--max_steps", "2", "--epochs", "2",
                           "--out_dir", str(tmp_path / "dry"), "--device", "cpu"]) == 0
    losses = _events(tmp_path / "dry" / "events.csv")
    assert len(losses) == 2 and all(np.isfinite(losses)) and losses[1] != losses[0]


def test_train_decoder_only_cli_runs_on_the_cpu(tmp_path, monkeypatch):
    ann = _annotations(tmp_path, 26)
    batches = train_decoder_only.text_batches(str(ann), get_tokenizer(), 2, 8)
    assert len(batches) == 3 and batches[0]["caption_ids"].shape == (2, 8)
    tiny = g2.GPT2Config(n_embd=32, n_layer=2, n_head=2, max_position_embeddings=16)
    monkeypatch.setattr(g2, "GPT2Config", lambda: tiny)
    assert train_decoder_only.main(["--ann_path", str(ann), "--val_ann_path", str(ann),
                                    "--batch_size", "2", "--max_len", "8", "--epochs", "2",
                                    "--max_steps", "5", "--warmup_steps", "2",
                                    "--out_dir", str(tmp_path / "lm"),
                                    "--ckpt_path", str(tmp_path / "lmck"), "--device", "cpu"]) == 0
    losses = _events(tmp_path / "lm" / "events.csv")
    assert len(losses) == 5 and all(np.isfinite(losses))    # the second epoch ran
    payload = torch.load(tmp_path / "lmck" / "model.pt", weights_only=True)
    assert payload["params"]["wte"].shape == (tiny.vocab_size, 32)


# ---- the packed 4:2:0 training wire ----------------------------------------

def _packed_batch(seed, b=2, t=2, length=6, vocab=128, size=32):
    """A caption batch whose video is packed 4:2:0 planes [B,T,plane_len],
    with a frame of zeros and one of 255s (the conversion's clip)."""
    from video_caption_tpu_torch.preprocessing.yuv420 import packed_plane_len

    rng = np.random.RandomState(seed)
    planes = rng.randint(0, 256, (b, t, packed_plane_len(size)), dtype=np.uint8)
    planes[0, 0], planes[-1, -1] = 0, 255
    batch = _caption_batch(b, length, seed, vocab)
    return {**batch, "video": planes}


def test_mapper_trainer_three_steps_on_the_packed_wire(tiny_cfg, tiny_params, tmp_path):
    """Three mapper steps on packed planes: the losses equal (exactly) those
    of the same steps on their RGB pixels, and are within 1e-5 of the JAX
    trainer's on the same planes."""
    from video_caption_tpu_torch.preprocessing.yuv420 import yuv420_packed_to_rgb_chw_np

    batches = [_packed_batch(seed) for seed in (31, 32, 33)]
    rgb = [{**b, "video": yuv420_packed_to_rgb_chw_np(b["video"].reshape(4, -1), 32).reshape(
        2, 2, 3, 32, 32)} for b in batches]
    cfg = _caption_cfg(tiny_cfg)
    losses = {}
    for wire, data in (("packed", batches), ("rgb", rgb)):
        tr = MapperTrainer(cfg, params_from_jax_numpy(_np(tiny_params), cfg, "cpu"),
                           TrainArgs(out_dir=str(tmp_path / wire), max_steps=3))
        losses[wire] = [tr.run_step(b) for b in data]
    assert losses["packed"] == losses["rgb"]
    jtr = jmt.MapperTrainer(tiny_cfg, tiny_params,
                            jmt.TrainArgs(out_dir=str(tmp_path / "jax"), max_steps=3),
                            mesh=make_mesh(JMeshConfig(data=1, model=1), jax.devices()[:1]))
    np.testing.assert_allclose(losses["packed"], [jtr.run_step(b) for b in batches], rtol=1e-5)


def _wire_annotations(tmp_path, subsamplings):
    """One video per entry of 3 frames of 32x32 JPEG; None writes 4:2:0,
    0 writes 4:4:4."""
    import json

    from PIL import Image

    rng = np.random.RandomState(6)
    records = []
    for v, sub in enumerate(subsamplings):
        d = tmp_path / f"wire{v}"
        d.mkdir()
        for i in range(3):
            kw = {} if sub is None else {"subsampling": sub}
            Image.fromarray(rng.randint(0, 255, (32, 32, 3), np.uint8)).save(
                d / f"frame_{i:05d}.jpg", quality=90, **kw)
        records.append({"video_id": f"v{v}", "frames_dir": str(d), "captions": ["a cat sits"]})
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps(records))
    return ann


@pytest.mark.parametrize("subsamplings,packed", [((None, None), True), ((None, 0), False)])
def test_data_loader_ships_the_packed_wire(tmp_path, subsamplings, packed):
    """``yuv420_wire``: 4:2:0 videos ship as planes [B,T,plane_len]; a batch
    that mixes them with a 4:4:4 video ships all as RGB, converted on the
    host bit-exactly. The same batches as the JAX package's loader."""
    from video_caption_tpu.data import data_loader as jdata
    from video_caption_tpu.decode.tokenizer import get_tokenizer as jget_tokenizer
    from video_caption_tpu_torch.data import data_loader
    from video_caption_tpu_torch.native import loader
    from video_caption_tpu_torch.preprocessing.yuv420 import packed_plane_len

    if not loader.native_available():
        pytest.skip(f"the port's native loader does not build here: {loader.last_error}")
    ann = _wire_annotations(tmp_path, subsamplings)
    kw = dict(batch_size=2, max_len=8, num_frame=4, image_size=32, yuv420_wire=True,
              shuffle=False)
    (got,) = list(data_loader.build_dataloader(str(ann), get_tokenizer(), **kw))
    (want,) = list(jdata.build_dataloader(str(ann), jget_tokenizer(), **kw))
    shape = (2, 4, packed_plane_len(32)) if packed else (2, 4, 3, 32, 32)
    assert got["video"].shape == shape and got["video"].dtype == np.uint8
    for key in ("video", "caption_ids", "attention_mask"):
        np.testing.assert_array_equal(got[key], want[key])
    if not packed:
        rgb = data_loader.build_dataloader(str(ann), get_tokenizer(), **{
            **kw, "yuv420_wire": False, "uint8_pixels": True})
        np.testing.assert_array_equal(got["video"], next(iter(rgb))["video"])
