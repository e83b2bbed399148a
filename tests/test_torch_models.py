"""The port's models (video_caption_tpu_torch/models) against the JAX package
on the same weights, in f32 on the CPU: the visual branch up to the prefix,
the GPT-2 prefill and single-token step, and one beam step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_caption_tpu.models import caption_model as jcm
from video_caption_tpu.models import gpt2 as jg2
from video_caption_tpu.models import vit as jvt
from video_caption_tpu_torch.models import caption_model as cm
from video_caption_tpu_torch.models import gpt2 as g2
from video_caption_tpu_torch.models import vit as vt
from video_caption_tpu_torch.models.convert import params_from_jax_numpy

ENCODER_ATOL = 2e-4     # the JAX package's encoder differential bound (PARITY.md §1)
DECODER_ATOL = 1e-4


def port_cfg(jcfg, dtype=torch.float32):
    v, g = jcfg.vit, jcfg.gpt2
    return cm.CaptionModelConfig(
        vit=vt.ViTConfig(image_size=v.image_size, patch_size=v.patch_size,
                         embed_dim=v.embed_dim, depth=v.depth, num_heads=v.num_heads,
                         out_dim=v.out_dim, dtype=dtype),
        gpt2=g2.GPT2Config(vocab_size=g.vocab_size,
                           max_position_embeddings=g.max_position_embeddings,
                           n_embd=g.n_embd, n_layer=g.n_layer, n_head=g.n_head, dtype=dtype),
        prefix_len=jcfg.prefix_len, video_dim=jcfg.video_dim, proj_hidden=jcfg.proj_hidden)


@pytest.fixture(scope="module")
def both(tiny_cfg, tiny_params):
    cfg = port_cfg(tiny_cfg)
    return tiny_params, params_from_jax_numpy(jax.tree.map(np.asarray, tiny_params), cfg, "cpu"), cfg


@pytest.fixture(scope="module")
def video_u8():
    return np.random.RandomState(0).randint(0, 256, (2, 3, 3, 32, 32)).astype(np.uint8)


def test_video_to_prefix_matches_jax(tiny_cfg, both, video_u8):
    jp, tp, cfg = both
    want = np.asarray(jcm.video_to_prefix(jp, jnp.asarray(video_u8), tiny_cfg))
    got = cm.video_to_prefix(tp, torch.from_numpy(video_u8), cfg).numpy()
    assert got.shape == want.shape == (2, 4, 64)
    np.testing.assert_allclose(got, want, atol=ENCODER_ATOL)


def test_frames_path_matches_jax(tiny_cfg, both, video_u8):
    jp, tp, cfg = both
    frames = video_u8.reshape(6, 3, 32, 32)
    jfeats = jcm.encode_frames(jp, jnp.asarray(frames), tiny_cfg)
    want = np.asarray(jcm.frames_to_prefix(jp, jfeats.reshape(2, 3, -1), tiny_cfg))
    feats = cm.encode_frames(tp, torch.from_numpy(frames), cfg)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), atol=ENCODER_ATOL)
    got = cm.frames_to_prefix(tp, feats.reshape(2, 3, -1), cfg)
    np.testing.assert_allclose(got.numpy(), want, atol=ENCODER_ATOL)
    # the per-frame split computes the whole-video prefix
    whole = cm.video_to_prefix(tp, torch.from_numpy(video_u8), cfg)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=1e-6)


def test_adapters_match_jax(tiny_cfg, video_u8):
    """The Linear projection (encoder out_dim != video_dim) and the MLP
    adapter (proj_hidden > 0) of encode_video, as a reference checkpoint with
    proj.0/proj.2 keys loads them."""
    import dataclasses

    jcfg = dataclasses.replace(tiny_cfg, video_dim=8, proj_hidden=12)
    jp = jcm.init_caption_model(jax.random.PRNGKey(1), jcfg)
    assert "proj" in jp and "proj_mlp" in jp
    cfg = port_cfg(jcfg)
    tp = params_from_jax_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    want = np.asarray(jcm.encode_video(jp, jnp.asarray(video_u8), jcfg))
    got = cm.encode_video(tp, torch.from_numpy(video_u8), cfg).numpy()
    assert got.shape == want.shape == (2, 8)
    np.testing.assert_allclose(got, want, atol=ENCODER_ATOL)
    init = cm.init_caption_model(0, cfg, "cpu")
    assert init["proj"]["w"].shape == (16, 8) and init["proj_mlp"]["fc1"]["w"].shape == (8, 12)


def test_gap_pool_matches_jax(tiny_cfg, both, video_u8):
    """pool="gap": the full token stream reaches the fused pool (its plain
    version on the CPU; the JAX package's XLA path at H = 64)."""
    import dataclasses

    jp, tp, cfg = both
    gap = dataclasses.replace(cfg.vit, pool="gap")
    jgap = dataclasses.replace(tiny_cfg.vit, pool="gap")
    want = np.asarray(jvt.vit_encode(jp["encoder"], jnp.asarray(video_u8), jgap))
    got = vt.vit_encode(tp["encoder"], torch.from_numpy(video_u8), gap).numpy()
    assert got.shape == want.shape == (2, 16)
    np.testing.assert_allclose(got, want, atol=ENCODER_ATOL)
    cls = vt.vit_encode(tp["encoder"], torch.from_numpy(video_u8), cfg.vit).numpy()
    assert not np.allclose(got, cls)


def _prefill_inputs(h, seed=1):
    rng = np.random.RandomState(seed)
    embeds = (rng.randn(2, 6, h) * 0.1).astype(np.float32)
    mask = np.array([[0, 0, 1, 1, 1, 1], [1, 1, 1, 1, 1, 1]], np.int32)
    return embeds, mask


def test_gpt2_prefill_and_step_match_jax(tiny_cfg, both):
    jp, tp, cfg = both
    jg, g = tiny_cfg.gpt2, cfg.gpt2
    embeds, mask = _prefill_inputs(g.n_embd)
    max_len = 8
    valid = np.zeros((2, max_len), np.int32)
    valid[:, :6] = mask
    pos = np.maximum(np.cumsum(mask, 1) - 1, 0).astype(np.int32)

    jcache = jg2.init_cache(jg, 2, max_len)
    jlogits, jcache = jg2.gpt2_forward(jp["decoder"], jnp.asarray(embeds), jnp.asarray(pos),
                                       jnp.asarray(valid), jcache, jnp.int32(0), jg)
    cache = g2.init_cache(g, 2, max_len, "cpu")
    logits, cache = g2.gpt2_forward(tp["decoder"], torch.from_numpy(embeds),
                                    torch.from_numpy(pos).long(), torch.from_numpy(valid),
                                    cache, 0, g)
    # pad positions attend to nothing valid before them; compare real ones
    np.testing.assert_allclose(logits.numpy()[mask > 0], np.asarray(jlogits)[mask > 0],
                               atol=DECODER_ATOL)
    np.testing.assert_allclose(cache["kv"].numpy()[:, :, :6], np.asarray(jcache["kv"])[:, :, :6],
                               atol=DECODER_ATOL)

    # one K=1 step at offset 6, with the stats the decode loop consumes
    tok = np.array([[5], [9]])
    step_emb = np.asarray(jp["decoder"]["wte"])[tok[:, 0]][:, None, :]
    step_pos = pos[:, -1:] + 1
    valid[:, 6] = 1
    jwte_t = jg2.lm_head_t(jp["decoder"], jg)
    (jl, jw, _, _), _ = jg2.gpt2_forward(
        jp["decoder"], jnp.asarray(step_emb), jnp.asarray(step_pos), jnp.asarray(valid),
        jcache, jnp.int32(6), jg, wte_t=jwte_t, return_stats=True, row_stats=False)
    wte_t = g2.lm_head_t(tp["decoder"], g)
    (sl, sw, sm, sl_), _ = g2.gpt2_forward(
        tp["decoder"], torch.from_numpy(step_emb), torch.from_numpy(step_pos).long(),
        torch.from_numpy(valid), cache, 6, g, wte_t=wte_t, return_stats=True, row_stats=False)
    assert sm is None and sl_ is None
    v = g.vocab_size
    np.testing.assert_allclose(sl.numpy()[:, :v], np.asarray(jl)[:, :v], atol=DECODER_ATOL)
    np.testing.assert_allclose(sw.numpy(), np.asarray(jw)[:, :sw.shape[1]], atol=DECODER_ATOL)


def test_gpt2_beam_step_matches_jax(tiny_cfg, both):
    """One beam step over the split cache (K=3, B=2 -> R=6) with nontrivial
    ancestry: logits and row statistics."""
    jp, tp, cfg = both
    jg, g = tiny_cfg.gpt2, cfg.gpt2
    rng = np.random.RandomState(3)
    b, k, s0, n, h = 2, 3, 5, 4, g.n_embd
    r = b * k
    pk = (rng.randn(g.n_layer, b, s0, h) * 0.5).astype(np.float32)
    pv = (rng.randn(g.n_layer, b, s0, h) * 0.5).astype(np.float32)
    gkv = (rng.randn(g.n_layer, n, 2, r, h) * 0.5).astype(np.float32)
    valid = np.array([[0, 1, 1, 1, 1], [1, 1, 1, 1, 1]], np.int32)
    anc = (np.arange(r)[:, None] // k * k + rng.randint(0, k, (r, n))).astype(np.int32)
    t = 2
    anc[:, t] = np.arange(r)
    emb = (rng.randn(r, h) * 0.1).astype(np.float32)
    pos = np.array([6, 6, 6, 7, 7, 7], np.int32)

    jcfg_on = jg
    (jl, jw, jm, jll), jgen = jg2.gpt2_beam_step(
        jp["decoder"], jnp.asarray(emb), jnp.asarray(pos),
        {"k": jnp.asarray(pk), "v": jnp.asarray(pv)}, jnp.asarray(valid),
        {"kv": jnp.asarray(gkv)}, jnp.asarray(anc), jnp.int32(t), k, jcfg_on,
        wte_t=jg2.lm_head_t(jp["decoder"], jg), return_stats=True)
    (tl, tw, tm, tll), tgen = g2.gpt2_beam_step(
        tp["decoder"], torch.from_numpy(emb), torch.from_numpy(pos).long(),
        {"k": torch.from_numpy(pk), "v": torch.from_numpy(pv)}, torch.from_numpy(valid),
        {"kv": torch.from_numpy(gkv.copy())}, torch.from_numpy(anc), t, k, g,
        g2.lm_head_t(tp["decoder"], g))
    v = g.vocab_size
    np.testing.assert_allclose(tl.numpy()[:, :v], np.asarray(jl)[:, :v], atol=DECODER_ATOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw)[:, :tw.shape[1]], atol=DECODER_ATOL)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=DECODER_ATOL)
    np.testing.assert_allclose(tll.numpy(), np.asarray(jll), rtol=1e-4)
    np.testing.assert_allclose(tgen["kv"].numpy(), np.asarray(jgen["kv"]), atol=DECODER_ATOL)


def test_lm_head_pads_to_selection_window(both):
    _, tp, cfg = both
    wte_t = g2.lm_head_t(tp["decoder"], cfg.gpt2)
    assert wte_t.shape == (cfg.gpt2.n_embd, 128) and wte_t.is_contiguous()
    full = g2.GPT2Config()
    assert -(-full.vocab_size // 128) * 128 == 50304


def test_split_prefill_cache_is_contiguous(both):
    """The beam-attention kernel reads the prefill K/V as contiguous
    [B, S0, H] per layer; the repack after the prefill must copy."""
    from video_caption_tpu_torch.decode.generate import _prefill

    _, tp, cfg = both
    g = cfg.gpt2
    embeds, mask = _prefill_inputs(g.n_embd)
    _, cache, valid, row_len = _prefill(tp["decoder"], g, torch.from_numpy(embeds), 6,
                                        torch.from_numpy(mask), g2.lm_head_t(tp["decoder"], g),
                                        split=True, row_stats=True)
    assert cache["k"].shape == cache["v"].shape == (g.n_layer, 2, 6, g.n_embd)
    assert cache["k"].is_contiguous() and cache["v"].is_contiguous()
    assert valid.dtype == torch.int32 and row_len.tolist() == [4, 6]
